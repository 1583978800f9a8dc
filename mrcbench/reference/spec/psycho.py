"""Normative psychoacoustic model (reference component R7, SURVEY.md §2).

The port's copy of the JAX package's `spec/psycho.py`, on the port's
NumPy-only `spec/xpsy_np.py`.

FFT -> partition energies -> Schroeder spreading -> tonality (spectral
flatness) -> masking threshold (+ absolute threshold in quiet) -> per-band
allowed-noise and perceptual entropy.

Outputs live in the unified NB-band layout (`tables.unified_layout`), so
long and short frames flow through identical downstream shapes.

Normative arithmetic rev 4 (docs/FORMAT.md): the entire chain is a fixed
sequence of single-rounded IEEE-754 f32 ops defined in
mrcaudiocodec_tpu/xpsy.py and shared VERBATIM with the TPU engine
(mrcaudiocodec_tpu/ops/psycho.py) — fixed-sequence real FFT, segmented
scan-tree reductions, unrolled spreading, and pinned xlog2/xexp2
transcendentals — so spec and engine psycho outputs are bit-identical on
every backend by construction (previously the FFT ran in NumPy float64,
the reductions were backend-tiled matmuls, and log/exp were libm/XLA
intrinsics: the last source of spec-vs-engine stream divergence,
scripts/tpu_g3_probe.py).
"""
from __future__ import annotations

import functools

import numpy as np

from .. import config as C
from .. import tables as T
from . import xpsy_np as xpsy

F32 = np.float32
TINY = xpsy.TINY
TMN_DB = 18.0      # tone-masking-noise offset
NMT_DB = 6.0       # noise-masking-tone offset
SIMPLE_OFFSET_DB = 12.0   # fixed offset when full_psycho=False
SMR_FLOOR = F32(1e-3)
SMR_CEIL = F32(1e12)
SFM_FLOOR_REL = xpsy.SFM_FLOOR_REL  # 120 dB power-spectrum floor (see xpsy)


_hann = xpsy.hann


def _psy_const(fs: int, n_bins: int, long_block: bool):
    """Back-compat alias for the shared psycho tables (xpsy.psy_tables)."""
    return xpsy.psy_tables(fs, long_block)


def _block_thresholds(p: np.ndarray, cst, full_psycho: bool):
    """Power spectrum [..., bins] -> (band_threshold[..., nb],
    band_energy[..., nb]) through the shared normative chain."""
    return xpsy.block_thresholds(p, cst, full_psycho, np)


def mdct_band_energy(coeffs: np.ndarray, edges: np.ndarray,
                     xp=np, select=None):
    """Per-band MDCT energy over (possibly zero-width) unified edges via
    the shared segmented scan tree. Zero-width bands -> exact 0."""
    x2 = xp.asarray(coeffs) * xp.asarray(coeffs)
    key = tuple(int(v) for v in edges)
    # clamp end indices of zero-width bands into range; result masked out
    e = xpsy.seg_sums_clamped(x2, key, xp, select)
    width_pos = (np.asarray(edges[1:]) > np.asarray(edges[:-1]))
    return xp.where(xp.asarray(width_pos), e, F32(0.0))


def analyze_frame(frame: np.ndarray, coeffs: np.ndarray, block_type: int,
                  fs: int, full_psycho: bool = True):
    """One frame -> (allowed[NB] float32, pe float32, e_mdct[NB]).

    allowed[b] = permitted quantization-noise energy in the MDCT domain:
    E_mdct[b] / SMR[b] with SMR measured in the FFT domain (the ratio
    transfers between domains and absorbs normalization differences).
    pe = perceptual entropy (bits-like difficulty measure for the bit
    reservoir allocator, SURVEY.md §2b N9).
    """
    lay = T.unified_layout(fs)
    nb = lay["nb"]
    edges = lay["edges"][block_type]
    frame = np.asarray(frame, dtype=F32)

    if block_type != C.SHORT:
        cst = xpsy.psy_tables(fs, True)
        p = xpsy.rfft_power(frame * cst["hann"], np)
        band_t, band_e = xpsy.block_thresholds(p, cst, full_psycho, np)
        nb_real = cst["nb"]
        t_full = np.full(nb, F32(1e30))
        e_full = np.zeros(nb, dtype=F32)
        t_full[:nb_real] = band_t
        e_full[:nb_real] = band_e
        pe = xpsy.band_pe(band_e, band_t, cst["width"], np)
    else:
        cst = xpsy.psy_tables(fs, False)
        nbs = cst["nb"]
        off = C.SHORT_OFFSET
        subs = np.stack([frame[off + g * C.SHORT_COEFFS:
                               off + g * C.SHORT_COEFFS + C.SHORT_SIZE]
                         for g in range(C.N_SHORT)])          # [8, 256]
        p = xpsy.rfft_power(subs * cst["hann"], np)           # [8, 128]
        band_t, band_e = xpsy.block_thresholds(p, cst, full_psycho, np)
        t_full = np.full(nb, F32(1e30))
        e_full = np.zeros(nb, dtype=F32)
        t_full[:C.N_SHORT * nbs] = band_t.reshape(-1)
        e_full[:C.N_SHORT * nbs] = band_e.reshape(-1)
        pe = xpsy.groups_pe(band_e, band_t, cst["width"], np)

    # SMR in FFT units, then allowed noise in MDCT units per band —
    # divide-free log2-domain form shared with the engine (xpsy).
    e_mdct = mdct_band_energy(np.asarray(coeffs, F32), edges)
    allowed = xpsy.allowed_noise(e_mdct, e_full, t_full, np).astype(F32)
    return allowed, F32(pe), e_mdct


def analyze_frames(frames: np.ndarray, coeffs: np.ndarray, bt: np.ndarray,
                   fs: int, full_psycho: bool = True):
    """Batched analyze_frame: [F, 2048] frames + [F, 1024] coeffs + [F]
    block types -> (allowed[F, NB], pe[F], e_mdct[F, NB]).

    Per-frame arithmetic is identical — every xpsy op works on the last
    axis (or the trailing [8, nbs] group axes for shorts), so batching
    rows cannot change any value; tests assert equality vs the per-frame
    reference above."""
    lay = T.unified_layout(fs)
    nb = lay["nb"]
    frames = np.asarray(frames, dtype=F32)
    coeffs = np.asarray(coeffs, dtype=F32)
    bt = np.asarray(bt)
    nf = len(frames)
    allowed = np.zeros((nf, nb), dtype=F32)
    pe = np.zeros(nf, dtype=F32)
    e_mdct = np.zeros((nf, nb), dtype=F32)

    ns = np.where(bt != C.SHORT)[0]
    if len(ns):
        cst = xpsy.psy_tables(fs, True)
        p = xpsy.rfft_power(frames[ns] * cst["hann"], np)
        band_t, band_e = xpsy.block_thresholds(p, cst, full_psycho, np)
        nb_real = cst["nb"]
        t_full = np.full((len(ns), nb), F32(1e30))
        e_full = np.zeros((len(ns), nb), dtype=F32)
        t_full[:, :nb_real] = band_t
        e_full[:, :nb_real] = band_e
        pe[ns] = xpsy.band_pe(band_e, band_t, cst["width"], np)
        em = mdct_band_energy(coeffs[ns], lay["edges"][C.LONG])
        e_mdct[ns] = em
        allowed[ns] = xpsy.allowed_noise(em, e_full, t_full, np).astype(F32)

    sh = np.where(bt == C.SHORT)[0]
    if len(sh):
        cst = xpsy.psy_tables(fs, False)
        nbs = cst["nb"]
        off = C.SHORT_OFFSET
        idx = (off + np.arange(C.N_SHORT)[:, None] * C.SHORT_COEFFS
               + np.arange(C.SHORT_SIZE)[None, :])       # [8, 256]
        subs = frames[sh][:, idx]                        # [K, 8, 256]
        p = xpsy.rfft_power(subs * cst["hann"], np)      # [K, 8, 128]
        band_t, band_e = xpsy.block_thresholds(p, cst, full_psycho, np)
        t_full = np.full((len(sh), nb), F32(1e30))
        e_full = np.zeros((len(sh), nb), dtype=F32)
        t_full[:, :C.N_SHORT * nbs] = band_t.reshape(len(sh), -1)
        e_full[:, :C.N_SHORT * nbs] = band_e.reshape(len(sh), -1)
        pe[sh] = xpsy.groups_pe(band_e, band_t, cst["width"], np)
        em = mdct_band_energy(coeffs[sh], lay["edges"][C.SHORT])
        e_mdct[sh] = em
        allowed[sh] = xpsy.allowed_noise(em, e_full, t_full, np).astype(F32)
    return allowed, pe, e_mdct
