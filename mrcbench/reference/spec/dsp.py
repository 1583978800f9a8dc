"""Normative DSP: framing, transient detection, MDCT/IMDCT (NumPy).

The port's copy of the JAX package's `spec/dsp.py`, on the port's
NumPy-only `spec/xpsy_np.py` and `spec/xmath_np.py`.

Reference components R2-R5 (SURVEY.md §2a). This module DEFINES the codec's
signal path; the JAX path (`mrcaudiocodec_tpu.ops`) mirrors it operation for
operation in float32.

MDCT convention: X[k] = sum_n v[n] cos(pi/M (n + 1/2 + M/2)(k + 1/2)) with
N = 2M, computed as TDAC fold to M samples followed by an orthonormal
DCT-IV (`tables.dct_iv_matrix`). Inverse = transpose. Perfect reconstruction
with Princen-Bradley windows is verified in tests/test_mdct.py.
"""
from __future__ import annotations

import numpy as np

from .. import config as C
from .. import tables as T

F32 = np.float32

# ---------------------------------------------------------------------------
# Framing (R2)
# ---------------------------------------------------------------------------


def frame_signal(x: np.ndarray) -> np.ndarray:
    """[n] float32 -> [F, LONG_SIZE] 50%-overlapped frames (zero primed)."""
    x = np.asarray(x, dtype=F32)
    n = len(x)
    nf = max(1, -(-n // C.HOP) + 1)
    padded = np.zeros(C.HOP + nf * C.HOP + C.HOP, dtype=F32)
    padded[C.HOP:C.HOP + n] = x
    idx = np.arange(C.LONG_SIZE)[None, :] + C.HOP * np.arange(nf)[:, None]
    return padded[idx]


def overlap_add(frames_out: np.ndarray, n_samples: int) -> np.ndarray:
    """[F, LONG_SIZE] windowed synthesis frames -> [n_samples] float32.

    NORMATIVE rev 5: with 50% overlap exactly TWO frames touch every
    output sample, so each hop of output is ONE correctly-rounded f32
    add: y[f*HOP + i] = frames_out[f][i] + frames_out[f-1][HOP + i].
    (Before rev 5 the spec accumulated in float64 and rounded once at
    the end, which can double-round relative to the single f32 add the
    engine's chunked decoder performs; pinning the add closes the last
    spec-vs-engine tolerance — decoded PCM is bitwise identical across
    engines, tests/test_conformance.py::test_tpu_decode_matches_spec_decode.)
    """
    frames_out = np.asarray(frames_out, dtype=F32)
    nf = frames_out.shape[0]
    first = np.vstack([frames_out[:, :C.HOP], np.zeros((1, C.HOP), F32)])
    prev = np.vstack([np.zeros((1, C.HOP), F32), frames_out[:, C.HOP:]])
    y = (first + prev).reshape(-1)        # [(nf+1)*HOP]; single adds
    return y[C.HOP:C.HOP + n_samples].copy()


# ---------------------------------------------------------------------------
# Transient detection + block types (R5)
# ---------------------------------------------------------------------------

# Normative constants + pinned arithmetic live in xpsy (rev 4): the same
# fixed-IEEE-sequence code runs here (NumPy), on the TPU (jnp) and in the
# native CPU kernel, so attack flags are bit-identical on every backend.
from . import xpsy_np as _xpsy

ATTACK_RATIO = _xpsy.ATTACK_RATIO
ATTACK_ABS = _xpsy.ATTACK_ABS
ATTACK_EPS = _xpsy.ATTACK_EPS
N_SUB = _xpsy.N_SUB


def detect_transients(frames: np.ndarray) -> np.ndarray:
    """[F, 2048] -> [F] bool. High-passed sub-block energy attack test.

    Normative rev 4: the shared pinned sequence (xpsy.transient_detect) —
    segmented scan-tree sub-block energies, ladder prefix sums, EPS
    folded into the numerator so no multiply feeds an add.
    """
    return _xpsy.transient_detect(np.asarray(frames, dtype=F32), np)


def block_types(transient: np.ndarray, window_switching: bool) -> np.ndarray:
    """[F] bool -> [F] int32 block types (vectorized, no FSM scan).

    SHORT where transient; otherwise the type is determined by whether each
    neighbour is SHORT: LONG / START (right neighbour short) / STOP (left
    short) / STARTSTOP (both). Adjacent window halves are complementary by
    construction, so every sequence this produces is legal.
    """
    tr = np.asarray(transient, dtype=bool)
    if not window_switching:
        return np.zeros(len(tr), dtype=np.int32)
    ls = np.concatenate([[False], tr[:-1]])   # left neighbour short
    rs = np.concatenate([tr[1:], [False]])    # right neighbour short
    bt = np.full(len(tr), C.LONG, dtype=np.int32)
    bt[~tr & ~ls & rs] = C.START
    bt[~tr & ls & ~rs] = C.STOP
    bt[~tr & ls & rs] = C.STARTSTOP
    bt[tr] = C.SHORT
    return bt


# ---------------------------------------------------------------------------
# MDCT / IMDCT (R3, R4)
# ---------------------------------------------------------------------------


def _fold(v: np.ndarray) -> np.ndarray:
    """TDAC fold [..., 2M] -> [..., M]."""
    m = v.shape[-1] // 2
    h = m // 2
    u = np.empty(v.shape[:-1] + (m,), dtype=v.dtype)
    # u[0:h]  = -v[3h-1 .. 2h] - v[3h .. 4h-1]   (both reversed/forward resp.)
    u[..., :h] = -v[..., 3 * h - 1:2 * h - 1:-1] - v[..., 3 * h:]
    # u[h:m] = v[0:h] - v[2h-1 .. h]
    u[..., h:] = v[..., :h] - v[..., 2 * h - 1:h - 1:-1]
    return u


def _unfold(u: np.ndarray) -> np.ndarray:
    """Transpose of _fold: [..., M] -> [..., 2M]."""
    m = u.shape[-1]
    h = m // 2
    v = np.empty(u.shape[:-1] + (2 * m,), dtype=u.dtype)
    v[..., :h] = u[..., h:]
    v[..., h:m] = -u[..., m - 1:h - 1:-1]
    v[..., m:3 * h] = -u[..., h - 1::-1]
    v[..., 3 * h:] = -u[..., :h]
    return v


def mdct(v: np.ndarray) -> np.ndarray:
    """Windowed block [..., 2M] -> MDCT coefficients [..., M] (float32).

    NORMATIVE arithmetic: TDAC fold (f32 adds) then the fixed-sequence
    fast DCT-IV of xmath.dct_iv — bit-identical across NumPy and every
    XLA backend by construction (see mrcaudiocodec_tpu/xmath.py; the
    former GEMM formulation leaked backend-private reduction orders into
    the quantizer's floor)."""
    from . import xmath_np as xmath
    return xmath.dct_iv(_fold(np.asarray(v, dtype=F32)), np)


def imdct(x: np.ndarray) -> np.ndarray:
    """MDCT coefficients [..., M] -> time block [..., 2M] (pre-window).

    DCT-IV is involutive (orthonormal, symmetric), so the inverse reuses
    the same normative xmath.dct_iv sequence followed by the unfold."""
    from . import xmath_np as xmath
    return _unfold(xmath.dct_iv(np.asarray(x, dtype=F32), np))


def analyze_frame(frame: np.ndarray, block_type: int, window: str = "sine") -> np.ndarray:
    """One frame [2048] -> [1024] coefficients (long) or 8x128 flattened.

    SHORT frames return group-major layout: coeff[g*128 + k] for sub-block g.
    """
    if block_type != C.SHORT:
        w = T.long_windows(window)[block_type].astype(F32)
        return mdct(frame.astype(F32) * w)
    ws = T.short_window(window).astype(F32)
    off = C.SHORT_OFFSET
    subs = np.stack([
        frame[off + g * C.SHORT_COEFFS: off + g * C.SHORT_COEFFS + C.SHORT_SIZE]
        for g in range(C.N_SHORT)
    ]).astype(F32)
    return mdct(subs * ws[None, :]).reshape(-1)


def analyze_frames(frames: np.ndarray, bt: np.ndarray,
                   window: str = "sine") -> np.ndarray:
    """Batched analyze_frame: [F, 2048] + [F] block types -> [F, 1024].

    Identical per-frame arithmetic (the normative mdct sequence operates
    on the last axis only; the window multiply is elementwise), frames
    grouped long-family vs SHORT. encode() uses this; analyze_frame stays
    the one-frame reference definition (tests assert equality)."""
    frames = np.asarray(frames, dtype=F32)
    bt = np.asarray(bt)
    out = np.zeros((len(frames), C.LONG_COEFFS), dtype=F32)
    ns = np.where(bt != C.SHORT)[0]
    if len(ns):
        w = T.long_windows(window).astype(F32)           # [5, 2048]
        out[ns] = mdct(frames[ns] * w[bt[ns]])
    sh = np.where(bt == C.SHORT)[0]
    if len(sh):
        ws = T.short_window(window).astype(F32)
        off = C.SHORT_OFFSET
        idx = (off + np.arange(C.N_SHORT)[:, None] * C.SHORT_COEFFS
               + np.arange(C.SHORT_SIZE)[None, :])       # [8, 256]
        subs = frames[sh][:, idx]                        # [K, 8, 256]
        out[sh] = mdct(subs * ws[None, None, :]).reshape(len(sh), -1)
    return out


def synthesize_frame(coeffs: np.ndarray, block_type: int, window: str = "sine") -> np.ndarray:
    """[1024] coefficients -> windowed synthesis frame [2048] for OLA."""
    if block_type != C.SHORT:
        w = T.long_windows(window)[block_type].astype(F32)
        return imdct(coeffs) * w
    ws = T.short_window(window).astype(F32)
    subs = imdct(coeffs.reshape(C.N_SHORT, C.SHORT_COEFFS)) * ws[None, :]
    out = np.zeros(C.LONG_SIZE, dtype=F32)
    off = C.SHORT_OFFSET
    for g in range(C.N_SHORT):
        out[off + g * C.SHORT_COEFFS: off + g * C.SHORT_COEFFS + C.SHORT_SIZE] += subs[g]
    return out
