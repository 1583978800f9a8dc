"""Batched psychoacoustic model in PyTorch (mirror of spec/psycho.py).

The whole chain is the pinned f32 sequence of xpsy (normative rev 4), so
the outputs are bitwise equal to the spec's on every device. Long and
short analyses run for every frame and the result is selected by block
type. On the card `analyze` runs the kernels K6 (windowed FFT inputs),
K1 (the FFTs) and K8 (everything after them); `thresholds` is the chain
after the power spectra, K8's plain version's core.
"""
from __future__ import annotations

import functools

import torch

from .. import config as C
from .. import tables as T
from .. import xpsy
from .dsp import short_subblocks


@functools.lru_cache(maxsize=None)
def unified_band_edges(fs: int):
    """(long_edges, short_edges) of the unified layout as tuples."""
    lay = T.unified_layout(fs)
    return (tuple(int(v) for v in lay["edges"][C.LONG]),
            tuple(int(v) for v in lay["edges"][C.SHORT]))


@functools.lru_cache(maxsize=None)
def _width_pos(edges: tuple, device: str):
    e = torch.tensor(edges, dtype=torch.int64)
    return (e[1:] > e[:-1]).to(device)


def band_energy(coeffs, edges: tuple):
    """Per-band MDCT energy over (possibly zero-width) unified edges via
    the pinned segmented scan tree; zero-width bands -> exact 0."""
    e = xpsy.seg_sums(coeffs * coeffs, edges)
    return torch.where(_width_pos(edges, str(coeffs.device)), e, 0.0)


def _family(p, fs: int, long_block: bool, full_psycho: bool):
    """Power spectra [F, 1024] (long) or [F, 8, 128] (short) -> (band_t
    [F, nb], band_e [F, nb], pe [F]); short: 8 groups x nb group-major."""
    cst = xpsy.dev_psy_tables(fs, long_block, str(p.device))
    band_t, band_e = xpsy.block_thresholds(p, cst, full_psycho)
    if long_block:
        return band_t, band_e, xpsy.band_pe(band_e, band_t, cst["width"])
    pe = xpsy.groups_pe(band_e, band_t, cst["width"])
    nf = p.shape[0]
    return band_t.reshape(nf, -1), band_e.reshape(nf, -1), pe


def _pad(v, nb: int, value: float):
    return torch.cat([v, v.new_full((v.shape[0], nb - v.shape[1]), value)],
                     dim=-1)


def thresholds(p_long, p_short, coeffs, bt, fs: int,
               full_psycho: bool = True):
    """The chain after the power spectra: both families' thresholds and
    PE, selected by block type, the MDCT band energies and the allowed
    noise -> (allowed [F, NB], pe [F], e_mdct [F, NB])."""
    nb = T.unified_layout(fs)["nb"]
    t_l, e_l, pe_l = _family(p_long, fs, True, full_psycho)
    t_s, e_s, pe_s = _family(p_short, fs, False, full_psycho)
    is_short = bt == C.SHORT
    t_full = torch.where(is_short[:, None], _pad(t_s, nb, xpsy.BIG),
                         _pad(t_l, nb, xpsy.BIG))
    e_full = torch.where(is_short[:, None], _pad(e_s, nb, 0.0),
                         _pad(e_l, nb, 0.0))
    pe = torch.where(is_short, pe_s, pe_l)
    le, se = unified_band_edges(fs)
    co = coeffs.to(torch.float32)
    e_mdct = torch.where(is_short[:, None], band_energy(co, se),
                         band_energy(co, le))
    allowed = xpsy.allowed_noise(e_mdct, e_full, t_full)
    return allowed, pe, e_mdct


def analyze(frames, coeffs, bt, fs: int, full_psycho: bool = True):
    """Batched psycho -> (allowed [F, NB], pe [F], e_mdct [F, NB]). A CUDA
    tensor runs K6 (the windowed FFT inputs), K1 and K8; a CPU tensor the
    eager chain."""
    if frames.is_cuda:
        from .kernels import analysis_pre, fft_stages, psycho
        btc = bt.to(torch.int32).contiguous()
        pre = analysis_pre.analysis_pre(
            frames.to(torch.float32).contiguous(), btc, None, "psycho")
        spec = fft_stages.fft(*pre[:2]) + fft_stages.fft(*pre[2:])
        return psycho.psycho(*spec, coeffs.to(torch.float32).contiguous(),
                             btc, fs, full_psycho)
    fr = frames.to(torch.float32)
    hl = xpsy.dev_psy_tables(fs, True, str(fr.device))["hann"]
    hs = xpsy.dev_psy_tables(fs, False, str(fr.device))["hann"]
    return thresholds(xpsy.rfft_power(fr * hl),
                      xpsy.rfft_power(short_subblocks(fr) * hs), coeffs, bt,
                      fs, full_psycho)
