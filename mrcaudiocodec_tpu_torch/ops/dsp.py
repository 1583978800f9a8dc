"""Batched transient detection, MDCT/IMDCT in PyTorch (mirror of spec/dsp.py).

Every frame of a batch flows through both the long and the short path
and the result is selected by block type. The MDCT/IMDCT chains are the
pinned xmath sequence, with the FFT stages in the CUDA kernel K1
(ops/kernels/fft_stages.py) on the card and its plain version on the CPU;
on the card the MDCT's glue runs in K6 and K7 (ops/kernels/analysis_pre.py,
mdct_post.py), and the decoder's synthesis in K9 and K10
(ops/kernels/synth_pre.py, synth_post.py; `synth_windowed` is part of
K10's plain version).
Every float reduction is a pinned tree, so no value depends on the batch
shape (the JAX package needed ops/blocking.py for that; the port does not).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config as C
from .. import tables as T
from .. import xmath, xpsy


@functools.lru_cache(maxsize=None)
def _windows(window: str, device: str):
    """(long_windows [5, 2048], short_window [256]) f32 on `device`."""
    lw = np.asarray(T.long_windows(window), dtype=np.float32)
    sw = np.asarray(T.short_window(window), dtype=np.float32)
    return torch.from_numpy(lw).to(device), torch.from_numpy(sw).to(device)


def detect_transients(frames):
    """[F, 2048] -> [F] bool (xpsy.transient_detect)."""
    return xpsy.transient_detect(frames.to(torch.float32))


def block_types(tr_ext, window_switching: bool):
    """[..., F+2] transients with true neighbours at both ends -> [..., F]
    int32 block types: SHORT where transient, else LONG / START (right
    neighbour short) / STOP (left short) / STARTSTOP (both)."""
    tr = tr_ext[..., 1:-1]
    if not window_switching:
        return torch.zeros(tr.shape, dtype=torch.int32, device=tr.device)
    ls = tr_ext[..., :-2]
    rs = tr_ext[..., 2:]
    bt = torch.where(
        tr, C.SHORT,
        torch.where(ls & rs, C.STARTSTOP,
                    torch.where(ls, C.STOP, torch.where(rs, C.START, C.LONG))))
    return bt.to(torch.int32)


def short_subblocks(frames):
    """[F, 2048] -> [F, 8, 256] the EIGHT_SHORT sub-block views."""
    off = C.SHORT_OFFSET
    return torch.stack([frames[:, off + g * C.SHORT_COEFFS:
                               off + g * C.SHORT_COEFFS + C.SHORT_SIZE]
                        for g in range(C.N_SHORT)], dim=1)


def analyze(frames, bt, window: str = "sine"):
    """Batched MDCT: [F, 2048] + [F] block types -> [F, 1024]; SHORT frames
    in group-major layout coeff[g*128 + k]. A CUDA tensor runs the kernels
    K6 (window, fold, pre-twiddle), K1 and K7 (post-twiddle, select); a
    CPU tensor the eager chain."""
    if frames.is_cuda:
        from .kernels import analysis_pre, fft_stages, mdct_post
        btc = bt.to(torch.int32).contiguous()
        pre = analysis_pre.analysis_pre(
            frames.to(torch.float32).contiguous(), btc, window, "mdct")
        return mdct_post.mdct_post(*fft_stages.fft(*pre[:2]),
                                   *fft_stages.fft(*pre[2:]), btc)
    lw, sw = _windows(window, str(frames.device))
    fr = frames.to(torch.float32)
    xl = xmath.mdct_windowed_fast(fr, lw[bt.long()])
    xs = xmath.mdct_windowed_fast(short_subblocks(fr), sw)
    return torch.where((bt == C.SHORT)[:, None], xs.reshape(fr.shape[0], -1),
                       xl)


def synthesize(coeffs, bt, window: str = "sine"):
    """Batched IMDCT + window: [F, 1024] -> [F, 2048] frames for OLA: the
    DCT-IV's pre-twiddle, K1's FFT (its plain version on the CPU), then
    synth_windowed."""
    from .kernels import fft_stages
    x = coeffs.to(torch.float32)
    us = x.reshape(x.shape[0], C.N_SHORT, C.SHORT_COEFFS)
    return synth_windowed(*fft_stages.fft(*xmath.dct_iv_pre(x)),
                          *fft_stages.fft(*xmath.dct_iv_pre(us)), bt, window)


def synth_windowed(l_re, l_im, s_re, s_im, bt, window: str = "sine"):
    """The IMDCT after its FFTs: (l_re, l_im) [F, 512] of the long DCT-IV
    and (s_re, s_im) [F, 8, 64] of the short ones, bt [F] -> [F, 2048]:
    post-twiddle, unfold and window of both families, the short
    sub-blocks added onto zeros in group order, the select by bt."""
    lw, sw = _windows(window, str(l_re.device))
    bt = bt.long()
    vl = xmath.unfold(xmath.dct_iv_post(l_re, l_im)) * lw[bt]
    subs = xmath.unfold(xmath.dct_iv_post(s_re, s_im)) * sw
    off = C.SHORT_OFFSET
    vs = torch.zeros_like(vl)
    for g in range(C.N_SHORT):
        lo = off + g * C.SHORT_COEFFS
        vs[:, lo:lo + C.SHORT_SIZE] += subs[:, g]
    return torch.where((bt == C.SHORT)[:, None], vs, vl)
