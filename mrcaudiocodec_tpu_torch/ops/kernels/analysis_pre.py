"""K6: the analysis before its FFTs as a hand-written CUDA kernel.

Replaces the front halves of the JAX package's fused native chains that
jit A (mrcaudiocodec_tpu/models/encoder.py:65-120) runs:
native/xmath_ffi.cpp mode 1 (window, TDAC fold, the DCT-IV's split and
pre-twiddle) and native/xpsy_ffi.cpp modes 0 and 1 (Hann window, even /
odd de-interleave); no Pallas counterpart. Source: csrc/analysis_pre.cu
(design and bound noted there).

`analysis_pre(audio, bt, window, parts)` takes either a chunk's hop rows
[R, (s+3)*HOP] (int16 or float32) with bt [R, s], whose frame f of row r
is hops f+1 and f+2, or frames [F, 2048] float32 with bt [F], and returns
K1's inputs as (re, im) planes: for parts "mdct" or "all" the long MDCT
[F, 512] and the short MDCT [F, 8, 64], for "psycho" or "all" the long
psycho spectrum [F, 1024] and the short [F, 8, 128], in that order (F =
R * s). For a CUDA tensor it launches the kernel (or raises); for a CPU
tensor it takes the plain version `analysis_pre_plain`: xmath.fold and
xmath.dct_iv_pre, xpsy.rfft_pre on the eager frames.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config as C
from ... import xmath, xpsy
from .transients import check_rows, hop_frames

launches = 0            # kernel launches since the last reset
PARTS = ("all", "mdct", "psycho")


def frames_of(audio, bt):
    """The analysed frames [F, 2048] float32 of audio (see the module
    docstring for the two layouts)."""
    if bt.dim() == 1:
        return audio.to(torch.float32)
    s = bt.shape[1]
    return hop_frames(audio, s, 1, s)


def _check(audio, bt, parts):
    if parts not in PARTS:
        raise ValueError(f"parts {parts!r} not in {PARTS}")
    if bt.dim() == 1:
        want = (bt.shape[0], C.LONG_SIZE)
    else:
        want = (bt.shape[0], (bt.shape[1] + 3) * C.HOP)
    if tuple(audio.shape) != want:
        raise ValueError(f"audio {tuple(audio.shape)} for bt "
                         f"{tuple(bt.shape)}: want {want}")


def analysis_pre_plain(audio, bt, window, parts: str = "all"):
    """Plain PyTorch version (same contract as the kernel)."""
    from ..dsp import _windows, short_subblocks
    _check(audio, bt, parts)
    fr = frames_of(audio, bt)
    out = ()
    if parts in ("all", "mdct"):
        lw, sw = _windows(window, str(fr.device))
        out += xmath.dct_iv_pre(xmath.fold(fr * lw[bt.reshape(-1).long()]))
        out += xmath.dct_iv_pre(xmath.fold(short_subblocks(fr) * sw))
    if parts in ("all", "psycho"):
        hl, hs = _hann(str(fr.device))
        out += xpsy.rfft_pre(fr * hl)
        out += xpsy.rfft_pre(short_subblocks(fr) * hs)
    return out


@functools.lru_cache(maxsize=None)
def _hann(device: str):
    """The psycho windows: hann(2048), hann(256) on `device` (the values
    of xpsy.psy_tables' "hann" for the long and the short family)."""
    return tuple(torch.from_numpy(xpsy.hann(n)).to(device)
                 for n in (2 * C.LONG_COEFFS, 2 * C.SHORT_COEFFS))


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("analysis_pre").mrc_analysis_pre
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 16)
    fn.restype = ctypes.c_int
    return fn


def analysis_pre_kernel(audio, bt, window, parts: str = "all"):
    """Launch K6 on CUDA tensors; same contract as analysis_pre_plain."""
    global launches
    from ..dsp import _windows
    _check(audio, bt, parts)
    check_rows("analysis_pre_kernel", audio)
    if (bt.dtype != torch.int32 or not bt.is_contiguous()
            or bt.device != audio.device):
        raise ValueError("analysis_pre_kernel: bt must be contiguous int32 "
                         "on the audio's card")
    dev = audio.device
    if bt.dim() == 1:       # frames: a row a frame
        rows, s, offset, frame_stride = bt.shape[0], 1, 0, C.LONG_SIZE
    else:                   # hop rows: frame f at hop f + 1
        (rows, s), offset, frame_stride = bt.shape, C.HOP, C.HOP
    nf = rows * s
    shapes = []
    if parts in ("all", "mdct"):
        shapes += [(nf, C.LONG_COEFFS // 2), (nf, C.N_SHORT,
                                              C.SHORT_COEFFS // 2)]
    if parts in ("all", "psycho"):
        shapes += [(nf, C.LONG_COEFFS), (nf, C.N_SHORT, C.SHORT_COEFFS)]
    out = tuple(torch.empty(sh, dtype=torch.float32, device=dev)
                for sh in shapes for _ in range(2))
    if nf == 0:
        return out
    ptrs = [t.data_ptr() for t in out]
    if parts == "mdct":
        ptrs += [None] * 4
    elif parts == "psycho":
        ptrs = [None] * 4 + ptrs
    tabs = (_windows(window, str(dev)) if parts != "psycho" else (None,) * 2
            ) + _hann(str(dev)) + tuple(
                xmath.dev_dct4_blob(m, str(dev))
                for m in (C.LONG_COEFFS, C.SHORT_COEFFS))
    with torch.cuda.device(dev):           # the tensors' card is current
        rc = _fn()(audio.data_ptr(), int(audio.dtype == torch.int16),
                   audio.stride(0), frame_stride, offset, rows, s,
                   bt.data_ptr(),
                   *[None if t is None else t.data_ptr() for t in tabs],
                   *ptrs, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"analysis_pre launch failed: cudaError {rc}")
    launches += 1
    return out


def analysis_pre(audio, bt, window, parts: str = "all"):
    """K1's inputs of the analysis: K6 on the card, the plain version for
    CPU tensors, an error for anything else."""
    if audio.is_cuda:
        return analysis_pre_kernel(audio, bt, window, parts)
    if audio.device.type == "cpu":
        return analysis_pre_plain(audio, bt, window, parts)
    raise ValueError(f"no analysis for device {audio.device}")
