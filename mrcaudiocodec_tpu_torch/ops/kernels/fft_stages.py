"""K1: the normative FFT stages as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel `_stages_kernel` (`fft_classic`,
`fft_natural`) of mrcaudiocodec_tpu/ops/pallas/xmath_kernel.py. Source:
csrc/fft_stages.cu (design and bound noted there).

`fft(re, im)` is the natural-order complex FFT along the last axis that
every MDCT, IMDCT and psycho power spectrum runs. For a CUDA tensor it
launches the kernel (or raises); for a CPU tensor it takes the plain
version `fft_plain` — the roll-form `xmath.fft_dif_stages` plus
`xmath._bitrev`, which computes the same values.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import xmath

FFT_SIZES = (1024, 512, 128, 64)
launches = 0            # kernel launches since the last reset


def lanes_for(fft_size: int) -> int:
    """Row width the kernel runs a size-`fft_size` FFT on: 8 side-by-side
    FFTs for the short blocks (64 -> 512, 128 -> 1024), one otherwise."""
    return fft_size if fft_size >= 512 else 8 * fft_size


def fft_plain(re, im):
    """Plain PyTorch version: DIF stages + bit reversal (xmath)."""
    return xmath.fft_dif(re, im)


def compact_twiddles(fft_size: int) -> np.ndarray:
    """The kernel's twiddle table: the n - 1 distinct stage twiddles of
    `xmath._fft_stages(n)`, stage by stage (block size m = n, n/2, ..., 2
    at offset n - m, m/2 values each) -> f32 [n - 1, 2], (re, im) pairs."""
    stages = xmath._fft_stages(fft_size)
    return np.ascontiguousarray(np.stack(
        [np.concatenate([w[0] for w in stages]),
         np.concatenate([w[1] for w in stages])], -1), np.float32)


@functools.lru_cache(maxsize=None)
def _twiddles(fft_size: int, device: str):
    """compact_twiddles(fft_size) as a tensor on `device`."""
    return torch.from_numpy(compact_twiddles(fft_size)).to(device)


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("fft_stages").mrc_fft_stages
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fft_kernel(re, im):
    """Launch K1 on CUDA tensors [..., n], n in FFT_SIZES; returns the
    natural-order (re, im) of the same shape."""
    global launches
    n = re.shape[-1]
    if n not in FFT_SIZES:
        raise ValueError(f"fft size {n} not in {FFT_SIZES}")
    for t in (re, im):
        if not t.is_cuda or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError("fft_kernel needs contiguous float32 CUDA tensors")
    if im.shape != re.shape or im.device != re.device:
        raise ValueError("re and im differ in shape or device")
    lanes = lanes_for(n)
    if re.numel() % lanes:
        raise ValueError(f"{tuple(re.shape)} does not fill rows of {lanes}")
    out_r = torch.empty_like(re)
    out_i = torch.empty_like(im)
    if re.numel() == 0:
        return out_r, out_i
    tw = _twiddles(n, str(re.device))
    with torch.cuda.device(re.device):     # the tensors' card is current
        rc = _fn()(re.data_ptr(), im.data_ptr(), tw.data_ptr(),
                   out_r.data_ptr(), out_i.data_ptr(), re.numel() // n, n,
                   torch.cuda.current_stream(re.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fft_stages launch failed: cudaError {rc}")
    launches += 1
    return out_r, out_i


def fft(re, im):
    """Natural-order FFT along the last axis: K1 on the card, the plain
    version for CPU tensors, an error for anything else."""
    if re.is_cuda:
        return fft_kernel(re, im)
    if re.device.type == "cpu":
        return fft_plain(re, im)
    raise ValueError(f"no FFT for device {re.device}")
