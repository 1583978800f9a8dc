"""K9: the decoder's synthesis before its FFTs as a hand-written CUDA
kernel.

Replaces the front half of the JAX package's decoder jit
(mrcaudiocodec_tpu/models/decoder.py:64-102: the band -> bin exponent
:85, quantize.dequantize :90, which the CPU runs as native/xpsy_ffi.cpp
mode 5) and of native/xmath_ffi.cpp mode 2 (the IMDCT's DCT-IV split and
pre-twiddle); no Pallas counterpart. Source: csrc/synth_pre.cu (design and
bound noted there).

`synth_pre(q, e_band, bt, fs)`: a chunk's records as the decoder's slabs
hold them, q int16 [R, s, 1024], e_band int16 [R, s, NB], bt int8 [R, s]
-> K1's inputs as (re, im) planes: the long DCT-IV's [F, 512] and the
short's [F, 8, 64], F = R * s, for every frame (both families). For a
CUDA tensor it launches the kernel (or raises); for a CPU tensor it takes
the plain version `synth_pre_plain`: the bin_band gather,
quantize.dequantize and xmath.dct_iv_pre.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config as C
from ... import tables as T
from ... import xmath, xpsy
from .. import entropy, quantize

launches = 0            # kernel launches since the last reset


def _check(q, e_band, bt, fs: int, cuda: bool):
    r, s = bt.shape if bt.dim() == 2 else (-1, -1)
    nb = T.unified_layout(fs)["nb"]
    want = ((q, torch.int16, (r, s, C.LONG_COEFFS)),
            (e_band, torch.int16, (r, s, nb)), (bt, torch.int8, (r, s)))
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or t.device != bt.device or t.is_cuda != cuda
                or not t.is_contiguous()):
            raise ValueError(
                f"synth_pre: want contiguous {dtype} {shape} on the device "
                f"of bt{' (a card)' if cuda else ''}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def synth_pre_plain(q, e_band, bt, fs: int):
    """Plain PyTorch version (same contract as the kernel)."""
    _check(q, e_band, bt, fs, bt.is_cuda)
    r, s = bt.shape
    nf = r * s
    btf = bt.reshape(-1).to(torch.int32)
    tb = entropy.dev_tables(fs, str(q.device))
    ef = e_band.reshape(nf, -1).to(torch.int32)
    # band -> bin exponent: an integer gather of each bin's band
    e_bin = torch.gather(ef, 1, tb["bin_band"][btf.long()].long())
    xhat = quantize.dequantize(q.reshape(nf, -1).to(torch.int32), e_bin)
    return (*xmath.dct_iv_pre(xhat), *xmath.dct_iv_pre(
        xhat.reshape(nf, C.N_SHORT, C.SHORT_COEFFS)))


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("synth_pre").mrc_synth_pre
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p,
                                            ctypes.c_float, ctypes.c_void_p]
                   + [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def synth_pre_kernel(q, e_band, bt, fs: int):
    """Launch K9 on CUDA tensors; same contract as synth_pre_plain."""
    global launches
    from .rd_loop import _dev_pow43
    _check(q, e_band, bt, fs, True)
    dev = bt.device
    nf = bt.numel()
    out = tuple(torch.empty(shape, dtype=torch.float32, device=dev)
                for shape in ((nf, C.LONG_COEFFS // 2),) * 2
                + ((nf, C.N_SHORT, C.SHORT_COEFFS // 2),) * 2)
    if nf == 0:
        return out
    tb = entropy.dev_tables(fs, str(dev))
    pow43 = _dev_pow43(str(dev))
    dl, ds = (xmath.dev_dct4_blob(m, str(dev))
              for m in (C.LONG_COEFFS, C.SHORT_COEFFS))
    consts = xpsy.kernel_consts()          # alive through the call
    fracs = quantize.FRACS
    with torch.cuda.device(dev):           # the tensors' card is current
        rc = _fn()(q.data_ptr(), e_band.data_ptr(), bt.data_ptr(),
                   tb["bin_band"].data_ptr(), pow43.data_ptr(),
                   dl.data_ptr(), ds.data_ptr(), e_band.shape[2],
                   consts.ctypes.data, float(quantize.C43), fracs.ctypes.data,
                   *[t.data_ptr() for t in out], nf,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"synth_pre launch failed: cudaError {rc}")
    launches += 1
    return out


def synth_pre(q, e_band, bt, fs: int):
    """K1's inputs of a chunk's synthesis: K9 on the card, the plain
    version for CPU tensors, an error for anything else."""
    if bt.is_cuda:
        return synth_pre_kernel(q, e_band, bt, fs)
    if bt.device.type == "cpu":
        return synth_pre_plain(q, e_band, bt, fs)
    raise ValueError(f"no synthesis for device {bt.device}")
