"""K7: the MDCT after its FFTs as a hand-written CUDA kernel.

Replaces the back half of the JAX package's native/xmath_ffi.cpp mode 1
(the DCT-IV's post-twiddle, interleave and scale) and dsp.analyze's
select by block type, which jit A (mrcaudiocodec_tpu/models/encoder.py:
65-120) runs; no Pallas counterpart. Source: csrc/mdct_post.cu (design
and bound noted there).

`mdct_post(l_re, l_im, s_re, s_im, bt)`: K1's outputs of the long MDCT
[F, 512] and the short [F, 8, 64], bt [F] -> coeffs [F, 1024] float32,
SHORT frames group-major. For a CUDA tensor it launches the kernel (or
raises); for a CPU tensor it takes the plain version `mdct_post_plain`:
xmath.dct_iv_post of both and torch.where on bt.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config as C
from ... import xmath

launches = 0            # kernel launches since the last reset


def mdct_post_plain(l_re, l_im, s_re, s_im, bt):
    """Plain PyTorch version (same contract as the kernel)."""
    xl = xmath.dct_iv_post(l_re, l_im)
    xs = xmath.dct_iv_post(s_re, s_im)
    return torch.where((bt == C.SHORT)[:, None], xs.reshape(xl.shape[0], -1),
                       xl)


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("mdct_post").mrc_mdct_post
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mdct_post_kernel(l_re, l_im, s_re, s_im, bt):
    """Launch K7 on CUDA tensors; same contract as mdct_post_plain."""
    global launches
    nf = bt.shape[0]
    want = ((l_re, torch.float32, (nf, C.LONG_COEFFS // 2)),
            (l_im, torch.float32, (nf, C.LONG_COEFFS // 2)),
            (s_re, torch.float32, (nf, C.N_SHORT, C.SHORT_COEFFS // 2)),
            (s_im, torch.float32, (nf, C.N_SHORT, C.SHORT_COEFFS // 2)),
            (bt, torch.int32, (nf,)))
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_cuda
                or not t.is_contiguous() or t.device != bt.device):
            raise ValueError(
                f"mdct_post_kernel: want contiguous {dtype} {shape} on the "
                f"card of bt, got {t.dtype} {tuple(t.shape)} on {t.device}")
    out = torch.empty((nf, C.LONG_COEFFS), dtype=torch.float32,
                      device=bt.device)
    if nf == 0:
        return out
    dl, ds = (xmath.dev_dct4_blob(m, str(bt.device))
              for m in (C.LONG_COEFFS, C.SHORT_COEFFS))
    with torch.cuda.device(bt.device):     # the tensors' card is current
        rc = _fn()(l_re.data_ptr(), l_im.data_ptr(), s_re.data_ptr(),
                   s_im.data_ptr(), bt.data_ptr(), dl.data_ptr(),
                   ds.data_ptr(), out.data_ptr(), nf,
                   torch.cuda.current_stream(bt.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mdct_post launch failed: cudaError {rc}")
    launches += 1
    return out


def mdct_post(l_re, l_im, s_re, s_im, bt):
    """MDCT coefficients from K1's outputs: K7 on the card, the plain
    version for CPU tensors, an error for anything else."""
    if bt.is_cuda:
        return mdct_post_kernel(l_re, l_im, s_re, s_im, bt)
    if bt.device.type == "cpu":
        return mdct_post_plain(l_re, l_im, s_re, s_im, bt)
    raise ValueError(f"no MDCT for device {bt.device}")
