"""K8: the psychoacoustic model after its FFTs as a hand-written CUDA
kernel.

Replaces what jit A (mrcaudiocodec_tpu/models/encoder.py:65-120) runs of
the JAX ops/psycho.analyze after the FFTs: the back halves of
native/xpsy_ffi.cpp modes 0 and 1 and its mode 2, then allowed_noise; no
Pallas counterpart. Source: csrc/psycho.cu (design and bound noted
there).

`psycho(l_re, l_im, s_re, s_im, coeffs, bt, fs, full_psycho)`: K1's
outputs of the long psycho spectrum [F, 1024] and the short [F, 8, 128],
the MDCT coefficients [F, 1024] and bt [F] -> (allowed [F, NB], pe [F],
e_mdct [F, NB]) float32. For a CUDA tensor it launches the kernel (or
raises); for a CPU tensor it takes the plain version `psycho_plain`:
ops/psycho.thresholds on xpsy.rfft_untwist_power's spectra.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config as C
from ... import tables as T
from ... import xpsy

launches = 0            # kernel launches since the last reset
NB_MAX = 256            # the kernel's threads: one a unified band


def psycho_plain(l_re, l_im, s_re, s_im, coeffs, bt, fs: int,
                 full_psycho: bool = True):
    """Plain PyTorch version (same contract as the kernel)."""
    from ..psycho import thresholds
    return thresholds(xpsy.rfft_untwist_power(l_re, l_im),
                      xpsy.rfft_untwist_power(s_re, s_im), coeffs, bt, fs,
                      full_psycho)


@functools.lru_cache(maxsize=None)
def check_layout(fs: int) -> int:
    """The unified band count NB at fs, after checking what the kernel
    assumes of the layout: each family's unified bands are its own bands
    (the short ones group by group), then bands of width 0 at the end;
    NB <= NB_MAX; the shared-memory slots hold every family's groups x
    partitions and groups x bands padded to a power of two."""
    lay = T.unified_layout(fs)
    nb = lay["nb"]
    for long_block, bt in ((True, C.LONG), (False, C.SHORT)):
        cst = xpsy.psy_tables(fs, long_block)
        groups = 1 if long_block else C.N_SHORT
        h = C.LONG_COEFFS // groups
        be = np.asarray(cst["band_edges"])
        own = np.concatenate([[0]] + [g * h + be[1:] for g in range(groups)])
        edges = np.asarray(lay["edges"][bt])
        p2 = 1 << (cst["nb"] - 1).bit_length()
        if not (np.array_equal(edges[:len(own)], own)
                and (edges[len(own):] == C.LONG_COEFFS).all()
                and nb <= NB_MAX and groups * cst["npart"] <= 256
                and groups * p2 <= 128):
            raise ValueError(f"psycho_kernel: unified layout at {fs} Hz is "
                             f"not what the kernel assumes")
    return nb


@functools.lru_cache(maxsize=None)
def _blobs(fs: int, device: str):
    """(i32 long, f32 long, i32 short, f32 short) kernel_blobs on device."""
    out = ()
    for long_block in (True, False):
        f32, i32 = xpsy.kernel_blobs(fs, long_block)
        out += (torch.from_numpy(i32).to(device),
                torch.from_numpy(f32).to(device))
    return out


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("psycho").mrc_psycho
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def psycho_kernel(l_re, l_im, s_re, s_im, coeffs, bt, fs: int,
                  full_psycho: bool = True):
    """Launch K8 on CUDA tensors; same contract as psycho_plain."""
    global launches
    nb = check_layout(fs)
    nf = bt.shape[0]
    want = ((l_re, torch.float32, (nf, C.LONG_COEFFS)),
            (l_im, torch.float32, (nf, C.LONG_COEFFS)),
            (s_re, torch.float32, (nf, C.N_SHORT, C.SHORT_COEFFS)),
            (s_im, torch.float32, (nf, C.N_SHORT, C.SHORT_COEFFS)),
            (coeffs, torch.float32, (nf, C.LONG_COEFFS)),
            (bt, torch.int32, (nf,)))
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_cuda
                or not t.is_contiguous() or t.device != bt.device):
            raise ValueError(
                f"psycho_kernel: want contiguous {dtype} {shape} on the card "
                f"of bt, got {t.dtype} {tuple(t.shape)} on {t.device}")
    dev = bt.device
    allowed = torch.empty((nf, nb), dtype=torch.float32, device=dev)
    pe = torch.empty((nf,), dtype=torch.float32, device=dev)
    e_mdct = torch.empty((nf, nb), dtype=torch.float32, device=dev)
    if nf == 0:
        return allowed, pe, e_mdct
    blobs = _blobs(fs, str(dev))
    with torch.cuda.device(dev):           # the tensors' card is current
        rc = _fn()(l_re.data_ptr(), l_im.data_ptr(), s_re.data_ptr(),
                   s_im.data_ptr(), coeffs.data_ptr(), bt.data_ptr(),
                   *[b.data_ptr() for b in blobs], xpsy.kernel_consts().ctypes.data,
                   nb, int(bool(full_psycho)), allowed.data_ptr(),
                   pe.data_ptr(), e_mdct.data_ptr(), nf,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"psycho launch failed: cudaError {rc}")
    launches += 1
    return allowed, pe, e_mdct


def psycho(l_re, l_im, s_re, s_im, coeffs, bt, fs: int,
           full_psycho: bool = True):
    """The psycho chain after its FFTs: K8 on the card, the plain version
    for CPU tensors, an error for anything else."""
    if bt.is_cuda:
        return psycho_kernel(l_re, l_im, s_re, s_im, coeffs, bt, fs,
                             full_psycho)
    if bt.device.type == "cpu":
        return psycho_plain(l_re, l_im, s_re, s_im, coeffs, bt, fs,
                            full_psycho)
    raise ValueError(f"no psycho for device {bt.device}")
