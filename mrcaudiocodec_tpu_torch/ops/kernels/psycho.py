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
NB_MAX = 96             # unified bands a warp writes, 3 a lane


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
    NB <= NB_MAX; a warp's slots hold the family's groups x partitions
    (at most 96 long, 192 short: 3 and 6 chains a lane), groups x bands
    and groups x bands padded to a power of two (at most 128); every
    segment holds a bin, so each ends at its own bin; and each band's
    partition range in xpsy.kernel_sched is exactly the partitions
    pb_mask maps to it."""
    lay = T.unified_layout(fs)
    nb = lay["nb"]
    for long_block, bt in ((True, C.LONG), (False, C.SHORT)):
        cst = xpsy.psy_tables(fs, long_block)
        groups = 1 if long_block else C.N_SHORT
        h = C.LONG_COEFFS // groups
        be = np.asarray(cst["band_edges"])
        own = np.concatenate([[0]] + [g * h + be[1:] for g in range(groups)])
        edges = np.asarray(lay["edges"][bt])
        npart, nbf = cst["npart"], cst["nb"]
        p2 = 1 << (nbf - 1).bit_length()
        sched = xpsy.kernel_sched(fs, long_block)
        lo = sched[512 + npart + nbf:512 + npart + 2 * nbf]
        hi = sched[512 + npart + 2 * nbf:512 + npart + 3 * nbf]
        ranges = (np.arange(npart)[:, None] >= lo) & \
            (np.arange(npart)[:, None] <= hi)
        if not (np.array_equal(edges[:len(own)], own)
                and (edges[len(own):] == C.LONG_COEFFS).all()
                and nb <= NB_MAX
                and groups * npart <= (96 if long_block else 192)
                and groups * nbf <= 128 and groups * p2 <= 128
                and (np.diff(cst["part_edges"]) > 0).all()
                and (np.diff(cst["band_edges"]) > 0).all()
                and np.array_equal(ranges, cst["pb_mask"])):
            raise ValueError(f"psycho_kernel: unified layout at {fs} Hz is "
                             f"not what the kernel assumes")
    return nb


@functools.lru_cache(maxsize=None)
def _tables(fs: int, device: str):
    """(f32 blob long, f32 blob short, lane tables long, lane tables
    short) on device, in mrc_psycho's order, and the families' counts [8]
    int32 on the host (NP, nb, partition and band stages: the i32 blobs'
    header)."""
    blobs, sched, dims = [], [], []
    for long_block in (True, False):
        f32, i32 = xpsy.kernel_blobs(fs, long_block)
        blobs.append(torch.from_numpy(f32).to(device))
        sched.append(torch.from_numpy(xpsy.kernel_sched(fs, long_block)
                                      ).to(device))
        dims += [int(v) for v in i32[2:6]]
    return tuple(blobs + sched), np.asarray(dims, np.int32)


def occupancy():
    """(warps a block, dynamic shared memory bytes a block, blocks an SM
    of the current card by CUDA's occupancy calculator) of K8."""
    from .build import lib
    out = [ctypes.c_int() for _ in range(3)]
    rc = lib("psycho").mrc_psycho_occupancy(*[ctypes.byref(v) for v in out])
    if rc != 0:
        raise RuntimeError(f"psycho occupancy failed: cudaError {rc}")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("psycho").mrc_psycho
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
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
        # the five float inputs are read with 16-byte loads; bt an int a time
        if (t.dtype != dtype or tuple(t.shape) != shape or not t.is_cuda
                or not t.is_contiguous() or t.device != bt.device
                or (t is not bt and t.data_ptr() % 16)):
            raise ValueError(
                f"psycho_kernel: want contiguous {dtype} {shape} on the card "
                f"of bt (floats 16-byte aligned), got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    dev = bt.device
    allowed = torch.empty((nf, nb), dtype=torch.float32, device=dev)
    pe = torch.empty((nf,), dtype=torch.float32, device=dev)
    e_mdct = torch.empty((nf, nb), dtype=torch.float32, device=dev)
    if nf == 0:
        return allowed, pe, e_mdct
    tables, dims = _tables(fs, str(dev))
    consts = xpsy.kernel_consts()          # alive through the call
    with torch.cuda.device(dev):           # the tensors' card is current
        rc = _fn()(l_re.data_ptr(), l_im.data_ptr(), s_re.data_ptr(),
                   s_im.data_ptr(), coeffs.data_ptr(), bt.data_ptr(),
                   *[t.data_ptr() for t in tables], dims.ctypes.data,
                   consts.ctypes.data, nb, int(bool(full_psycho)),
                   allowed.data_ptr(), pe.data_ptr(), e_mdct.data_ptr(), nf,
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
