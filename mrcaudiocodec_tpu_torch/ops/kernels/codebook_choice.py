"""K13: the decide layer's tail, the per-band codebook choice and the
decisions' narrow types, in one launch a chunk, as a hand-written CUDA
kernel (a warp a frame).

Replaces no Pallas kernel: the JAX package's choice is
`mrcaudiocodec_tpu/ops/entropy.py:199` `payload_costs_and_choice`, bf16
mask matmuls that XLA runs. Source: csrc/codebook_choice.cu (design and
bound noted there).

`codebook_choice(q, amp, gain, bt, fs)`: K4's q [F, 1024], amp [F, NB] and
gain [F] and the block types bt [F], int32 each (|q| <= QMAX, bt 0..4) ->
the compact decisions (q [F, 1024] int16, amp [F, NB] int8, gain [F]
int16, bt [F] int8, cb [F, NB] int8), cb each band's first cheapest valid
codebook (0 for a band of width 0). It launches the kernel for CUDA
tensors, takes the plain version `codebook_choice_plain` (the entropy
stage's `payload_costs_and_choice`, then the casts) for CPU tensors, and
raises for anything else.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config as C
from ... import tables as T
from ... import trace
from .. import entropy
from .quant_cost import _pair_tables, check_aligned

I8, I16, I32 = torch.int8, torch.int16, torch.int32
NB_MAX = 128            # kNbMax

launches = 0            # kernel launches since the last reset


@functools.lru_cache(maxsize=None)
def band_map(fs: int) -> np.ndarray:
    """The kernel's band maps, [5, 256] uint8: the band of each 4-tuple of
    bins for each block type (the layout's bin -> band map at every fourth
    bin; SHORT in group-major order)."""
    return np.ascontiguousarray(T.unified_layout(fs)["bin_band"][:, ::4],
                                np.uint8)


@functools.lru_cache(maxsize=None)
def _band_map(fs: int, device: str):
    return torch.from_numpy(band_map(fs)).to(device)


def codebook_choice_plain(q, amp, gain, bt, fs: int):
    """Plain PyTorch version: the entropy stage's choice, then the casts."""
    cb, _ = entropy.payload_costs_and_choice(q, bt, fs)
    return q.to(I16), amp.to(I8), gain.to(I16), bt.to(I8), cb.to(I8)


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("codebook_choice").mrc_codebook_choice
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def codebook_choice_kernel(q, amp, gain, bt, fs: int):
    """Launch K13 on CUDA tensors; same contract as codebook_choice_plain.
    Reads nothing back from the card."""
    global launches
    dev = q.device
    tb = entropy.dev_tables(fs, str(dev))
    nf, nb = q.shape[0], tb["nb"]
    for t, shape in ((q, (nf, C.LONG_COEFFS)), (amp, (nf, nb)), (gain, (nf,)),
                     (bt, (nf,))):
        if (not t.is_cuda or t.dtype != I32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(
                f"codebook_choice_kernel: want contiguous int32 {shape} on "
                f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if nb > NB_MAX:
        raise ValueError(f"codebook_choice_kernel: {nb} bands, more than "
                         f"{NB_MAX}")
    check_aligned("codebook_choice_kernel q", q)
    out = (torch.empty((nf, C.LONG_COEFFS), dtype=I16, device=dev),
           torch.empty((nf, nb), dtype=I8, device=dev),
           torch.empty((nf,), dtype=I16, device=dev),
           torch.empty((nf,), dtype=I8, device=dev),
           torch.empty((nf, nb), dtype=I8, device=dev))
    if nf == 0:
        return out
    check_aligned("codebook_choice_kernel q16", out[0])
    em, sf = _pair_tables(str(dev))
    with torch.cuda.device(dev):           # the tensors' card is current
        rc = _fn()(q.data_ptr(), amp.data_ptr(), gain.data_ptr(),
                   bt.data_ptr(), _band_map(fs, str(dev)).data_ptr(),
                   tb["len_small"].data_ptr(), em.data_ptr(), sf.data_ptr(),
                   *(t.data_ptr() for t in out), nf, nb,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"codebook_choice launch failed: cudaError {rc}")
    launches += 1
    trace.count("choice.kernel")
    return out


def codebook_choice(q, amp, gain, bt, fs: int):
    """The compact decisions: K13 on the card, the plain version for CPU
    tensors, an error for anything else."""
    if q.is_cuda:
        return codebook_choice_kernel(q, amp, gain, bt, fs)
    if q.device.type == "cpu":
        return codebook_choice_plain(q, amp, gain, bt, fs)
    raise ValueError(f"no codebook choice for device {q.device}")
