"""K2: the RD loop's quantization-cost sweep as a hand-written CUDA kernel.

Replaces the Pallas TPU kernel `_quant_kernel` (`payload_bits_for_gains`)
of mrcaudiocodec_tpu/ops/pallas/quant_kernel.py. Source:
csrc/quant_cost.cu (design and bound noted there).

`payload_bits(x, amp_bin, gains, bt, fs)` -> [F, G] int32 is the exact
Huffman payload of each frame quantized at each gain candidate. For CUDA
tensors it launches the kernel at every G (the coarse G=32, fine G=8,
refine G=4 and fallback G=1 sweeps all compute this one function) or
raises; for CPU tensors it takes the plain version `payload_bits_plain`:
quantize, then the entropy stage's per-band cheapest codebook, summed.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config as C
from ... import tables as T
from ... import xpsy
from .. import entropy, quantize

launches = 0            # kernel launches since the last reset


def payload_bits_plain(x, amp_bin, gains, bt, fs: int):
    """Plain PyTorch version: [F,1024] f32, [F,1024] i32, [F,G] i32, [F]
    -> [F,G] int32 payload bits (materializes [F, G, 1024])."""
    e_bin = torch.clamp(gains[:, :, None] - amp_bin[:, None, :],
                        C.GAIN_MIN, C.GAIN_MAX)
    q = quantize.quantize(x[:, None, :], e_bin)
    _, payload = entropy.payload_costs_and_choice(q, bt, fs)
    return payload.sum(-1, dtype=torch.int32)


@functools.lru_cache(maxsize=None)
def band_tuples(fs: int) -> np.ndarray:
    """The kernel's band map: [5, nb + 1] int32 tuple edges, band b of
    block type t holding 4-tuples band_tuples[t, b] .. band_tuples[t, b+1]
    - 1 (`unified_layout(fs)["edges"] / 4`; SHORT in group-major order)."""
    edges = T.unified_layout(fs)["edges"]
    if np.any(edges % 4):
        raise ValueError(f"fs={fs}: a band edge is not a multiple of 4")
    return np.ascontiguousarray(edges // 4, np.int32)


@functools.lru_cache(maxsize=None)
def _band_tuples(fs: int, device: str):
    return torch.from_numpy(band_tuples(fs)).to(device)


@functools.lru_cache(maxsize=1)
def pair_tables() -> tuple[np.ndarray, np.ndarray]:
    """The kernel's pair tables, [33 * 33] int32 each, at (v0 + 16) * 33 +
    v1 + 16 for a pair's signed magnitudes v clamped to [-16, 16]:
    em = CB_ESC length of the pair + its sign bits | CB_MID length << 16;
    sf = CB_SMALL half-symbol 3 (s0 + 1) + s1 + 1 (s = clamp(v, -1, 1)) |
    flags << 4 (a magnitude > 0, > 1, > 4: bits 0-2)."""
    ca = T.code_arrays()
    e = C.ESC_MAG
    v0, v1 = (a.ravel() for a in np.meshgrid(np.arange(-e, e + 1),
                                             np.arange(-e, e + 1),
                                             indexing="ij"))
    m0, m1 = np.abs(v0), np.abs(v1)
    esc = ca["len_esc"][m0 * (e + 1) + m1] + (m0 > 0) + (m1 > 0)
    mid = ca["len_mid"][(np.clip(v0, -4, 4) + 4) * 9 + np.clip(v1, -4, 4) + 4]
    top = np.maximum(m0, m1)
    flags = (top > 0) | ((top > 1) << 1) | ((top > 4) << 2)
    half = (np.clip(v0, -1, 1) + 1) * 3 + np.clip(v1, -1, 1) + 1
    return (np.ascontiguousarray(esc | (mid << 16), np.int32),
            np.ascontiguousarray(half | (flags << 4), np.int32))


@functools.lru_cache(maxsize=None)
def _pair_tables(device: str):
    return tuple(torch.from_numpy(t).to(device) for t in pair_tables())


def check_aligned(name: str, t, nbytes: int = 16):
    """Raise unless t's data starts on an nbytes boundary (the kernel reads
    x and amp_bin as float4/int4); any device."""
    if t.data_ptr() % nbytes:
        raise ValueError(f"{name}: data pointer {t.data_ptr():#x} is not "
                         f"{nbytes}-byte aligned")


@functools.lru_cache(maxsize=None)
def _consts(device: str):
    """[11] f32: xsqrt start polynomial, inverse step fractions, magic."""
    c = np.concatenate([np.asarray(xpsy.RSQRT_P, np.float32),
                        quantize.INV_FRACS,
                        np.asarray([quantize.QUANT_MAGIC], np.float32)])
    return torch.from_numpy(c.astype(np.float32)).to(device)


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("quant_cost").mrc_quant_cost
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def payload_bits_kernel(x, amp_bin, gains, bt, fs: int):
    """Launch K2 on CUDA tensors; same contract as payload_bits_plain."""
    global launches
    nf = x.shape[0]
    want = ((x, torch.float32, (nf, C.LONG_COEFFS)),
            (amp_bin, torch.int32, (nf, C.LONG_COEFFS)),
            (gains, torch.int32, (nf, gains.shape[-1])),
            (bt, torch.int32, (nf,)))
    for t, dtype, shape in want:
        if (not t.is_cuda or t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != x.device):
            raise ValueError(
                f"payload_bits_kernel: want contiguous {dtype} {shape} on "
                f"{x.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    check_aligned("payload_bits_kernel x", x)
    check_aligned("payload_bits_kernel amp_bin", amp_bin)
    g = gains.shape[-1]
    out = torch.empty((nf, g), dtype=torch.int32, device=x.device)
    if nf == 0 or g == 0:
        return out
    dev = str(x.device)
    tb = entropy.dev_tables(fs, dev)
    em, sf = _pair_tables(dev)
    bands, consts = _band_tuples(fs, dev), _consts(dev)
    with torch.cuda.device(x.device):      # the tensors' card is current
        rc = _fn()(x.data_ptr(), amp_bin.data_ptr(), gains.data_ptr(),
                   bt.data_ptr(), bands.data_ptr(),
                   tb["len_small"].data_ptr(), em.data_ptr(), sf.data_ptr(),
                   consts.data_ptr(), out.data_ptr(), nf, g, tb["nb"],
                   torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_cost launch failed: code {rc}")
    launches += 1
    return out


def payload_bits(x, amp_bin, gains, bt, fs: int):
    """[F, G] int32 payload bits: K2 on the card, the plain version for
    CPU tensors, an error for anything else."""
    if x.is_cuda:
        return payload_bits_kernel(x, amp_bin, gains, bt, fs)
    if x.device.type == "cpu":
        return payload_bits_plain(x, amp_bin, gains, bt, fs)
    raise ValueError(f"no payload_bits for device {x.device}")
