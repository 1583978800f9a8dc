"""K4: the RD loop's outer iterations as one hand-written CUDA kernel.

Replaces the `jax.lax.while_loop`s of the JAX package's batched RD search
(mrcaudiocodec_tpu/ops/rd.py: the outer distortion loop :255-269, the
staged refine search :189 and its GAIN_MAX fallback `lax.cond` :200),
which the JAX package leaves to XLA; it has no Pallas counterpart. Source:
csrc/rd_loop.cu (design and bound noted there). Its plain version is
`ops/rd.rd_loop_plain`, and `rd.rd_loop` launches this kernel for CUDA
tensors and takes the plain version for CPU tensors.

`rd_loop_kernel(x, allowed, budget_content, bt, gain0, bits0, fs)` ->
(q [F, 1024] int32, amp [F, NB] int32, gain [F] int32, bits [F] int32)
for x [F, 1024] float32 (16-byte aligned), allowed [F, NB] float32 and
budget_content, bt (0..4), gain0 (0..255) and bits0, [F] int32 each: the
inner sweep's choice, from which one block a frame runs the loop to that
frame's own exit. No host sync. The kernel reads |q|^(4/3) from a table of
QMAX + 1 entries (`pow43_table`), built on the tensors' device at first use
by quantize.dequantize's own chain.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config as C
from ... import xpsy
from .. import entropy, quantize
from .quant_cost import _band_tuples, _pair_tables, check_aligned

launches = 0            # kernel launches since the last reset
NB_MAX = 128            # kNbMax


@functools.lru_cache(maxsize=1)
def consts() -> np.ndarray:
    """The kernel's [15] f32 constants: K2's 11 (xsqrt start polynomial,
    inverse step fractions, QUANT_MAGIC), then the step fractions [4]
    (offset 11 in csrc/rd_loop.cu)."""
    parts = [xpsy.RSQRT_P, quantize.INV_FRACS, [quantize.QUANT_MAGIC],
             quantize.FRACS]
    return np.concatenate([np.asarray(p, np.float32) for p in parts])


@functools.lru_cache(maxsize=None)
def _dev_consts(device: str):
    return torch.from_numpy(consts()).to(device)


def pow43_table(device) -> torch.Tensor:
    """[QMAX + 1] f32: |q|^(4/3) for q = 0 .. QMAX, 0 at q = 0, by
    quantize.dequantize's own chain at step 1 (e = GAIN_BIAS, an exact
    1.0) on `device`: the kernel's val = table[|q|] * step is dequantize's
    value bit for bit."""
    q = torch.arange(C.QMAX + 1, dtype=torch.int32, device=device)
    return quantize.dequantize(q, torch.full_like(q, C.GAIN_BIAS))


@functools.lru_cache(maxsize=None)
def _dev_pow43(device: str):
    return pow43_table(device)


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("rd_loop").mrc_rd_loop
    fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def blocks_per_sm() -> int:
    """The blocks of K4 one SM of the current card holds at once (CUDA's
    occupancy calculator on the built kernel)."""
    from .build import lib
    return int(lib("rd_loop").mrc_rd_loop_blocks_per_sm())


def check_inputs(name, x, allowed, budget_content, bt, gain0, bits0,
                 nb: int, cuda: bool):
    """Raise unless the inputs have the kernel's dtypes and shapes, are
    contiguous, share x's device and (cuda) lie on the card."""
    nf = x.shape[0]
    want = ((x, torch.float32, (nf, C.LONG_COEFFS)),
            (allowed, torch.float32, (nf, nb)),
            (budget_content, torch.int32, (nf,)), (bt, torch.int32, (nf,)),
            (gain0, torch.int32, (nf,)), (bits0, torch.int32, (nf,)))
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != x.device
                or (cuda and not t.is_cuda)):
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {x.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def rd_loop_kernel(x, allowed, budget_content, bt, gain0, bits0, fs: int):
    """Launch K4 on CUDA tensors; same contract as rd.rd_loop_plain."""
    global launches
    dev = x.device
    tb = entropy.dev_tables(fs, str(dev))
    nb = tb["nb"]
    check_inputs("rd_loop_kernel", x, allowed, budget_content, bt, gain0,
                 bits0, nb, True)
    check_aligned("rd_loop_kernel x", x)
    nf = x.shape[0]
    q = torch.empty((nf, C.LONG_COEFFS), dtype=torch.int32, device=dev)
    amp = torch.empty((nf, nb), dtype=torch.int32, device=dev)
    gain = torch.empty((nf,), dtype=torch.int32, device=dev)
    bits = torch.empty((nf,), dtype=torch.int32, device=dev)
    if nf == 0:
        return q, amp, gain, bits
    em, sf = _pair_tables(str(dev))
    bands, cst = _band_tuples(fs, str(dev)), _dev_consts(str(dev))
    with torch.cuda.device(dev):           # the tensors' card is current
        pow43 = _dev_pow43(str(dev))
        rc = _fn()(x.data_ptr(), allowed.data_ptr(),
                   budget_content.data_ptr(), bt.data_ptr(),
                   gain0.data_ptr(), bits0.data_ptr(), bands.data_ptr(),
                   tb["len_small"].data_ptr(), em.data_ptr(), sf.data_ptr(),
                   entropy._len_sf(str(dev)).data_ptr(), cst.data_ptr(),
                   pow43.data_ptr(), q.data_ptr(), amp.data_ptr(),
                   gain.data_ptr(), bits.data_ptr(), nf, nb,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rd_loop launch failed: code {rc}")
    launches += 1
    return q, amp, gain, bits
