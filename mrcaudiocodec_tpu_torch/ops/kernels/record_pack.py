"""K3: MRC1 record bytes built on the card by a hand-written CUDA kernel.

Replaces the record packing that the JAX package leaves to XLA
(mrcaudiocodec_tpu/ops/device_pack.py `pack_records_device`); it has no
Pallas counterpart. Source: csrc/record_pack.cu (design and bound noted
there). Its plain version is `ops/device_pack.pack_records_plain`, and
`device_pack.pack_records` launches this kernel for CUDA tensors and takes
the plain version for CPU tensors.

`pack_records_kernel(q, amp, gain, bt, cb, fs, cap)` -> (rec [F, cap]
uint8, nbytes [F] int32) for the decisions in the encoder's dtypes (q
int16 [F, 1024], amp int8 [F, NB], gain int16 [F], bt int8 [F], cb int8
[F, NB]) and in its ranges (|q| <= QMAX, amp 0..AMP_MAX, gain 0..255, bt
0..4, cb 0..3): the kernel indexes its tables with them unchecked, as
the encoder's `decide_chunk` makes them. A record longer than `cap`
raises: the wrapper reads max(nbytes), one host sync per launch, the same
check as the plain version's.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config as C
from ... import tables as T
from .quant_cost import check_aligned

launches = 0            # kernel launches since the last reset
MAX_CAP_BYTES = 32 * 1024   # the kernel's shared buffer (kMaxCapBytes)
BOOKS = ("small", "mid", "esc", "sf")       # order in the merged table


@functools.lru_cache(maxsize=1)
def code_table() -> np.ndarray:
    """The kernel's merged codebook: [81 + 81 + 289 + 121] int32, code |
    len << 24, CB_SMALL, CB_MID, CB_ESC, then the sf deltas (offsets 0, 81,
    162, 451 in csrc/record_pack.cu)."""
    ca = T.code_arrays()
    parts = []
    for book in BOOKS:
        codes = ca[f"codes_{book}"].astype(np.int64)
        lens = ca[f"len_{book}"].astype(np.int64)
        if np.any(codes >> 24) or np.any(lens >= 128):
            raise ValueError(f"codebook {book} does not fit code | len << 24")
        parts.append(codes | (lens << 24))
    return np.ascontiguousarray(np.concatenate(parts), np.int32)


@functools.lru_cache(maxsize=None)
def pair_band(fs: int) -> np.ndarray:
    """[5, 512] int32 band of each pair of bins, per block type."""
    return np.ascontiguousarray(T.unified_layout(fs)["bin_band"][:, ::2],
                                np.int32)


@functools.lru_cache(maxsize=None)
def _dev_tables(fs: int, device: str):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(
        device)
    return (t(code_table()), t(pair_band(fs)),
            t(T.unified_layout(fs)["width"]))


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("record_pack").mrc_record_pack
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_decisions(name, q, amp, gain, bt, cb, nb: int, cuda: bool):
    """Raise unless the decisions have the kernel's dtypes and shapes, are
    contiguous, share one device and (cuda) lie on the card."""
    nf = q.shape[0]
    want = ((q, torch.int16, (nf, C.LONG_COEFFS)),
            (amp, torch.int8, (nf, nb)), (gain, torch.int16, (nf,)),
            (bt, torch.int8, (nf,)), (cb, torch.int8, (nf, nb)))
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != q.device
                or (cuda and not t.is_cuda)):
            raise ValueError(
                f"{name}: want contiguous {dtype} {shape} on {q.device}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def pack_records_kernel(q, amp, gain, bt, cb, fs: int, cap: int):
    """Launch K3 on CUDA tensors -> (rec [F, cap] uint8, nbytes [F] int32)."""
    global launches
    nb = int(T.unified_layout(fs)["nb"])
    check_decisions("pack_records_kernel", q, amp, gain, bt, cb, nb, True)
    check_aligned("pack_records_kernel q", q)
    if not 0 < cap <= MAX_CAP_BYTES:
        raise ValueError(f"pack_records_kernel: cap {cap} outside "
                         f"[1, {MAX_CAP_BYTES}]")
    nf = q.shape[0]
    rec = torch.empty((nf, cap), dtype=torch.uint8, device=q.device)
    nbytes = torch.empty((nf,), dtype=torch.int32, device=q.device)
    if nf == 0:
        return rec, nbytes
    codes, bands, width = _dev_tables(fs, str(q.device))
    rc = _fn()(q.data_ptr(), amp.data_ptr(), gain.data_ptr(), bt.data_ptr(),
               cb.data_ptr(), codes.data_ptr(), bands.data_ptr(),
               width.data_ptr(), rec.data_ptr(), nbytes.data_ptr(), nf, nb,
               cap, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"record_pack launch failed: code {rc}")
    launches += 1
    need = int(nbytes.max())
    if need > cap:
        raise ValueError(f"record_pack: a record needs {need} bytes, more "
                         f"than cap={cap}")
    return rec, nbytes


def random_decisions(rng, nf: int, fs: int):
    """Decisions that reach every slot kind, for checking K3 against its
    plain version: block types in turn, random codebook ids per real band
    with q in each codebook's range, escapes from 16 up to QMAX with both
    signs, random amp (0..AMP_MAX) and gain. numpy (q int16, amp int8, gain
    int16, bt int8, cb int8)."""
    lay = T.unified_layout(fs)
    nb = lay["nb"]
    bt = (np.arange(nf) % C.N_BLOCK_TYPES).astype(np.int8)
    real = lay["width"][bt] > 0
    cb = np.where(real, rng.integers(0, C.N_CODEBOOKS, (nf, nb)), 0)
    cb_bin = np.take_along_axis(cb, lay["bin_band"][bt], 1)
    n = (nf, C.LONG_COEFFS)
    esc = rng.integers(-20, 21, n)
    big = rng.random(n) < 0.08
    edges = np.array([15, 16, 31, 32, 1023, 1024, 2048, C.QMAX])
    mag = np.where(rng.random(n) < 0.5, rng.choice(edges, n),
                   rng.integers(16, C.QMAX + 1, n))
    esc = np.where(big, mag * rng.choice([-1, 1], n), esc)
    q = np.select([cb_bin == C.CB_SMALL, cb_bin == C.CB_MID,
                   cb_bin == C.CB_ESC],
                  [rng.integers(-1, 2, n), rng.integers(-4, 5, n), esc], 0)
    amp = rng.integers(0, C.AMP_MAX + 1, (nf, nb))
    gain = rng.integers(C.GAIN_MIN, C.GAIN_MAX + 1, nf)
    return (q.astype(np.int16), amp.astype(np.int8), gain.astype(np.int16),
            bt, cb.astype(np.int8))
