"""K3: a chunk's MRC1 stream body built on the card by a hand-written CUDA
kernel, records compacted in stream order.

Replaces the record packing that the JAX package leaves to XLA
(mrcaudiocodec_tpu/ops/device_pack.py `pack_records_device`) and the host
concatenation of the records; it has no Pallas counterpart. Source:
csrc/record_pack.cu (design and bound noted there). Its plain version is
`ops/device_pack.pack_stream_plain`, and `device_pack.pack_stream`
launches this kernel for CUDA tensors and takes the plain version for CPU
tensors.

`pack_stream_kernel(q, amp, gain, bt, cb, order, fs, cap)` -> (body
[N * cap] uint8, its first `total` bytes the records order[0], order[1],
... back to back; nbytes [N] int32 in that order; status [2] int32 on the
host, (total, max nbytes)) for the decisions in the encoder's dtypes (q
int16 [F, 1024], amp int8 [F, NB], gain int16 [F], bt int8 [F], cb int8
[F, NB]) and in its ranges (|q| <= QMAX, amp 0..AMP_MAX, gain 0..255, bt
0..4, cb 0..3), and `order` int32 [N] of record indices in [0, F): the
kernel indexes its tables and the decisions with them unchecked, as the
encoder's `decide_chunk` and `stream_order` make them. A record longer
than `cap` raises: the wrapper reads the status, one small copy and the
one host sync of a launch (counted as `host_syncs.pack_status`).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ... import config as C
from ... import tables as T
from ... import trace
from .quant_cost import check_aligned

launches = 0            # kernel launches since the last reset
MAX_CAP_BYTES = 32 * 1024   # kMaxCapBytes
MAX_WARPS = 8               # kMaxWarps: records per tile
NB_MAX = 128                # kNbMax
SMEM_LIMIT = 48 * 1024      # a block's shared memory without the opt-in
SMEM_OPT_IN = 227 * 1024    # with it (kMaxSmemOptIn, the H100's)
# the kernel's static shared memory: code table, s_tile, s_off, s_nb[8],
# s_excl[2][8] (int32), pair -> band map and real-band flags (bytes),
# rounded up to 16 bytes (5600 B)
STATIC_SMEM = -(-(4 * (81 + 81 + 289 + 121 + 2 + 3 * MAX_WARPS)
                  + C.N_BLOCK_TYPES * (C.LONG_COEFFS // 2 + NB_MAX))
                // 16) * 16
BOOKS = ("small", "mid", "esc", "sf")       # order in the merged table


def dyn_smem(cap: int, warps: int) -> int:
    """Dynamic shared memory of a block (`dyn_smem` in the .cu): per warp
    its record's codebook ids and two buffers of staging words."""
    return warps * (NB_MAX + 2 * 4 * ((cap + 3) // 4))


def warps_per_block(cap: int) -> int:
    """Records a tile (warps a block): as many as fit the default 48 KB of
    shared memory beside the tables, at most MAX_WARPS, and at least one
    (above a cap of about 21 KB one warp needs more than 48 KB, and the
    kernel's C entry opts in to it)."""
    per_warp = dyn_smem(cap, 1)
    return max(1, min(MAX_WARPS, (SMEM_LIMIT - STATIC_SMEM) // per_warp))


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
    """[5, 512] uint8 band of each pair of bins, per block type."""
    bands = T.unified_layout(fs)["bin_band"][:, ::2]
    if bands.max() >= NB_MAX:
        raise ValueError(f"fs={fs}: more than {NB_MAX} bands")
    return np.ascontiguousarray(bands, np.uint8)


@functools.lru_cache(maxsize=None)
def real_bands(fs: int) -> np.ndarray:
    """[5, 128] uint8: 1 where the band is real (width > 0), per block
    type; 0 past nb."""
    width = T.unified_layout(fs)["width"]
    out = np.zeros((C.N_BLOCK_TYPES, NB_MAX), np.uint8)
    out[:, :width.shape[1]] = width > 0
    return out


@functools.lru_cache(maxsize=None)
def _dev_tables(fs: int, device: str):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(code_table()), t(pair_band(fs)), t(real_bands(fs))


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("record_pack").mrc_record_pack
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
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


def check_order(name, order, q):
    """Raise unless `order` is a contiguous 1-D int32 tensor on q's device."""
    if (order.dtype != torch.int32 or order.dim() != 1
            or not order.is_contiguous() or order.device != q.device):
        raise ValueError(f"{name}: want a contiguous 1-D int32 order on "
                         f"{q.device}, got {order.dtype} "
                         f"{tuple(order.shape)} on {order.device}")


def pack_stream_kernel(q, amp, gain, bt, cb, order, fs: int, cap: int):
    """Launch K3 on CUDA tensors -> (body [N * cap] uint8, nbytes [N] int32,
    status [2] int32 on the host)."""
    global launches
    nb = int(T.unified_layout(fs)["nb"])
    check_decisions("pack_stream_kernel", q, amp, gain, bt, cb, nb, True)
    check_order("pack_stream_kernel", order, q)
    check_aligned("pack_stream_kernel q", q)
    if not 0 < cap <= MAX_CAP_BYTES:
        raise ValueError(f"pack_stream_kernel: cap {cap} outside "
                         f"[1, {MAX_CAP_BYTES}]")
    n = order.shape[0]
    if n * cap >= 1 << 31:
        raise ValueError(f"pack_stream_kernel: {n} records x cap {cap} "
                         f"bytes do not fit a 31-bit offset")
    dev = q.device
    body = torch.empty((n * cap,), dtype=torch.uint8, device=dev)
    nbytes = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        return body, nbytes, torch.zeros(2, dtype=torch.int32)
    warps = warps_per_block(cap)
    status = torch.empty((2,), dtype=torch.int32, device=dev)
    scratch = torch.empty((-(-n // warps) + 1,), dtype=torch.int64,
                          device=dev)
    codes, bands, real = _dev_tables(fs, str(dev))
    # the tensors' card is current: the C entry's cached occupancy query
    # keys on cudaGetDevice
    with torch.cuda.device(dev):
        rc = _fn()(q.data_ptr(), amp.data_ptr(), gain.data_ptr(),
                   bt.data_ptr(), cb.data_ptr(), order.data_ptr(),
                   codes.data_ptr(), bands.data_ptr(), real.data_ptr(),
                   body.data_ptr(), nbytes.data_ptr(), status.data_ptr(),
                   scratch.data_ptr(), n, nb, cap, warps,
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"record_pack launch failed: code {rc}")
    launches += 1
    trace.count("host_syncs.pack_status")
    status = status.cpu()
    need = int(status[1])
    if need > cap:
        raise ValueError(f"record_pack: a record needs {need} bytes, more "
                         f"than cap={cap}")
    return body, nbytes, status


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
