"""K12: every row's bit-reservoir budgets in one launch, as a hand-written
CUDA kernel (a block a row).

Replaces no TPU kernel: the JAX package runs the scan as
`lax.associative_scan`. The port's torch scan (`reservoir.allocate` on a
CPU tensor, a Hillis-Steele scan of torch ops) stays as the CPU path.
Source: csrc/budget_scan.cu (design and bound noted there).

`budget_scan_kernel(pe, nf_row, mean_bits, lo, hi, cap)`: pe [R, F]
float32 on a card, nf_row [R] int64 on the same card or None (each row's
true frame count; None: F), host ints mean_bits, lo, hi, cap -> budgets
[R, F] int64, bit for bit what `reservoir.allocate` gives with lo, hi =
`reservoir.desired_bounds(mean_bits)` and cap = the config's
`reservoir_cap`; `reservoir.allocate` launches it for a card's tensors.
`budget_scan_plain` is its plain version, in the kernel's decomposition.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import trace
from .. import reservoir

I64 = torch.int64
THREADS = 512            # the kernel's threads a block (kThreads)
WARP = 32

launches = 0             # kernel launches since the last reset


def run_length(frames: int, threads: int = THREADS) -> int:
    """Frames a thread takes: ceil(frames / threads)."""
    return -(-frames // threads)


def _desired(pe, nf_row, mean_bits: int, lo: int, hi: int):
    """[R, F] float32 PE -> [R, F] int64 desired bits (masked, clamped)."""
    pe_q = reservoir.masked_pe(pe, nf_row)
    nf = pe.shape[-1] if nf_row is None else nf_row
    mean_pe = reservoir.mean_pe_from_sum(pe_q.sum(-1), nf)
    return torch.clamp(torch.div(mean_bits * pe_q, mean_pe[:, None],
                                 rounding_mode="floor"), lo, hi)


def budget_scan_plain(pe, nf_row, mean_bits: int, lo: int, hi: int,
                      cap: int, threads: int = THREADS):
    """Plain PyTorch version, in the kernel's decomposition: `threads`
    runs of ceil(F / threads) frames a row, each run's composed map, an
    exclusive scan of them (inclusive in each warp of 32, then the warps'
    totals applied in order), each run replayed from its entering level."""
    if threads % WARP:
        raise ValueError(f"budget_scan_plain: {threads} threads, not a "
                         f"multiple of {WARP}")
    rows, frames = pe.shape
    run = run_length(frames, threads)
    want = torch.nn.functional.pad(
        _desired(pe, nf_row, mean_bits, lo, hi),
        (0, threads * run - frames)).view(rows, threads, run)
    real = (torch.arange(threads * run, device=pe.device)
            < frames).view(threads, run)
    # (b) each run's map, frame by frame; frames past F are the identity
    m = reservoir.identity_maps((rows, threads), pe.device)
    for k in range(run):
        g = (mean_bits - want[:, :, k], torch.zeros_like(want[:, :, k]),
             torch.full_like(want[:, :, k], cap))
        g = tuple(torch.where(real[:, k], x, i) for x, i in zip(
            g, reservoir.identity_maps((rows, threads), pe.device)))
        m = reservoir._compose(m, g)
    # (c) inclusive in each warp, then each warp's entering level
    warps = threads // WARP
    incl = reservoir.scan_maps(*(x.view(rows, warps, WARP) for x in m))
    enter = torch.zeros((rows, warps), dtype=I64, device=pe.device)
    r = torch.zeros(rows, dtype=I64, device=pe.device)
    for w in range(warps):
        enter[:, w] = r
        r = reservoir.apply_maps(tuple(x[:, w, -1] for x in incl), r)
    before = tuple(x[:, :, :-1] for x in incl)   # lane - 1's inclusive map
    r = torch.cat([enter[:, :, None], reservoir.apply_maps(
        before, enter[:, :, None])], -1).view(rows, threads)
    # (d) each run replayed
    out = torch.empty_like(want)
    for k in range(run):
        out[:, :, k] = torch.minimum(want[:, :, k], mean_bits + r)
        r = torch.clamp(r + mean_bits - want[:, :, k], 0, cap)
    return out.view(rows, threads * run)[:, :frames]


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("budget_scan").mrc_budget_scan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def budget_scan_kernel(pe, nf_row, mean_bits: int, lo: int, hi: int,
                       cap: int):
    """Launch K12 on CUDA tensors; same contract as budget_scan_plain.
    Reads nothing back from the card."""
    global launches
    if (pe.dtype != torch.float32 or pe.dim() != 2 or not pe.is_cuda
            or not pe.is_contiguous()):
        raise ValueError(
            f"budget_scan_kernel: want contiguous float32 [R, F] on a card, "
            f"got {pe.dtype} {tuple(pe.shape)} on {pe.device}")
    rows, frames = pe.shape
    if nf_row is not None and (
            nf_row.dtype != I64 or nf_row.shape != (rows,)
            or nf_row.device != pe.device or not nf_row.is_contiguous()):
        raise ValueError(
            f"budget_scan_kernel: want contiguous int64 nf_row [{rows}] on "
            f"{pe.device}, got {nf_row.dtype} {tuple(nf_row.shape)} on "
            f"{nf_row.device}")
    if min(mean_bits, lo, hi, cap) < 0 or rows >= 1 << 31 \
            or frames >= 1 << 31:
        raise ValueError(
            f"budget_scan_kernel: mean_bits {mean_bits}, lo {lo}, hi {hi}, "
            f"cap {cap} (each >= 0) over [{rows}, {frames}]")
    out = torch.empty((rows, frames), dtype=I64, device=pe.device)
    if rows == 0 or frames == 0:
        return out
    with torch.cuda.device(pe.device):     # the tensors' card is current
        rc = _fn()(pe.data_ptr(),
                   None if nf_row is None else nf_row.data_ptr(),
                   out.data_ptr(), rows, frames, run_length(frames),
                   mean_bits, lo, hi, cap,
                   torch.cuda.current_stream(pe.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"budget_scan launch failed: cudaError {rc}")
    launches += 1
    trace.count("budget.kernel")
    return out

