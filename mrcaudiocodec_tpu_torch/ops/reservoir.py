"""Bit-reservoir allocator in PyTorch (mirror of spec/reservoir.py).

The reservoir state transition r' = clip(r + a, lo, hi) is a clamped-add
map; such maps form a monoid under composition

    (a1,l1,h1) then (a2,l2,h2) = (a1+a2,
                                  min(h2, max(l2, l1+a2)),
                                  min(h2, max(l2, h1+a2)))

so the per-frame chain is an inclusive scan. PyTorch has no associative
scan, so this is a Hillis-Steele scan: log2(F) steps, each composing every
map with the one `d` frames before it. All arithmetic is int64 (PyTorch
has it on the card, unlike the TPU), so the clip-long mean-PE sum is
exact at any length the 32-bit header can express.

`allocate` runs that scan for a CPU tensor; on a card it launches K12
(`kernels/budget_scan.py`), which computes the same budgets in one
launch. The scan's pieces (`masked_pe`, `local_maps`, `carry_in`,
`budgets_from_prefix`) are also parallel/sharded.py's, whose carry
crosses shards of the frame axis.
"""
from __future__ import annotations

import torch

from .. import config as C
from .kernels import budget_scan

I64 = torch.int64


def _compose(f, g):
    """Compose clamped-add maps: apply f first, then g. Elementwise."""
    a1, l1, h1 = f
    a2, l2, h2 = g
    return (a1 + a2,
            torch.minimum(h2, torch.maximum(l2, l1 + a2)),
            torch.minimum(h2, torch.maximum(l2, h1 + a2)))


def scan_maps(a, lo, hi):
    """Inclusive Hillis-Steele scan of clamped-add maps along the last
    axis: element f becomes map_0 then map_1 ... then map_f."""
    n = a.shape[-1]
    d = 1
    while d < n:
        prev = (a[..., :-d], lo[..., :-d], hi[..., :-d])
        cur = (a[..., d:], lo[..., d:], hi[..., d:])
        na, nl, nh = _compose(prev, cur)
        a = torch.cat([a[..., :d], na], dim=-1)
        lo = torch.cat([lo[..., :d], nl], dim=-1)
        hi = torch.cat([hi[..., :d], nh], dim=-1)
        d *= 2
    return a, lo, hi


def quantize_pe(pe):
    """float32 perceptual entropy -> int64 difficulty (floor, capped)."""
    return torch.floor(torch.clamp(pe.to(torch.float32), 0.0, 65535.0)).to(I64)


def mean_pe_from_sum(total, nf):
    """max(1, floor(total / nf)), exact in int64: a row's mean PE from its
    (reduced) sum of pe_q and its frame count nf."""
    return torch.clamp(torch.div(total, nf, rounding_mode="floor"), min=1)


def mean_pe_exact(pe_q, nf=None):
    """max(1, floor(sum(pe_q) / nf)) along the last axis, exact in int64;
    nf is the axis length, or a [...] tensor of each row's frame count."""
    nf = pe_q.shape[-1] if nf is None else nf
    return mean_pe_from_sum(pe_q.sum(-1), nf)


def masked_pe(pe, nf_row=None, f0: int = 0):
    """[..., F] float32 PE of frames f0 .. f0+F-1 -> int64 pe_q with the
    frames at or past each row's true frame count nf_row ([...] ints; None:
    every frame counts) set to 0. Summed over the last axis this is a
    row's partial PE sum: the frame's global index decides, so a shard of
    the frame axis masks exactly the frames the whole row masks
    (mrcaudiocodec_tpu/parallel/sharded.py:113-114)."""
    pe_q = quantize_pe(pe)
    if nf_row is None:
        return pe_q
    nf_row = torch.as_tensor(nf_row, dtype=I64, device=pe.device)
    frame = f0 + torch.arange(pe.shape[-1], device=pe.device)
    return torch.where(frame < nf_row[..., None], pe_q, 0)


def desired_bounds(mean_bits: int) -> tuple[int, int]:
    """(lo, hi), the clamp of a frame's desired bits: floor(mean_bits *
    MIN_FRAME_FRAC) and floor(mean_bits * (1 + RESERVOIR_MAX_WITHDRAW))."""
    return (int(mean_bits * C.MIN_FRAME_FRAC),
            int(mean_bits * (1.0 + C.RESERVOIR_MAX_WITHDRAW)))


def desired_bits(pe_q, mean_bits: int, mean_pe):
    """clip((mean_bits * pe_q) // mean_pe, lo, hi), integer-exact."""
    lo, hi = desired_bounds(mean_bits)
    d = torch.div(mean_bits * pe_q, mean_pe[..., None], rounding_mode="floor")
    return torch.clamp(d, lo, hi)


INF = 1 << 40                       # the identity map's clamp bounds


def identity_maps(shape, device):
    """The identity clamped-add map (0, -INF, +INF), broadcast to shape."""
    return (torch.zeros(shape, dtype=I64, device=device),
            torch.full(shape, -INF, dtype=I64, device=device),
            torch.full(shape, INF, dtype=I64, device=device))


def apply_maps(maps, r):
    """Apply clamped-add maps (a, lo, hi) to reservoir levels r."""
    a, lo, hi = maps
    return torch.minimum(hi, torch.maximum(lo, r + a))


def local_maps(desired, mean_bits: int, cap: int):
    """[..., F] desired -> the inclusive scan of the frames' maps
    r -> clip(r + mean - desired, 0, cap): element f is the map from the
    level before frame 0 to the level after frame f. Its last column is
    the whole run's map (a shard's total)."""
    a = mean_bits - desired
    return scan_maps(a, torch.zeros_like(a), torch.full_like(a, cap))


def carry_in(totals, index: int):
    """[S, ...] x3 shard totals (a, lo, hi), in frame order -> [...] the
    reservoir level entering shard `index`: the maps of shards 0 ..
    index-1 composed in order, applied to 0
    (mrcaudiocodec_tpu/parallel/sharded.py:126-144)."""
    carry = identity_maps(totals[0].shape[1:], totals[0].device)
    for s in range(index):
        carry = _compose(carry, tuple(t[s] for t in totals))
    return apply_maps(carry, torch.zeros_like(carry[0]))


def budgets_from_prefix(desired, prefix, r_in, mean_bits: int):
    """[..., F] desired, its local_maps prefix and [...] entering levels
    r_in -> budgets: budget[f] = min(desired[f], mean + r[f]), r[f] the
    local exclusive prefix applied to r_in
    (mrcaudiocodec_tpu/parallel/sharded.py:145-153)."""
    ident = identity_maps(desired.shape[:-1] + (1,), desired.device)
    excl = tuple(torch.cat([i, p[..., :-1]], -1)
                 for i, p in zip(ident, prefix))
    r_in = torch.as_tensor(r_in, device=desired.device)
    r = apply_maps(excl, r_in[..., None])
    return torch.minimum(desired, mean_bits + r)


def budgets_scan(desired, mean_bits: int, cap: int):
    """[..., F] desired -> [..., F] budgets:
    budget[f] = min(desired[f], mean + r[f]) with
    r[f+1] = clip(r[f] + mean - desired[f], 0, cap), r[0] = 0."""
    r0 = torch.zeros(desired.shape[:-1], dtype=I64, device=desired.device)
    return budgets_from_prefix(desired, local_maps(desired, mean_bits, cap),
                               r0, mean_bits)


def allocate(pe, cfg, nf_row=None):
    """[..., F] float32 PE (one reservoir chain per row) -> int64 budgets.

    nf_row ([...] ints) is each row's true frame count when rows are
    tail-padded to a shared F (the fused corpus batch): pad frames get
    pe_q = 0 and the mean PE divides by nf_row, so every real frame's
    budget equals that of the row encoded alone (pad frames come after the
    real ones and cannot reach them through the scan). Mirrors
    mrcaudiocodec_tpu/parallel/sharded.py's per-row mean; parallel/
    sharded.py runs the same pieces with the sum and the carry taken
    across shards of the frame axis.

    A card's tensors take K12 (one launch, no read back); a CPU tensor
    takes the torch scan; any other device raises."""
    mean_bits = int(cfg.mean_frame_bits)
    if not cfg.reservoir:
        return torch.full(pe.shape, mean_bits, dtype=I64, device=pe.device)
    if pe.is_cuda:
        nf = None if nf_row is None else torch.as_tensor(
            nf_row, dtype=I64, device=pe.device).reshape(-1).contiguous()
        return budget_scan.budget_scan_kernel(
            pe.to(torch.float32).reshape(-1, pe.shape[-1]).contiguous(), nf,
            mean_bits, *desired_bounds(mean_bits),
            cfg.reservoir_cap).view(pe.shape)
    if pe.device.type != "cpu":
        raise ValueError(f"no budget scan for device {pe.device}")
    return allocate_scan(pe, cfg, nf_row)


def allocate_scan(pe, cfg, nf_row=None):
    """`allocate` with the reservoir on, as the torch scan on pe's device:
    the CPU path, and on a card the path K12 replaced (timed beside it)."""
    mean_bits = int(cfg.mean_frame_bits)
    pe_q = masked_pe(pe, nf_row)
    nf = pe.shape[-1] if nf_row is None else torch.as_tensor(
        nf_row, dtype=I64, device=pe.device)
    mean_pe = mean_pe_from_sum(pe_q.sum(-1), nf)
    desired = desired_bits(pe_q, mean_bits, mean_pe)
    return budgets_scan(desired, mean_bits, cfg.reservoir_cap)
