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
"""
from __future__ import annotations

import torch

from .. import config as C

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


def mean_pe_exact(pe_q, nf=None):
    """max(1, floor(sum(pe_q) / nf)) along the last axis, exact in int64;
    nf is the axis length, or a [...] tensor of each row's frame count."""
    nf = pe_q.shape[-1] if nf is None else nf
    return torch.clamp(torch.div(pe_q.sum(-1), nf, rounding_mode="floor"),
                       min=1)


def desired_bits(pe_q, mean_bits: int, mean_pe):
    """clip((mean_bits * pe_q) // mean_pe, lo, hi), integer-exact."""
    lo = int(mean_bits * C.MIN_FRAME_FRAC)
    hi = int(mean_bits * (1.0 + C.RESERVOIR_MAX_WITHDRAW))
    d = torch.div(mean_bits * pe_q, mean_pe[..., None], rounding_mode="floor")
    return torch.clamp(d, lo, hi)


def budgets_scan(desired, mean_bits: int, cap: int):
    """[..., F] desired -> [..., F] budgets:
    budget[f] = min(desired[f], mean + r[f]) with
    r[f+1] = clip(r[f] + mean - desired[f], 0, cap), r[0] = 0."""
    a = mean_bits - desired
    a, lo, hi = scan_maps(a, torch.zeros_like(a), torch.full_like(a, cap))
    r_incl = torch.minimum(hi, torch.maximum(lo, a))     # maps applied to 0
    r = torch.cat([torch.zeros_like(r_incl[..., :1]), r_incl[..., :-1]], -1)
    return torch.minimum(desired, mean_bits + r)


def allocate(pe, cfg, nf_row=None):
    """[..., F] float32 PE (one reservoir chain per row) -> int64 budgets.

    nf_row ([...] ints) is each row's true frame count when rows are
    tail-padded to a shared F (the fused corpus batch): pad frames get
    pe_q = 0 and the mean PE divides by nf_row, so every real frame's
    budget equals that of the row encoded alone (pad frames come after the
    real ones and cannot reach them through the scan). Mirrors
    mrcaudiocodec_tpu/parallel/sharded.py's per-row mean."""
    mean_bits = int(cfg.mean_frame_bits)
    if not cfg.reservoir:
        return torch.full(pe.shape, mean_bits, dtype=I64, device=pe.device)
    pe_q = quantize_pe(pe)
    if nf_row is None:
        mean_pe = mean_pe_exact(pe_q)
    else:
        nf_row = torch.as_tensor(nf_row, dtype=I64, device=pe.device)
        frame = torch.arange(pe.shape[-1], device=pe.device)
        pe_q = torch.where(frame < nf_row[..., None], pe_q, 0)
        mean_pe = mean_pe_exact(pe_q, nf_row)
    desired = desired_bits(pe_q, mean_bits, mean_pe)
    return budgets_scan(desired, mean_bits, cfg.reservoir_cap)
