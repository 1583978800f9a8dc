"""Normative bit-reservoir budget allocator (reference R11, SURVEY.md §2).

The port's copy of the JAX package's `spec/reservoir.py`.

TPU-first redesign (SURVEY.md §7 hard part d): instead of the classic
"actual-bits-used" feedback chain (which would serialize the whole RD loop
frame-by-frame), the reservoir operates on *pre-computable* per-frame
difficulty (quantized perceptual entropy). The per-frame budget then comes
from a pure scalar scan

    budget[f] = min(desired[f], mean + r[f])
    r[f+1]    = clip(r[f] + mean - desired[f], 0, cap)

whose transition is a clamped-add map — an associative monoid — so the JAX
path can evaluate it with `lax.associative_scan` and shard it across
devices with a tiny collective (SURVEY.md §2b N9). All quantities are
integers, so both paths agree bit-for-bit.
"""
from __future__ import annotations

import numpy as np

from .. import config as C

F32 = np.float32


def quantize_pe(pe: np.ndarray) -> np.ndarray:
    """float32 perceptual entropy -> int difficulty (floor, capped)."""
    pe = np.clip(np.asarray(pe, dtype=F32), 0.0, 65535.0)
    return np.floor(pe).astype(np.int64)


def desired_bits(pe_q: np.ndarray, mean_bits: int,
                 mean_pe: int | None = None) -> np.ndarray:
    """Integer desired bits per frame from quantized PE.

    desired = clip((mean_bits * pe_q) // mean_pe, lo, hi) with
    lo = floor(mean_bits * MIN_FRAME_FRAC), hi = floor(mean_bits *
    (1 + RESERVOIR_MAX_WITHDRAW)). Pure integer arithmetic (products stay
    below 2^31), so the JAX path reproduces it bit-for-bit on TPU where
    float division is not guaranteed correctly rounded.
    """
    if mean_pe is None:
        mean_pe = mean_pe_of(pe_q)
    lo = int(mean_bits * C.MIN_FRAME_FRAC)
    hi = int(mean_bits * (1.0 + C.RESERVOIR_MAX_WITHDRAW))
    return np.clip((mean_bits * pe_q) // mean_pe, lo, hi)


def mean_pe_of(pe_q: np.ndarray) -> int:
    """Mean quantized PE (int64-exact on host)."""
    return max(1, int(np.sum(pe_q)) // len(pe_q))


def allocate(pe: np.ndarray, cfg) -> np.ndarray:
    """[F] float32 PE -> [F] int64 per-frame bit budgets (per channel)."""
    f = len(pe)
    mean_bits = int(np.floor(cfg.mean_frame_bits))
    if not cfg.reservoir:
        return np.full(f, mean_bits, dtype=np.int64)
    cap = cfg.reservoir_cap
    desired = desired_bits(quantize_pe(pe), mean_bits)
    budget = np.zeros(f, dtype=np.int64)
    r = 0
    for i in range(f):
        budget[i] = min(desired[i], mean_bits + r)
        r = min(max(r + mean_bits - int(desired[i]), 0), cap)
    return budget
