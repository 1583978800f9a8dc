"""Batched rate-distortion loop in PyTorch (mirror of spec/rd.py).

Vectorized over frames like the JAX package's ops/rd.py. Iteration 1 is
the inner sweep, a two-stage gain search ([F, 32] coarse + [F, 8] fine
exact bit costs), each stage one call of the quantization-cost kernel K2
(ops/kernels/quant_cost.py) on the card. Iterations 2+ are the outer
distortion loop from the first over-mask on, `rd_loop`: on the card one
launch of K4 (ops/kernels/rd_loop.py), which runs the whole loop a frame a
block, each frame to its own exit; for CPU tensors its plain version
`rd_loop_plain`. There the JAX `lax.while_loop`s become Python loops that
exit early when `.any()` says every frame is done; each such test is a
host sync, counted as `host_syncs.rd_exit` (`trace.counters()`).
Converged frames are fixed points of the loop body, so the early exits,
the batch's and a frame's own, are decision-identical to the spec's
fixed bound.
"""
from __future__ import annotations

import torch

from .. import config as C
from .. import trace, xpsy
from . import entropy, quantize
from .kernels import quant_cost
from .kernels import rd_loop as rd_loop_k
from .psycho import band_energy, unified_band_edges

I32 = torch.int32
REFINE_WINDOW = 15        # spec/rd.py: candidates [prev, prev + 15] + GAIN_MAX
REFINE_BLOCK = 4
N_REFINE_BLOCKS = (REFINE_WINDOW + 1) // REFINE_BLOCK


def _sync_any(t) -> bool:
    trace.count("host_syncs.rd_exit")
    return bool(t.any())


def _e_bin_for(gain, amp_bin):
    """gain [F], amp_bin [F, 1024] -> e_bin [F, 1024] = clip(gain - amp)."""
    return torch.clamp(gain[:, None] - amp_bin, C.GAIN_MIN, C.GAIN_MAX)


def bits_for_gains(x, amp, gains, bt, fs: int, amp_bin):
    """-> bits [F, G] int32: exact frame content cost per gain candidate."""
    payload = quant_cost.payload_bits(x, amp_bin, gains.contiguous(), bt, fs)
    return payload + entropy.fixed_and_sf_bits(amp, bt, fs)[:, None]


def _pick_first_fit(cand, bits_c, budget_content):
    """Lowest-index fitting candidate (last candidate as fallback)."""
    fits = bits_c <= budget_content[:, None]
    idx = torch.where(fits.any(dim=1), fits.to(I32).argmax(dim=1),
                      cand.shape[1] - 1)
    return (cand.gather(1, idx[:, None])[:, 0],
            bits_c.gather(1, idx[:, None])[:, 0])


def inner_gain_search(x, amp, budget_content, bt, fs: int, amp_bin):
    """Two-stage sweep -> (gain [F], bits [F]); the loop quantizes at the
    chosen gain itself."""
    nf = x.shape[0]
    coarse = torch.arange(C.GAIN_MIN, C.GAIN_MAX + 1, C.GAIN_COARSE_STEP,
                          dtype=I32, device=x.device).expand(nf, -1)
    bits_c = bits_for_gains(x, amp, coarse, bt, fs, amp_bin)
    fits = bits_c <= budget_content[:, None]
    g0 = torch.where(fits.any(dim=1),
                     fits.to(I32).argmax(dim=1).to(I32) * C.GAIN_COARSE_STEP
                     + C.GAIN_MIN, C.GAIN_MAX).to(I32)
    steps = torch.arange(-C.GAIN_COARSE_STEP + 1, 1, dtype=I32,
                         device=x.device)
    fine = torch.clamp(g0[:, None] + steps, C.GAIN_MIN, C.GAIN_MAX)
    bits_f = bits_for_gains(x, amp, fine, bt, fs, amp_bin)
    return _pick_first_fit(fine, bits_f, budget_content)


def refine_gain_search(x, amp, budget_content, prev_gain, bt, fs: int,
                       amp_bin):
    """Windowed re-search for outer iterations 2+ (decision-identical to
    spec.rd.refine_gain_search): the window [prev, prev+15] is evaluated
    in ascending blocks of REFINE_BLOCK candidates, stopping once every
    frame holds its first fit; frames with no fit take GAIN_MAX.
    -> (gain, q, bits, evals [F]: the candidates a frame's own search
    evaluates, REFINE_BLOCK a block up to its first fit, +1 for the
    fallback)."""
    nf = x.shape[0]
    arange_b = torch.arange(REFINE_BLOCK, dtype=I32, device=x.device)
    found = torch.zeros(nf, dtype=torch.bool, device=x.device)
    gain = torch.zeros(nf, dtype=I32, device=x.device)
    bits = torch.zeros(nf, dtype=I32, device=x.device)
    evals = torch.zeros(nf, dtype=I32, device=x.device)
    for b in range(N_REFINE_BLOCKS):
        if b and not _sync_any(~found):
            break
        evals += REFINE_BLOCK * (~found).to(I32)
        cand = torch.clamp(prev_gain[:, None] + b * REFINE_BLOCK + arange_b,
                           max=C.GAIN_MAX)
        bits_c = bits_for_gains(x, amp, cand, bt, fs, amp_bin)
        fits = bits_c <= budget_content[:, None]
        idx = fits.to(I32).argmax(dim=1)[:, None]
        new = fits.any(dim=1) & ~found
        gain = torch.where(new, cand.gather(1, idx)[:, 0], gain)
        bits = torch.where(new, bits_c.gather(1, idx)[:, 0], bits)
        found = found | new
    if _sync_any(~found):
        gmax = torch.full((nf, 1), C.GAIN_MAX, dtype=I32, device=x.device)
        bits_m = bits_for_gains(x, amp, gmax, bt, fs, amp_bin)[:, 0]
        gain = torch.where(found, gain, C.GAIN_MAX)
        bits = torch.where(found, bits, bits_m)
        evals += (~found).to(I32)
    q = quantize.quantize(x, _e_bin_for(gain, amp_bin))
    return gain, q, bits, evals


def scan_stages(fs: int, is_short: bool) -> int:
    """Stages of the pinned segmented scan over one family's band edges
    (shifts 1, 2, 4, ... below its widest band)."""
    le, se = unified_band_edges(fs)
    return len(xpsy._seg_tables_from_edges(se if is_short else le)[0])


def rd_loop_plain(x, allowed, budget_content, bt, gain0, bits0, fs: int):
    """Plain PyTorch version of K4: the outer distortion loop from the
    inner sweep's (gain0, bits0) with amp = 0.

    x [F, 1024] f32, allowed [F, NB] f32, budget_content [F] i32, bt [F]
    i32, gain0 [F] i32, bits0 [F] i32 -> (q [F,1024] i32, amp [F,NB] i32,
    gain [F] i32, bits [F] i32)."""
    return _rd_loop(x, allowed, budget_content, bt, gain0, bits0, fs, None)


def loop_counts(x, allowed, budget_content, bt, gain0, bits0,
                fs: int) -> dict:
    """What each frame's own loop does on these inputs, as [F] int32
    tensors: "outer" (refine iterations), "cands" (candidate payloads
    evaluated), "fallbacks" (iterations that took GAIN_MAX for want of a
    fit) and "over_masks" (1 + outer). K4's bound counts its work from
    them (profiling.kernel_bound); the tests, the corners reached."""
    stats = {}
    _rd_loop(x, allowed, budget_content, bt, gain0, bits0, fs, stats)
    return stats


def _rd_loop(x, allowed, budget_content, bt, gain0, bits0, fs: int, stats):
    tb = entropy.dev_tables(fs, str(x.device))
    width = tb["width"][bt.long()]
    nf, nb = x.shape[0], tb["nb"]
    is_short = (bt == C.SHORT)[:, None]
    le, se = unified_band_edges(fs)

    def over_mask(gain, q, amp, amp_bin):
        xhat = quantize.dequantize(q, _e_bin_for(gain, amp_bin))
        d = x - xhat
        noise = torch.where(is_short, band_energy(d, se), band_energy(d, le))
        return (noise > allowed) & (width > 0) & (amp < C.AMP_MAX)

    amp = torch.zeros((nf, nb), dtype=I32, device=x.device)
    amp_bin = torch.zeros((nf, C.LONG_COEFFS), dtype=I32, device=x.device)
    gain, bits = gain0, bits0
    q = quantize.quantize(x, _e_bin_for(gain, amp_bin))
    over = over_mask(gain, q, amp, amp_bin)
    outer = torch.zeros(nf, dtype=I32, device=x.device)
    cands = torch.zeros_like(outer)
    fallbacks = torch.zeros_like(outer)
    for _ in range(1, C.OUTER_MAX):
        if not _sync_any(over):
            break
        active = over.any(dim=1)
        amp = torch.clamp(amp + C.AMP_STEP * over.to(I32), max=C.AMP_MAX)
        amp_bin = entropy.amp_to_bins(amp, bt, fs).contiguous()
        gain, q, bits, evals = refine_gain_search(
            x, amp, budget_content, gain, bt, fs, amp_bin)
        over = over_mask(gain, q, amp, amp_bin)
        outer += active.to(I32)
        cands += torch.where(active, evals, 0)
        fallbacks += (active & (evals > N_REFINE_BLOCKS * REFINE_BLOCK)
                      ).to(I32)
    if stats is not None:
        stats.update(outer=outer, cands=cands, fallbacks=fallbacks,
                     over_masks=outer + 1)
    return q, amp, gain, bits


def rd_loop(x, allowed, budget_content, bt, gain0, bits0, fs: int):
    """The outer loop as `rd_loop_plain` gives it: K4 on the card, the
    plain version for CPU tensors, an error for anything else."""
    if x.is_cuda:
        return rd_loop_k.rd_loop_kernel(x, allowed, budget_content, bt,
                                        gain0, bits0, fs)
    if x.device.type == "cpu":
        return rd_loop_plain(x, allowed, budget_content, bt, gain0, bits0,
                             fs)
    raise ValueError(f"no RD loop for device {x.device}")


def rd_batch(coeffs, allowed, budgets, bt, fs: int):
    """Batched RD search: the inner sweep (K2), then `rd_loop` (K4).

    coeffs [F, 1024] f32, allowed [F, NB] f32, budgets [F] int, bt [F].
    Returns (q [F,1024] i32, amp [F,NB] i32, gain [F] i32, bits [F] i32).
    """
    nb = entropy.dev_tables(fs, str(coeffs.device))["nb"]
    bt = bt.to(I32).contiguous()
    budget_content = (budgets - C.FRAME_LEN_BITS - 7).to(I32).contiguous()
    nf = coeffs.shape[0]
    x = coeffs.to(torch.float32).contiguous()
    amp = torch.zeros((nf, nb), dtype=I32, device=x.device)
    amp_bin = torch.zeros((nf, C.LONG_COEFFS), dtype=I32, device=x.device)
    gain, bits = inner_gain_search(x, amp, budget_content, bt, fs, amp_bin)
    return rd_loop(x, allowed.to(torch.float32).contiguous(), budget_content,
                   bt, gain.contiguous(), bits.contiguous(), fs)
