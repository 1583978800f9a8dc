"""Normative rate-distortion loop (reference components R9/R10, SURVEY.md §2).

The port's copy of the JAX package's `spec/rd.py`.

TPU-first redesign of the classic sequential two-loop search, implemented
here in NumPy as the normative definition (SURVEY.md §0/§7 step 2):

* inner (rate) loop  -> a *parallel two-stage gain sweep*: evaluate the
  exact frame bit cost at 32 coarse gains (step 8), pick the smallest
  fitting one, then refine over the 8 gains below it. Deterministic given
  the quantized values; no data-dependent iteration count.
* outer (distortion) loop -> fixed OUTER_MAX iterations; bands whose
  quantization noise exceeds the allowed (masking) threshold get their
  scale-factor exponent amplified by AMP_STEP quarter-steps, with per-band
  convergence masks instead of early exit.

The JAX mirror (mrcaudiocodec_tpu/ops/rd.py) runs the same fixed-bound
algorithm under jit/vmap, so both paths take identical decisions whenever
their float32 quantized values agree (BASELINE.json:5 "bit-exact bitstreams
for identical rate decisions").
"""
from __future__ import annotations

import numpy as np

from .. import config as C
from .. import tables as T
from . import entropy, quantize

F32 = np.float32

COARSE_GAINS = np.arange(C.GAIN_MIN, C.GAIN_MAX + 1, C.GAIN_COARSE_STEP,
                         dtype=np.int32)          # 32 candidates


def _bits_for_gains(x, amp, gains, lay, block_type):
    """Frame bit cost for each candidate gain. x:[1024], gains:[G]."""
    edges = lay["edges"][block_type]
    width = lay["width"][block_type]
    bin_band = lay["bin_band"][block_type]
    e_band = np.clip(gains[:, None] - amp[None, :], C.GAIN_MIN, C.GAIN_MAX)
    q = quantize.quantize(x[None, :], e_band[:, bin_band])      # [G, 1024]
    return entropy.frame_content_bits(q, np.broadcast_to(amp, (len(gains), len(amp))),
                                      edges, width), q


def inner_gain_search(x, amp, budget_content, lay, block_type):
    """Two-stage sweep -> (gain, q[1024], content_bits). Deterministic."""
    bits_c, _ = _bits_for_gains(x, amp, COARSE_GAINS, lay, block_type)
    fits = bits_c <= budget_content
    if fits.any():
        g0 = int(COARSE_GAINS[int(np.argmax(fits))])
    else:
        g0 = C.GAIN_MAX
    fine = np.arange(max(C.GAIN_MIN, g0 - C.GAIN_COARSE_STEP + 1), g0 + 1,
                     dtype=np.int32)
    bits_f, q_f = _bits_for_gains(x, amp, fine, lay, block_type)
    fits_f = bits_f <= budget_content
    if fits_f.any():
        i = int(np.argmax(fits_f))
    else:           # only possible in the g0 == GAIN_MAX corner
        i = len(fine) - 1
    return int(fine[i]), q_f[i], int(bits_f[i])


# Outer iterations 2+ re-search only a narrow window above the previous
# gain: amplification strictly increases bit cost at fixed gain, so the new
# best gain is >= the previous one, and one AMP_STEP outer move shifts it
# by only a few quarter-steps. GAIN_MAX is appended as a guaranteed-fit
# fallback so the budget contract is kept even in pathological frames.
REFINE_WINDOW = 15


def refine_gain_search(x, amp, budget_content, prev_gain, lay, block_type):
    """Windowed re-search -> (gain, q[1024], content_bits)."""
    cand = np.arange(prev_gain, min(prev_gain + REFINE_WINDOW, C.GAIN_MAX) + 1,
                     dtype=np.int32)
    if cand[-1] != C.GAIN_MAX:
        cand = np.concatenate([cand, [np.int32(C.GAIN_MAX)]])
    bits, q = _bits_for_gains(x, amp, cand, lay, block_type)
    fits = bits <= budget_content
    i = int(np.argmax(fits)) if fits.any() else len(cand) - 1
    return int(cand[i]), q[i], int(bits[i])


def _bits_for_gain_rows(x, amp, gains, lay, block_type):
    """Row-batched _bits_for_gains. x:[K,1024], amp:[K,NB], gains:[K,G]
    -> (bits[K,G] int64, q[K,G,1024] int32). Identical per-row arithmetic
    (quantize and the cost chain are elementwise / last-axis ops)."""
    edges = lay["edges"][block_type]
    width = lay["width"][block_type]
    bin_band = lay["bin_band"][block_type]
    e_band = np.clip(gains[:, :, None] - amp[:, None, :],
                     C.GAIN_MIN, C.GAIN_MAX)              # [K, G, NB]
    q = quantize.quantize(x[:, None, :], e_band[:, :, bin_band])
    amp_g = np.broadcast_to(amp[:, None, :], e_band.shape)
    return entropy.frame_content_bits(q, amp_g, edges, width), q


def _first_fit(cand, bits, budget_content):
    """Row-wise first fitting candidate -> (gain[K], q index i[K],
    bits[K]). No-fit fallback: the LAST column — g0 for the fine stage
    (only reachable in its g0 == GAIN_MAX corner, same as rd_frame) and
    the appended GAIN_MAX for the refine stage."""
    fits = bits <= budget_content[:, None]
    i = np.argmax(fits, axis=1)
    i = np.where(fits.any(axis=1), i, cand.shape[1] - 1)
    rows = np.arange(len(cand))
    return cand[rows, i].astype(np.int32), i, bits[rows, i]


# Memory bound for the batched sweeps: a slab evaluates [SLAB, G<=32, 1024]
# f32/int32 temporaries. Measured on a 2-core host the sweep is
# CACHE-bound — 8 rows (1 MB coarse temps) ran 1.24x realtime vs 0.92x at
# 96 rows and 0.68x at 192 — so the slab stays small; per-op NumPy overhead
# is already amortized at ~140k elements per op.
SLAB = 8


def _rd_slab(x, allowed, budget_bits, block_type, lay):
    """Batched rd_frame over one slab of same-family frames.

    Mirrors rd_frame decision-for-decision: the coarse sweep is shared;
    the fine window arange(max(0, g0-7), g0+1) and the refine window
    arange(prev, min(prev+15, 255)+1) + [255] are evaluated as fixed-width
    clipped candidate rows — clipping only duplicates edge candidates,
    and duplicates carry identical bit costs, so the first-fit selection
    picks the same gain (tests/test_spec_batching.py asserts equality)."""
    k = len(x)
    nb = lay["nb"]
    width = lay["width"][block_type]
    bin_band = lay["bin_band"][block_type]
    edges = lay["edges"][block_type]
    budget_content = (np.asarray(budget_bits, np.int64)
                      - C.FRAME_LEN_BITS - 7)
    amp = np.zeros((k, nb), dtype=np.int32)
    out_q = np.zeros((k, C.LONG_COEFFS), dtype=np.int32)
    out_amp = np.zeros((k, nb), dtype=np.int32)
    out_gain = np.zeros(k, dtype=np.int32)
    out_bits = np.zeros(k, dtype=np.int64)
    active = np.arange(k)
    gain = np.zeros(k, dtype=np.int32)
    for it in range(C.OUTER_MAX):
        xa = x[active]
        ampa = amp[active]
        bca = budget_content[active]
        if it == 0:
            cand_c = np.broadcast_to(COARSE_GAINS, (len(active),
                                                    len(COARSE_GAINS)))
            bits_c, _ = _bits_for_gain_rows(xa, ampa, cand_c, lay,
                                            block_type)
            fits_c = bits_c <= bca[:, None]
            g0 = np.where(fits_c.any(axis=1),
                          COARSE_GAINS[np.argmax(fits_c, axis=1)],
                          np.int32(C.GAIN_MAX)).astype(np.int32)
            # fine window arange(max(0, g0-7), g0+1): ascending, low end
            # clipped (duplicates); last column == g0 (the no-fit fallback
            # rd_frame uses in the g0 == GAIN_MAX corner)
            cand = np.clip(g0[:, None] + np.arange(-C.GAIN_COARSE_STEP + 1,
                                                   1)[None, :],
                           C.GAIN_MIN, C.GAIN_MAX).astype(np.int32)
        else:
            prev = gain[active]
            # refine window arange(prev, min(prev+15, 255)+1) + [255]
            cand = np.minimum(prev[:, None] + np.arange(REFINE_WINDOW + 1),
                              C.GAIN_MAX).astype(np.int32)
            cand = np.concatenate(
                [cand, np.full((len(active), 1), C.GAIN_MAX, np.int32)],
                axis=1)
        bits_m, q_m = _bits_for_gain_rows(xa, ampa, cand, lay, block_type)
        ga, i_sel, ba = _first_fit(cand, bits_m, bca)
        qa = q_m[np.arange(len(active)), i_sel]
        gain[active] = ga
        out_q[active] = qa
        out_amp[active] = ampa
        out_gain[active] = ga
        out_bits[active] = ba

        e_band = np.clip(ga[:, None] - ampa, C.GAIN_MIN, C.GAIN_MAX)
        xhat = quantize.dequantize(qa, e_band[:, bin_band])
        from .psycho import mdct_band_energy
        noise = mdct_band_energy(xa - xhat, edges)
        over = ((noise > allowed[active]) & (width > 0)
                & (ampa < C.AMP_MAX))
        if it == C.OUTER_MAX - 1:
            break
        still = over.any(axis=1)
        if not still.any():
            break
        upd = active[still]
        amp[upd] = np.minimum(
            amp[upd] + C.AMP_STEP * over[still].astype(np.int32), C.AMP_MAX)
        active = upd
    return out_q, out_amp, out_gain, out_bits


def rd_frames(coeffs, allowed, budgets, bt, fs: int):
    """Batched encode-side RD search (used by spec/codec.encode): frames
    grouped long-family vs SHORT (their layouts differ; all non-SHORT
    types share edges/width), processed in SLAB-sized row batches with
    per-row convergence compaction. Decision-identical to looping
    rd_frame per frame — same candidate sets, same first-fit selections,
    same outer-iteration exits."""
    lay = T.unified_layout(fs)
    bt = np.asarray(bt)
    nf = len(bt)
    q = np.zeros((nf, C.LONG_COEFFS), dtype=np.int32)
    amp = np.zeros((nf, lay["nb"]), dtype=np.int32)
    gain = np.zeros(nf, dtype=np.int32)
    bits = np.zeros(nf, dtype=np.int64)
    coeffs = np.asarray(coeffs, dtype=F32)
    allowed = np.asarray(allowed, dtype=F32)
    budgets = np.asarray(budgets, dtype=np.int64)
    for is_short in (False, True):
        sel = np.where((bt == C.SHORT) == is_short)[0]
        btype = C.SHORT if is_short else C.LONG
        for s in range(0, len(sel), SLAB):
            idx = sel[s:s + SLAB]
            r = _rd_slab(coeffs[idx], allowed[idx], budgets[idx], btype, lay)
            q[idx], amp[idx], gain[idx], bits[idx] = r
    return q, amp, gain, bits


def rd_frame(x, allowed, budget_bits: int, block_type: int, fs: int):
    """Encode-side RD search for one frame.

    x: [1024] float32 MDCT coefficients, allowed: [NB] permitted noise
    energy, budget_bits: total frame bit budget (including the length
    prefix and worst-case byte padding).

    Returns (q[1024] int32, amp[NB] int32, gain int, content_bits int).
    """
    lay = T.unified_layout(fs)
    edges = lay["edges"][block_type]
    width = lay["width"][block_type]
    bin_band = lay["bin_band"][block_type]
    budget_content = budget_bits - C.FRAME_LEN_BITS - 7
    amp = np.zeros(lay["nb"], dtype=np.int32)

    gain, q, bits = 0, None, 0
    for it in range(C.OUTER_MAX):
        if it == 0:
            gain, q, bits = inner_gain_search(x, amp, budget_content, lay,
                                              block_type)
        else:
            gain, q, bits = refine_gain_search(x, amp, budget_content, gain,
                                               lay, block_type)
        e_band = np.clip(gain - amp, C.GAIN_MIN, C.GAIN_MAX)
        xhat = quantize.dequantize(q, e_band[bin_band])
        # noise band energies via the shared pinned scan tree (rev 4)
        from .psycho import mdct_band_energy
        noise = mdct_band_energy((x.astype(F32) - xhat), edges)
        over = (noise > allowed) & (width > 0) & (amp < C.AMP_MAX)
        if it == C.OUTER_MAX - 1 or not over.any():
            break
        amp = np.minimum(amp + C.AMP_STEP * over.astype(np.int32), C.AMP_MAX)
    return q, amp, gain, bits
