"""The host side of the port's two CUDA kernels, checked on the CPU.

K1 (csrc/fft_stages.cu): its compact twiddle table against the tiled
tables of the roll-form FFT, and a numpy model of its schedule (which
thread holds which 8 points in each stage group, the skewed shared-memory
addresses, the ping-pong exchange, the bit-reversed read and the coalesced
store). The model mirrors the kernel's Shape/Group constants and
`group_base`; run through the ops of `xmath.fft_dif_stages`, it must
reproduce `fft_plain` bitwise. K2 (csrc/quant_cost.cu): its band map of
tuple ranges against `unified_layout(fs)["bin_band"]`, its pair tables
against the code tables, a numpy model of its warp schedule (each lane's
runs of tuples, the segmented scan over the lanes) against
`payload_bits_plain`, and the 16-byte alignment check of its wrapper.
K3 (csrc/record_pack.cu): which lane owns which pairs, bins and bands, a
model of its lane runs (whole-word stores inside a run, ORs on its two
edge words) against `pack_records_plain`'s bytes, a model of its
decoupled look-back (tiles taken in order by a bounded number of resident
blocks, finishing in random orders) against an exclusive cumsum, and its
warps per block against the shared memory a block may use. K4
(csrc/rd_loop.cu): `k4_model` runs its schedule one frame at a time (the
band facts and warp regions the kernel derives from
`quant_cost.band_tuples`, 4 candidates a step in ascending order, each
warp's kept magnitudes, the first fit of the first block with one, the
fallback in one warp, the over-mask on the winner's magnitudes with
|q|^(4/3) from the table and the region scan, the frame's own exit) and
must equal `rd_batch` on every corner set of tests/test_torch_rd_loop.py
at three rates, so the per-frame exit is the batch's; the region scan
(in place, a float4 a tuple, chunks from the top down) equals
`xpsy.seg_scan` bit for bit on every band table and on tables the layouts
lack; the table equals the port's, the JAX package's and the spec's
dequantize; its constants against the format's and `rd_loop.consts()`,
its static shared memory and residency; and `build.stale`, which follows
the csrc/*.cuh headers a source includes.
"""
import os
import re

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu import tables as JT
from mrcaudiocodec_tpu import xmath as jxmath

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch import xmath
from mrcaudiocodec_tpu_torch.ops import device_pack
from mrcaudiocodec_tpu_torch.ops.kernels import (build, fft_stages,
                                                 quant_cost, rd_loop,
                                                 record_pack)

# ---------------------------------------------------------------------------
# K1: the schedule, as csrc/fft_stages.cu computes it
# ---------------------------------------------------------------------------

THREADS = 128                       # kThreads


def shape(L):
    """Shape<L>: (N, threads per FFT, FFTs per block, SKEW, STRIDE,
    stage groups)."""
    n = 1 << L
    tpf = n // 8
    skew = 5 if L >= 9 else 3
    return n, tpf, THREADS // tpf, skew, n + (n >> skew), (L + 2) // 3


def group(L, g):
    """Group<L, G>: (first stage bit, stages, owned bits O..O-2 as (O, LO),
    bits above O)."""
    top = L - 1 - 3 * g
    o = max(top, 2)
    return top, min(3, L - 3 * g), o, o - 2, L - 1 - o


def bitrev(v, bits):
    v = np.asarray(v)
    r = np.zeros_like(v)
    for i in range(bits):
        r |= ((v >> i) & 1) << (bits - 1 - i)
    return r


def points(L, g, t):
    """[threads, 8] point index of thread t's k-th point in group g."""
    top, _, o, lo, nh = group(L, g)
    base = t & ((1 << lo) - 1)
    if nh:
        base = base | (bitrev(t >> lo, nh) << (o + 1))
    return base[:, None] | (np.arange(8) << lo)[None, :]


def skewed(L, p):
    return p + (p >> shape(L)[3])


def run_model(zr, zi):
    """The kernel's schedule on [F, N] f32 tensors with the ops of
    xmath.fft_dif_stages -> natural-order (re, im). Asserts on the way
    that every butterfly runs once, after both its operands' previous
    stage, and that each exchange reads back what the last one wrote."""
    n = zr.shape[-1]
    L = n.bit_length() - 1
    _, tpf, _, _, stride, groups = shape(L)
    t = np.arange(tpf)
    tab = torch.from_numpy(fft_stages.compact_twiddles(n))
    twr, twi = tab[:, 0], tab[:, 1]
    done = np.zeros(n, np.int64)              # stages applied to each point
    pairs = set()
    first = points(L, 0, t)
    assert np.array_equal(first, t[:, None] + np.arange(8) * tpf)
    xr, xi = zr[:, first].clone(), zi[:, first].clone()      # [F, tpf, 8]
    bufs = [[torch.zeros(zr.shape[0], stride) for _ in range(2)]
            for _ in range(2)]
    holder = [np.full(stride, -1), np.full(stride, -1)]
    for g in range(groups):
        top, stages, o, lo, _ = group(L, g)
        pts = points(L, g, t)
        assert sorted(pts.ravel()) == list(range(n))      # one owner each
        addr = skewed(L, pts)
        # the kernel's per-group address plus a constant offset of k
        k_lo = np.arange(8) << lo
        assert np.array_equal(addr, skewed(L, pts[:, :1]) + skewed(L, k_lo))
        if g:
            src = (g - 1) & 1
            assert np.array_equal(holder[src][addr], pts)
            xr, xi = bufs[src][0][:, addr], bufs[src][1][:, addr]
        for s in range(stages):
            b = top - s
            lb = b - lo
            for k in range(8):
                if k >> lb & 1:
                    continue
                c = k | (1 << lb)
                a_pt, c_pt = pts[:, k], pts[:, c]
                assert np.array_equal(c_pt, a_pt + (1 << b))
                stage = L - 1 - b
                assert (done[a_pt] == stage).all() and (done[c_pt] == stage).all()
                done[a_pt] += 1
                done[c_pt] += 1
                pairs.update((stage, int(p)) for p in a_pt)
                mask = (1 << b) - 1
                w = n - (2 << b) + (a_pt & mask)
                assert np.array_equal(w, n - (2 << b) + (pts[:, 0] & mask)
                                      + ((k << lo) & mask))
                ar, ai, br, bi = xr[..., k], xi[..., k], xr[..., c], xi[..., c]
                top_r, top_i = ar + br, ai + bi
                bot_r, bot_i = xmath._cmul(ar - br, ai - bi, twr[w], twi[w])
                xr[..., k], xi[..., k] = top_r, top_i
                xr[..., c], xi[..., c] = bot_r, bot_i
        if g < groups - 1:
            dst = g & 1
            bufs[dst][0][:, addr], bufs[dst][1][:, addr] = xr, xi
            holder[dst][addr] = pts
    assert (done == L).all()
    every = {(L - 1 - b, int(p)) for b in range(L) for p in range(n)
             if not p >> b & 1}
    assert pairs == every
    # the store: thread t's point bitrev(t)*8 + k is natural position
    # bitrev3(k)*N/8 + t
    last = points(L, groups - 1, t)
    store = bitrev(np.arange(8), 3)[None, :] * tpf + t[:, None]
    assert np.array_equal(bitrev(last, L), store)
    out_r, out_i = torch.empty_like(zr), torch.empty_like(zi)
    out_r[:, store], out_i[:, store] = xr, xi
    return out_r, out_i


def bank_degree(L, g):
    """Most lanes of one warp on one bank in group g's shared access (the
    write after it and the read before it use the same addresses)."""
    n, tpf, fpb, _, stride, _ = shape(L)
    tid = np.arange(THREADS)
    f, t = tid // tpf, tid % tpf
    addr = f[:, None] * stride + skewed(L, points(L, g, t))  # [THREADS, 8]
    assert len(np.unique(addr)) == addr.size and addr.max() < fpb * stride
    banks = (addr % 32).reshape(THREADS // 32, 32, 8)
    return max(np.bincount(banks[w, :, k], minlength=32).max()
               for w in range(THREADS // 32) for k in range(8))


def _bits(a):
    return a.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", fft_stages.FFT_SIZES)
def test_compact_twiddles_match_tiled_tables(n):
    tab = fft_stages.compact_twiddles(n)
    assert tab.shape == (n - 1, 2) and tab.dtype == np.float32
    twr, twi = tab[:, 0], tab[:, 1]
    for mask, tr, ti, half in xmath._dif_tables(n):
        m = 2 * half
        b = np.flatnonzero(~mask)                  # every butterfly's b
        idx = n - m + (b % m) - half
        assert np.array_equal(twr[idx].view(np.int32), tr[b].view(np.int32))
        assert np.array_equal(twi[idx].view(np.int32), ti[b].view(np.int32))
    # the j = 0 twiddle of every stage is (1, -0), kept as it is
    j0 = [n - (n >> s) for s in range(n.bit_length() - 1)]
    assert (twr[j0] == 1).all() and np.signbit(twi[j0]).all()


@pytest.mark.parametrize("n", fft_stages.FFT_SIZES)
def test_k1_schedule_model_matches_fft_plain(n):
    rng = np.random.default_rng(n + 1)
    rows = 12
    zr = rng.standard_normal((rows, n)).astype(np.float32)
    zi = rng.standard_normal((rows, n)).astype(np.float32)
    zr[0], zi[0] = 0.0, 0.0                             # all +0.0
    zr[1], zi[1] = -0.0, -0.0                           # all -0.0
    signs = rng.integers(0, 2, (2, n)).astype(bool)
    zr[2] = np.where(signs[0], -0.0, 0.0)               # mixed signed zeros
    zi[2] = np.where(signs[1], -0.0, 0.0)
    sub = np.float32(2.0 ** -140) * rng.integers(-64, 65, (2, 2, n))
    zr[3:5], zi[3:5] = sub                              # subnormals
    some = rng.random((rows, n)) < 0.2
    zr[5:] = np.where(some[5:], -0.0, zr[5:])
    zi[5:] = np.where(some[5:], np.float32(-1e-40), zi[5:])
    assert (np.abs(zr[3:5]) < np.finfo(np.float32).tiny).all()
    zr_t, zi_t = torch.from_numpy(zr), torch.from_numpy(zi)
    mr, mi = run_model(zr_t, zi_t)
    pr, pi = fft_stages.fft_plain(zr_t, zi_t)
    assert torch.equal(_bits(mr), _bits(pr))
    assert torch.equal(_bits(mi), _bits(pi))
    ar, ai = jxmath.fft_dif(zr, zi, np)                 # the JAX package's
    np.testing.assert_array_equal(_bits(mr).numpy(), ar.view(np.int32))
    np.testing.assert_array_equal(_bits(mi).numpy(), ai.view(np.int32))


# most lanes on one bank per stage group, as the .cu's design note says
BANK_DEGREE = {1024: [1, 1, 1, 1], 512: [1, 2, 1], 128: [2, 1, 1],
               64: [1, 1]}


@pytest.mark.parametrize("n", fft_stages.FFT_SIZES)
def test_k1_shared_memory_banks(n):
    L = n.bit_length() - 1
    got = [bank_degree(L, g) for g in range(shape(L)[5])]
    assert got == BANK_DEGREE[n]
    assert got[-1] == 1                          # the bit-reversed read
    # without the skew the bit-reversed read of N=1024 is one bank
    t = np.arange(32)
    assert len(np.unique(points(10, 3, t)[:, 0] % 32)) == 1


# ---------------------------------------------------------------------------
# K2: the band map and the alignment check
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k2_band_map_reproduces_bin_band(fs):
    lay = T.unified_layout(fs)
    jlay = JT.unified_layout(fs)
    tup = quant_cost.band_tuples(fs)
    nb = lay["nb"]
    assert tup.shape == (C.N_BLOCK_TYPES, nb + 1) and tup.dtype == np.int32
    assert nb <= 128
    for bt in range(C.N_BLOCK_TYPES):
        e = tup[bt]
        assert e[0] == 0 and e[-1] == C.LONG_COEFFS // 4
        assert (np.diff(e) >= 0).all()
        tuple_band = np.repeat(np.arange(nb), np.diff(e))       # [256]
        per_bin = np.repeat(tuple_band, 4)
        np.testing.assert_array_equal(per_bin, lay["bin_band"][bt])
        np.testing.assert_array_equal(per_bin, jlay["bin_band"][bt])
        # no tuple across a band edge: all four bins of a tuple in its band
        quads = lay["bin_band"][bt].reshape(-1, 4)
        assert (quads == quads[:, :1]).all()
    # SHORT follows the group-major layout: the 8 groups' bands in turn
    short = tup[C.SHORT]
    nbs = lay["nb_short"]
    for g in range(C.N_SHORT):
        assert short[g * nbs] == g * C.SHORT_COEFFS // 4


def k2_tuple_values(x, amp_bin, gains):
    """[4, F, G, 256] int64: each 4-tuple's CB_SMALL length, CB_MID and
    CB_ESC lengths (with sign and escape bits) and flags (mag > 0, > 1, > 4
    as bits 0-2), from the plain quantizer."""
    from mrcaudiocodec_tpu_torch.ops import quantize
    ca = T.code_arrays()
    e = torch.clamp(gains[:, :, None] - amp_bin[:, None, :], 0, 255)
    q = quantize.quantize(x[:, None, :], e).numpy().astype(np.int64)
    mag = np.abs(q)
    c = (np.clip(q, -1, 1) + 1).reshape(q.shape[:-1] + (256, 4))
    small = ca["len_small"][((c[..., 0] * 3 + c[..., 1]) * 3 + c[..., 2]) * 3
                            + c[..., 3]]
    c2 = (np.clip(q, -4, 4) + 4).reshape(q.shape[:-1] + (512, 2))
    mid = ca["len_mid"][c2[..., 0] * 9 + c2[..., 1]].reshape(
        small.shape + (2,)).sum(-1)
    m2 = np.minimum(mag, 16).reshape(q.shape[:-1] + (512, 2))
    per_bin = (mag > 0) + T.escape_len(mag)
    esc = (ca["len_esc"][m2[..., 0] * 17 + m2[..., 1]].reshape(
        small.shape + (2,)).sum(-1)
        + per_bin.reshape(small.shape + (4,)).sum(-1))
    top = mag.reshape(small.shape + (4,)).max(-1)
    flags = (top > 0) | ((top > 1) << 1) | ((top > 4) << 2)
    return np.stack([small, mid, esc, flags]).astype(np.int64)


def k2_pair_tuple_values(x, amp_bin, gains):
    """The kernel's way to the same [4, F, G, 256] values: each pair's
    signed magnitudes clamped to [-16, 16] looked up in quant_cost's pair
    tables, plus the escape suffix of each magnitude >= 16."""
    from mrcaudiocodec_tpu_torch.ops import quantize
    em_tab, sf_tab = quant_cost.pair_tables()
    small_tab = T.code_arrays()["len_small"]
    e = torch.clamp(gains[:, :, None] - amp_bin[:, None, :], 0, 255)
    q = quantize.quantize(x[:, None, :], e).numpy().astype(np.int64)
    v = (np.clip(q, -16, 16) + 16).reshape(q.shape[:-1] + (256, 2, 2))
    idx = v[..., 0] * 33 + v[..., 1]                      # [F, G, 256, 2]
    em = em_tab[idx].sum(-1) + T.escape_len(np.abs(q)).reshape(
        q.shape[:-1] + (256, 4)).sum(-1)
    sf = sf_tab[idx]
    small = small_tab[(sf[..., 0] & 15) * 9 + (sf[..., 1] & 15)]
    flags = (sf[..., 0] | sf[..., 1]) >> 4
    return np.stack([small, em >> 16, em & 0xFFFF, flags]).astype(np.int64)


def k2_band_cost(s):
    small, mid, esc, fl = s
    cost = np.where(((fl & 4) == 0) & (mid < esc), mid, esc)
    cost = np.where(((fl & 2) == 0) & (small < cost), small, cost)
    return np.where(fl & 1, cost, 0)


def k2_join(a, b):
    return np.concatenate([a[:3] + b[:3], a[3:] | b[3:]])


def k2_model(vals, bt, fs):
    """csrc/quant_cost.cu's warp schedule on tuple values [4, F, G, 256]:
    lane l's runs over tuples 8l .. 8l+7, whole bands inside a lane, the
    segmented scan of the tails over the lanes, the heads' carries."""
    tup = quant_cost.band_tuples(fs)
    nb = T.unified_layout(fs)["nb"]
    out = np.zeros(vals.shape[1:3], np.int64)
    zero = np.zeros((4, vals.shape[2]), np.int64)
    for f in range(vals.shape[1]):
        band = np.repeat(np.arange(nb), np.diff(tup[bt[f]]))
        tail_band = band[8 * np.arange(32) + 7]
        tails, heads, firsts, costs = [], [], [], []
        for lane in range(32):
            mine = band[8 * lane:8 * lane + 8]
            run, head, first, cost = zero, zero, True, 0
            for s in range(8):
                run = k2_join(run, vals[:, f, :, 8 * lane + s])
                if s < 7:
                    end = mine[s + 1] != mine[s]
                    if end and not first:
                        cost = cost + k2_band_cost(run)
                    if end and first:
                        head = run
                    first = first and not end
                    run = zero if end else run
            tails.append(run)
            heads.append(head)
            firsts.append(first)
            costs.append(cost)
        for r in range(5):
            d = 1 << r
            tails = [k2_join(tails[lane], tails[lane - d])
                     if lane >= d and tail_band[lane - d] == tail_band[lane]
                     else tails[lane] for lane in range(32)]
        for lane in range(32):
            cont_in = lane > 0 and band[8 * lane - 1] == band[8 * lane]
            cont_out = lane < 31 and band[8 * lane + 8] == band[8 * lane + 7]
            if not firsts[lane]:
                carry = tails[lane - 1] if cont_in else zero
                costs[lane] = costs[lane] + k2_band_cost(
                    k2_join(heads[lane], carry))
            if not cont_out:
                costs[lane] = costs[lane] + k2_band_cost(tails[lane])
        out[f] = sum(costs)
    return out


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k2_lane_schedule_model_matches_plain(fs):
    rng = np.random.default_rng(fs // 100)
    nf, g = 10, 3
    nb = T.unified_layout(fs)["nb"]
    x = (rng.standard_normal((nf, C.LONG_COEFFS))
         * 10.0 ** rng.uniform(-3, 2.5, (nf, 1))).astype(np.float32)
    x[0] = 0.0
    bt = (np.arange(nf) % C.N_BLOCK_TYPES).astype(np.int32)
    amp = rng.integers(0, C.AMP_MAX + 1, (nf, nb)).astype(np.int32)
    amp_bin = np.take_along_axis(amp, T.unified_layout(fs)["bin_band"][bt], 1)
    gains = rng.integers(0, 256, (nf, g)).astype(np.int32)
    xt, at, gt, bt_t = (torch.from_numpy(np.ascontiguousarray(v))
                        for v in (x, amp_bin, gains, bt))
    want = quant_cost.payload_bits_plain(xt, at, gt, bt_t, fs).numpy()
    vals = k2_pair_tuple_values(xt, at, gt)
    np.testing.assert_array_equal(vals, k2_tuple_values(xt, at, gt))
    got = k2_model(vals, bt, fs)
    np.testing.assert_array_equal(got, want)


def test_k2_pair_tables_cover_every_magnitude():
    """Tuples with every magnitude 0..QMAX and both signs: the pair-table
    values equal the code tables' per-tuple values, and a band's esc and
    mid sums fit the 16-bit halves of one word."""
    rng = np.random.default_rng(5)
    nf = 8
    amp_bin = np.zeros((nf, C.LONG_COEFFS), np.int32)
    gains = np.full((nf, 2), 128, np.int32)          # e = 128: step 1
    mags = np.concatenate([np.arange(0, 40), rng.integers(0, C.QMAX + 1,
                                                          nf * 1024 - 40)])
    # the magnitude m needs a with floor(a^(3/4) + magic) = m: take a in
    # the middle of its interval
    a = np.maximum(mags - 0.4054 + 0.5, 0) ** (4.0 / 3.0)
    x = (a * np.where(rng.random(a.shape) < 0.5, -1, 1)).reshape(
        nf, C.LONG_COEFFS).astype(np.float32)
    xt, at, gt = (torch.from_numpy(v) for v in (x, amp_bin, gains))
    vals = k2_pair_tuple_values(xt, at, gt)
    np.testing.assert_array_equal(vals, k2_tuple_values(xt, at, gt))
    from mrcaudiocodec_tpu_torch.ops import quantize
    q = quantize.quantize(xt, torch.full_like(at, 128))
    assert set(np.abs(q.numpy()).ravel()) >= set(range(0, 40))
    assert np.abs(q.numpy()).max() == C.QMAX
    # widest band: 63 tuples; every tuple's esc below 2^16 / 63
    assert vals[2].max() * 63 < 1 << 16 and vals[1].max() * 63 < 1 << 15


def test_k2_alignment_check_rejects_offset_view():
    buf = torch.zeros(2 * C.LONG_COEFFS + 4)
    quant_cost.check_aligned("x", buf[:2 * C.LONG_COEFFS].view(2, -1))
    view = buf[1:2 * C.LONG_COEFFS + 1].view(2, -1)
    assert view.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        quant_cost.check_aligned("x", view)
    ints = torch.zeros(2 * C.LONG_COEFFS + 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        quant_cost.check_aligned("amp_bin", ints[2:2 * C.LONG_COEFFS + 2])


# ---------------------------------------------------------------------------
# K3: lane ownership, lane runs, the look-back, the block shape
# ---------------------------------------------------------------------------

PAIRS_PER_LANE = 16                 # kPairsPerLane
HEAD_BITS = 31                      # kHeadBits


def k3_lane_bands(nb, lane):
    per_lane = (nb + 31) >> 5
    return range(min(per_lane * lane, nb), min(per_lane * (lane + 1), nb))


def k3_lane_pairs(lane):
    return range(PAIRS_PER_LANE * lane, PAIRS_PER_LANE * (lane + 1))


@pytest.mark.parametrize("nb", [1, 31, 32, 33, 88, 96, 128])
def test_k3_lanes_cover_pairs_bins_and_bands_once(nb):
    bands = [b for lane in range(32) for b in k3_lane_bands(nb, lane)]
    assert bands == list(range(nb))                 # once each, in order
    pairs = [p for lane in range(32) for p in k3_lane_pairs(lane)]
    assert pairs == list(range(C.LONG_COEFFS // 2))
    for lane in range(32):
        # four 16-byte loads of int16 q: int4 words 4l .. 4l+3, bins
        # 32l .. 32l+31; 32-bit word k of them holds pair 16l + k
        bins = np.arange(32 * lane, 32 * lane + 32)
        assert bins[0] // 8 == 4 * lane and bins[-1] // 8 == 4 * lane + 3
        assert list(bins[::2] // 2) == list(k3_lane_pairs(lane))
        # CB_SMALL's 4-tuple on even pair 2m covers pairs 2m, 2m + 1
        for p in k3_lane_pairs(lane)[::2]:
            assert p + 1 in k3_lane_pairs(lane)
    for fs in (32000, 44100, 48000):
        assert T.unified_layout(fs)["nb"] <= record_pack.NB_MAX


def k3_runs(codes, lens, nb):
    """One record's slots (device_pack.slots order) -> the kernel's runs
    [(first bit, [(code, len), ...])]: lane 0's header, then per lane its
    bands' codebook ids, its bands' scale-factor codewords and its pairs'
    payload slots (three puts a pair), each placed by an exclusive scan
    over the lanes."""
    slot = list(zip(codes.tolist(), lens.tolist()))
    cb = lambda b: slot[3 + b]
    sf = lambda b: slot[3 + nb + b]

    def pay(p):
        """Pair p's slots as the kernel puts them: the main codeword and
        its two sign bits as one code, then the two escapes."""
        (mc, ml), (ac, al), (bc, bl), esc0, esc1 = \
            slot[3 + 2 * nb + 5 * p:3 + 2 * nb + 5 * p + 5]
        mask = lambda c, n: c & ((1 << n) - 1)
        head = ((mask(mc, ml) << (al + bl)) | (mask(ac, al) << bl)
                | mask(bc, bl))
        assert ml + al + bl <= 22                   # under 32 bits a put
        return [(head, ml + al + bl), esc0, esc1]
    lanes = range(32)
    runs_cb = [[cb(b) for b in k3_lane_bands(nb, l)] for l in lanes]
    runs_sf = [[sf(b) for b in k3_lane_bands(nb, l)] for l in lanes]
    runs_pay = [[s for p in k3_lane_pairs(l) for s in pay(p)] for l in lanes]
    out = [(0, slot[:3])]
    at = HEAD_BITS
    for group in (runs_cb, runs_sf, runs_pay):
        lengths = [sum(n for _, n in run) for run in group]
        excl = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        out += [(at + int(e), run) for e, run in zip(excl, group)]
        at += sum(lengths)
    assert at == HEAD_BITS + int(lens[1:].sum()) - 11
    return out


def k3_write_runs(runs, n_words):
    """The kernel's Run on each run: a 64-bit accumulator, MSB first,
    whole big-endian words byte-swapped; a run's first and last word ORed,
    its interior words stored. Asserts that no store lands on a word
    another run touched and that no OR meets a set bit."""
    words = [0] * n_words
    owner = [None] * n_words                     # "store" / "or" / None
    for off, slots in runs:
        total = sum(n for _, n in slots)
        if total == 0:
            continue
        w0, w1 = off >> 5, (off + total - 1) >> 5
        state = {"acc": 0, "n": off & 31, "w": w0}

        def emit(big):
            w = state["w"]
            v = int.from_bytes(int(big).to_bytes(4, "big"), "little")
            if w < n_words:
                if w in (w0, w1):
                    assert owner[w] != "store" and not words[w] & v
                    words[w] |= v
                    owner[w] = "or"
                else:
                    assert owner[w] is None and words[w] == 0
                    words[w] = v
                    owner[w] = "store"
            state["w"] = w + 1

        for code, n in slots:
            state["acc"] = (state["acc"] << n) | (code & ((1 << n) - 1))
            state["n"] += n
            if state["n"] >= 32:
                state["n"] -= 32
                emit(state["acc"] >> state["n"])
                state["acc"] &= (1 << state["n"]) - 1
        if state["n"] > 0:
            emit((state["acc"] << (32 - state["n"])) & 0xFFFFFFFF)
        assert state["w"] == w1 + 1
    return np.array(words, np.uint32).view(np.uint8)


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k3_lane_runs_reproduce_plain_bytes(fs):
    nf, cap = 12, 1536
    d = record_pack.random_decisions(np.random.default_rng(fs + 3), nf, fs)
    d = [torch.from_numpy(v) for v in d]
    rec, nbytes = device_pack.pack_records_plain(*d, fs, cap)
    codes, lens, _ = device_pack.slots(*d, fs)
    nb = T.unified_layout(fs)["nb"]
    n_words = (cap + 3) >> 2
    for r in range(nf):
        got = k3_write_runs(k3_runs(codes[r], lens[r], nb), n_words)
        assert got[:cap].tobytes() == rec[r].numpy().tobytes(), r
        assert not got[int(nbytes[r]):].any()
    # a cap that cuts the record: the words past it are dropped, the rest
    # are the record's first bytes
    short = int(nbytes[0]) // 2
    got = k3_write_runs(k3_runs(codes[0], lens[0], nb), (short + 3) >> 2)
    assert got[:short].tobytes() == rec[0, :short].numpy().tobytes()


def k3_look_back(aggregates, blocks, rng, window=32):
    """Decoupled look-back as the kernel runs it: `blocks` persistent
    blocks, each in a loop: take the next tile from the counter, pack it
    and publish its aggregate (tile 0 its inclusive prefix), then resolve
    its previous tile, reading the status words of its `window` nearest
    unread predecessors at once and spinning while one is unset; the
    nearest inclusive prefix in a window ends the walk. Blocks move one
    step at a time in a random order. -> each tile's exclusive prefix."""
    n = len(aggregates)
    status = [(0, 0)] * n                         # (flag, value)
    offsets = [None] * n
    taken = 0
    state = [{"take": True, "cur": None, "prev": None, "walk": None}
             for _ in range(blocks)]
    live = list(range(blocks))
    for _ in range(100 * n * n + 100 * blocks):
        if not live:
            return offsets
        block = live[rng.integers(len(live))]
        st = state[block]
        if st["take"]:
            cur = taken if taken < n else None
            if cur is not None:
                taken += 1
                status[cur] = (2 if cur == 0 else 1, aggregates[cur])
            prev = st["prev"]
            st.update(take=False, cur=cur,
                      walk=[prev - 1, 0] if prev else None)
            if prev == 0:
                offsets[0] = 0
            continue
        if st["walk"] is not None:
            j, excl = st["walk"]
            # lane l reads tile j - l; before tile 0 a zero prefix
            seen = [status[k] if k >= 0 else (2, 0)
                    for k in range(j, j - window, -1)]
            if any(flag == 0 for flag, _ in seen):
                continue                         # spin
            last = next((l for l, (flag, _) in enumerate(seen)
                         if flag == 2), None)
            excl += sum(v for _, v in seen[:window if last is None
                                           else last + 1])
            if last is None:
                st["walk"] = [j - window, excl]
                continue
            prev = st["prev"]
            offsets[prev] = excl
            status[prev] = (2, excl + aggregates[prev])
            st["walk"] = None
        if st["cur"] is None:
            live.remove(block)
        else:
            st.update(take=True, prev=st["cur"])
    raise AssertionError("the look-back did not finish")


@pytest.mark.parametrize("tiles", [1, 2, 33, 150])
def test_k3_look_back_gives_exclusive_cumsum(tiles):
    rng = np.random.default_rng(tiles)
    for resident in (1, 3, 8, tiles):
        for window in (1, 4, 128):
            agg = rng.integers(4 * 4, 8 * 933, tiles)   # 8 records a tile
            want = np.concatenate([[0], np.cumsum(agg)[:-1]])
            assert k3_look_back(list(agg), resident, rng,
                                window) == want.tolist()


@pytest.mark.parametrize("cap", [224, 376, 933, 32 * 1024])
def test_k3_warps_per_block_fit_shared_memory(cap):
    warps = record_pack.warps_per_block(cap)
    assert 1 <= warps <= record_pack.MAX_WARPS
    used = record_pack.STATIC_SMEM + record_pack.dyn_smem(cap, warps)
    if warps > 1:
        assert used <= record_pack.SMEM_LIMIT
    else:                                        # the opt-in, one warp
        assert used <= record_pack.SMEM_OPT_IN
    if warps < record_pack.MAX_WARPS:            # one warp more would not
        assert (record_pack.STATIC_SMEM + record_pack.dyn_smem(cap, warps + 1)
                > record_pack.SMEM_LIMIT)
    assert warps == (1 if cap == record_pack.MAX_CAP_BYTES else 8)
    # two staging buffers a warp: at 32 KB one warp needs the opt-in
    assert (used > record_pack.SMEM_LIMIT) == (cap == 32 * 1024)
    # the .cu's static arrays: 572 codes, 2 + 8 + 16 ints, 5 x 512 + 5 x
    # 128 B: 5592 B, rounded up to 16
    assert 4 * (572 + 2 + 24) + 5 * (512 + 128) == 5592
    assert record_pack.STATIC_SMEM == 5600


# ---------------------------------------------------------------------------
# K4 (csrc/rd_loop.cu): its schedule, one frame at a time
# ---------------------------------------------------------------------------

WARPS = 4                              # kWarps = REFINE_BLOCK
REFINE_BLOCKS = 4                      # kRefineBlocks
REGION = C.LONG_COEFFS // WARPS        # kRegion


def _f32_bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def k4_facts(te):
    """What K4's set-up derives from one row of tuple edges: band edges in
    bins, the tuple -> band map, each tuple's offset in its band, each
    bin's segment start, the widest band, the real bands' count, each
    band's last bin, and the 4 warp regions (cut at the first band edge at
    or above 256 w: tuples [t0, t1), bands [b0, b1), the widest band)."""
    te = np.asarray(te, np.int64)
    nb = len(te) - 1
    edge = 4 * te
    band = np.repeat(np.arange(nb), np.diff(te))              # [256]
    toff = np.arange(C.LONG_COEFFS // 4) - te[band]
    seg = edge[band[np.arange(C.LONG_COEFFS) >> 2]]
    width = np.diff(edge)
    real = width > 0
    first = ([0] + [int(np.argmax(edge >= REGION * w))
                    for w in range(1, WARPS)] + [nb])
    cut = [int(edge[b]) for b in first[:-1]] + [C.LONG_COEFFS]
    regions = [dict(t0=cut[w] >> 2, t1=cut[w + 1] >> 2, b0=first[w],
                    b1=first[w + 1],
                    maxw=int(width[first[w]:first[w + 1]].max(initial=0)))
               for w in range(WARPS)]
    return dict(edge=edge, band=band, toff=toff, seg=seg,
                maxw=int(width.max()), nreal=int(real.sum()), real=real,
                end=np.where(real, edge[1:] - 1, 0), regions=regions)


def k4_frame_facts(fs, bt):
    """k4_facts of the frame family of block type bt."""
    return k4_facts(quant_cost.band_tuples(fs)[bt])


def k4_region_scan(p, facts):
    """K4's pinned scan of one frame's d * d [1024] f32, region by region
    as the kernel runs it: a tuple's 4 bins as one float4; stage s (1, 2,
    4, ... below the region's widest band) adds the shifted bins where the
    tuple's offset in its band is at least max(1, s / 4) (below s = 4 the
    tuple's own bins and the tuple before's); 32 tuples at a time from the
    region's top down, every lane reading before any lane writes."""
    t = np.asarray(p, np.float32).reshape(-1, 4).copy()
    with np.errstate(over="ignore"):          # a sum may overflow to inf
        for r in facts["regions"]:
            _scan_region(t, r, facts["toff"])
    return t.reshape(-1)


def _scan_region(t, r, toff):
    """One region's stages on the tuples t [256, 4], in place."""
    top = r["t0"] + ((r["t1"] - r["t0"] - 1) & ~31)
    s = 1
    while s < r["maxw"]:
        st = 1 if s < 4 else s >> 2
        for base in range(top, r["t0"] - 1, -32):
            u = np.arange(base, min(base + 32, r["t1"]))
            v = t[u].copy()
            take = toff[u] >= st
            w = t[np.where(take, u - st, u)].copy()
            o = v.copy()
            if s == 1:
                o[:, 0] = np.where(take, v[:, 0] + w[:, 3], v[:, 0])
                o[:, 1:] = v[:, 1:] + v[:, :-1]
            elif s == 2:
                o[:, :2] = np.where(take[:, None], v[:, :2] + w[:, 2:],
                                    v[:, :2])
                o[:, 2:] = v[:, 2:] + v[:, :2]
            else:
                o = np.where(take[:, None], v + w, v)
            t[u] = o                        # every lane read first
        s <<= 1


def k4_over(x, mags, gain, tamp, facts, allowed, pow43):
    """region_over on one frame: the kept magnitudes' d * d (the table's
    |q|^(4/3) times the step, the sign from x), the region scan, then each
    real band's flag (its tuple amp below AMP_MAX)."""
    from mrcaudiocodec_tpu_torch.ops import quantize
    e = np.clip(gain - np.repeat(tamp, 4), C.GAIN_MIN, C.GAIN_MAX)
    step = quantize.band_steps(torch.from_numpy(e)).numpy()
    val = pow43[mags] * step
    d = x - np.where((x < 0) & (mags != 0), -val, val)
    noise = k4_region_scan(d * d, facts)[facts["end"]]
    lo = np.minimum(facts["edge"][:-1], C.LONG_COEFFS - 1) >> 2
    return (facts["real"] & (noise > allowed)
            & (tamp[lo] < C.AMP_MAX))


def k4_model(x, allowed, bc, bt, gain0, bits0, fs):
    """csrc/rd_loop.cu's schedule, frame by frame -> (q, amp, gain, bits)
    and each frame's refine iterations. The entry quantizes; each refine
    warp keeps its candidate's magnitudes, the fallback is one warp's (slot
    0), and the over-mask reads the winner's."""
    from mrcaudiocodec_tpu_torch.ops import quantize
    len_sf = T.code_arrays()["len_sf"]
    pow43 = rd_loop.pow43_table("cpu").numpy()
    nf, nb = x.shape[0], allowed.shape[1]
    outs = [np.zeros((nf, C.LONG_COEFFS), np.int32),
            np.zeros((nf, nb), np.int32), np.zeros(nf, np.int32),
            np.zeros(nf, np.int32)]
    iters = np.zeros(nf, np.int64)
    for f in range(nf):
        facts = k4_frame_facts(fs, int(bt[f]))
        xf, btf, xn = x[f:f + 1], bt[f:f + 1], x[f].numpy()
        tamp = np.zeros(C.LONG_COEFFS // 4, np.int64)     # a tuple's amp
        amp = np.zeros(nb, np.int64)                       # a band's
        gain, bits = int(gain0[f]), int(bits0[f])

        def kept(gains, tamp):
            """a warp's kept magnitudes at each gain: |quantize|."""
            amp_bin = torch.from_numpy(np.repeat(tamp, 4))
            e = torch.clamp(torch.tensor(gains)[:, None] - amp_bin, 0, 255)
            return quantize.quantize(xf.expand(len(gains), -1),
                                     e).abs().numpy()

        keep, win = kept([gain], tamp), 0                  # the entry's
        over = k4_over(xn, keep[win], gain, tamp, facts, allowed[f].numpy(),
                       pow43)
        for it in range(1, C.OUTER_MAX):
            if not over.any():                      # the frame's own exit
                break
            iters[f] += 1
            amp = np.minimum(amp + C.AMP_STEP * over, C.AMP_MAX)
            tamp = np.minimum(tamp + C.AMP_STEP * over[facts["band"]],
                              C.AMP_MAX)
            prev = np.concatenate([[0], amp[:-1]])
            sf = np.where(facts["real"],
                          len_sf[prev - amp + C.SF_DELTA_MAX], 0).sum()
            fixed = (C.BLOCK_TYPE_BITS + C.GAIN_BITS
                     + C.CB_BITS * facts["nreal"] + int(sf))
            amp_bin = torch.from_numpy(
                np.repeat(tamp, 4).astype(np.int32))[None]
            prev_gain = gain
            for b in range(REFINE_BLOCKS + 1):
                fallback = b == REFINE_BLOCKS           # warp 0 alone
                cand = ([C.GAIN_MAX] if fallback else
                        [min(prev_gain + WARPS * b + w, C.GAIN_MAX)
                         for w in range(WARPS)])
                slot = quant_cost.payload_bits_plain(
                    xf, amp_bin, torch.tensor([cand], dtype=torch.int32),
                    btf, fs)[0].numpy() + fixed        # one warp each
                fits = np.flatnonzero(slot <= int(bc[f]))
                if fallback or len(fits):
                    w = 0 if fallback else int(fits[0])
                    gain, bits, win = cand[w], int(slot[w]), w
                    keep = kept(cand, tamp)
                    break
            over = k4_over(xn, keep[win], gain, tamp, facts,
                           allowed[f].numpy(), pow43)
        outs[0][f] = np.where(xn < 0, -keep[win], keep[win])
        outs[1][f], outs[2][f], outs[3][f] = amp, gain, bits
    return outs, iters


K4_CORNERS = ("music", "adversarial", "starved", "all_short", "silent_pad",
              "outer_max")       # test_torch_rd_loop.KINDS


@pytest.mark.parametrize("kind", K4_CORNERS)
@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k4_schedule_model_matches_rd_batch(fs, kind):
    from mrcaudiocodec_tpu_torch.ops import rd
    from test_torch_rd_loop import KINDS, loop_inputs, rd_case
    assert K4_CORNERS == KINDS
    case = rd_case(kind, fs)
    if kind != "adversarial":
        case = tuple(v[:12] for v in case)
    args = loop_inputs(*case, fs)
    got, iters = k4_model(*args, fs)
    want = rd.rd_batch(*(torch.from_numpy(v) for v in case), fs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    st = rd.loop_counts(*args, fs)
    # each frame's own exit took the batch loop's iterations for that frame
    np.testing.assert_array_equal(iters, st["outer"].numpy())
    assert iters.max() > 0


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k4_frame_facts_match_the_scan_tables(fs):
    """The kernel's band facts give xpsy's pinned scan tables: the stages
    (1, 2, 4, ... below the widest band), the include masks and the band
    ends, for every block type; the warp regions partition the bins and
    hold whole bands, each region's widest band at most the frame's."""
    from mrcaudiocodec_tpu_torch import xpsy
    from mrcaudiocodec_tpu_torch.ops import entropy, rd
    from mrcaudiocodec_tpu_torch.ops.psycho import unified_band_edges
    le, se = unified_band_edges(fs)
    tb = entropy.dev_tables(fs, "cpu")
    for bt in range(C.N_BLOCK_TYPES):
        facts = k4_frame_facts(fs, bt)
        stages, ends = xpsy._seg_tables_from_edges(
            se if bt == C.SHORT else le)
        shifts = []
        s = 1
        while s < facts["maxw"]:
            shifts.append(s)
            s <<= 1
        assert shifts == [d for d, _ in stages]
        assert len(shifts) == rd.scan_stages(fs, bt == C.SHORT)
        idx = np.arange(C.LONG_COEFFS)
        for d, mask in stages:
            np.testing.assert_array_equal(idx - d >= facts["seg"], mask)
        real = facts["real"]
        np.testing.assert_array_equal(facts["end"][real], ends[real])
        np.testing.assert_array_equal(real, tb["width"][bt].numpy() > 0)
        assert facts["nreal"] == int(tb["nreal"][bt])
        _check_regions(facts)


def _check_regions(facts):
    regs, edge = facts["regions"], facts["edge"]
    assert regs[0]["t0"] == 0 and regs[-1]["t1"] == C.LONG_COEFFS // 4
    assert regs[0]["b0"] == 0 and regs[-1]["b1"] == len(edge) - 1
    for a, b in zip(regs, regs[1:]):
        assert a["t1"] == b["t0"] and a["b1"] == b["b0"]
    for w, r in enumerate(regs):
        for b in range(r["b0"], r["b1"]):
            if edge[b + 1] > edge[b]:         # a real band lies inside
                assert 4 * r["t0"] <= edge[b] and edge[b + 1] <= 4 * r["t1"]
        assert r["maxw"] <= facts["maxw"]
        if w:
            assert 4 * r["t0"] >= REGION * w
    # a tuple's offset in its band fits the kernel's byte
    assert facts["toff"].max() < 256


def _adversarial_tuples():
    """Tuple-edge rows the layouts do not have (a band is whole tuples):
    one-tuple bands, the widest band (64 tuples) across a nominal cut,
    zero-width bands inside and at the end, a region with no band edge."""
    ones = list(range(51))                             # 50 one-tuple bands
    wide = ones + [114, 114, 115, 116, 180, 180, 244, 256]
    rows = {"one-tuple bands and a 64-tuple band across bin 256": wide,
            "a 64-tuple band over bins 768-1023, zero-width bands":
                list(range(0, 192, 2)) + [192, 192, 256, 256, 256],
            "one band over bins 0-255, then one-tuple bands":
                [0] + list(range(64, 128)) + [192, 256],
            "widest bands back to back": [0, 64, 128, 192, 256]}
    return {k: np.asarray(v, np.int64) for k, v in rows.items()}


def _scan_cases():
    from mrcaudiocodec_tpu_torch.ops.psycho import unified_band_edges
    cases = {}
    for fs in (32000, 44100, 48000):
        le, se = unified_band_edges(fs)
        cases[f"{fs} long"] = np.asarray(le) // 4
        cases[f"{fs} short"] = np.asarray(se) // 4
    cases.update(_adversarial_tuples())
    return cases


def _scan_values(rng):
    """d * d-like values whose sums round at every add: magnitudes over
    60 decades, zeros, subnormals, and values whose sum overflows."""
    p = (10.0 ** rng.uniform(-30, 30, C.LONG_COEFFS)).astype(np.float32)
    p[rng.integers(0, C.LONG_COEFFS, 64)] = 0.0
    p[rng.integers(0, C.LONG_COEFFS, 16)] = np.float32(1e-40)
    p[rng.integers(0, C.LONG_COEFFS, 4)] = np.float32(3e38)
    return p


@pytest.mark.parametrize("case", sorted(_scan_cases()))
def test_k4_region_scan_matches_seg_scan(case):
    """K4's region scan (in place, a float4 a tuple, chunks from the top
    down, stages up to the region's widest band) gives xpsy.seg_scan's
    array bit for bit, every bin, on every band table of the layouts and
    on tables the layouts do not have."""
    from mrcaudiocodec_tpu_torch import xpsy
    te = _scan_cases()[case]
    facts = k4_facts(te)
    _check_regions(facts)
    stages = xpsy._dev_seg_tables(tuple(int(v) for v in 4 * te), "cpu")[0]
    rng = np.random.default_rng(len(case))
    for _ in range(3):
        p = _scan_values(rng)
        want = xpsy.seg_scan(torch.from_numpy(p)[None], stages)[0].numpy()
        np.testing.assert_array_equal(_f32_bits(k4_region_scan(p, facts)),
                                      _f32_bits(want))


def test_k4_pow43_table_matches_dequantize():
    """The |q|^(4/3) table, all QMAX + 1 entries, bitwise: the port's
    quantize.dequantize chain written out (xexp2(4/3 * xlog2(max(m, 1))),
    0 at 0), the port's dequantize at step 1 and at other steps divided
    out exactly (a power of two), the JAX package's dequantize and the
    spec's, all on the CPU."""
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import quantize as jq
    from mrcaudiocodec_tpu.spec import quantize as sq
    from mrcaudiocodec_tpu_torch import xpsy
    from mrcaudiocodec_tpu_torch.ops import quantize
    table = rd_loop.pow43_table("cpu")
    assert table.dtype == torch.float32 and table.shape == (C.QMAX + 1,)
    m = torch.arange(C.QMAX + 1, dtype=torch.float32)
    chain = xpsy.xexp2(quantize.C43 * xpsy.xlog2(torch.clamp(m, min=1.0)))
    chain = torch.where(m == 0, 0.0, chain)
    np.testing.assert_array_equal(_f32_bits(table.numpy()),
                                  _f32_bits(chain.numpy()))
    q = np.arange(C.QMAX + 1, dtype=np.int32)
    e = np.full_like(q, C.GAIN_BIAS)
    np.testing.assert_array_equal(
        _f32_bits(table.numpy()), _f32_bits(np.asarray(jq.dequantize(
            jnp.asarray(q), jnp.asarray(e)))))
    np.testing.assert_array_equal(_f32_bits(table.numpy()),
                                  _f32_bits(sq.dequantize(q, e)))
    # val = table[|q|] * step, the sign after: dequantize at any exponent
    for ev in (0, 77, 128, 200, 255):
        eb = torch.full((C.QMAX + 1,), ev, dtype=torch.int32)
        qs = torch.from_numpy(np.where(q % 3 == 1, -q, q))
        val = table[qs.abs().long()] * quantize.band_steps(eb)
        want = quantize.dequantize(qs, eb)
        np.testing.assert_array_equal(
            _f32_bits(torch.where(qs < 0, -val, val).numpy()),
            _f32_bits(want.numpy()))


# ---------------------------------------------------------------------------
# K4 (csrc/rd_loop.cu): its constants, its shared memory, the build's
# staleness rule for the header it shares with K2
# ---------------------------------------------------------------------------

RD_LOOP_CU = os.path.join(os.path.dirname(build.CSRC), "csrc", "rd_loop.cu")


def _cu_ints(path):
    """{name: value} of the `constexpr int kName = <int expression>;`
    lines of the shared header and a source (one name a line, or several
    after commas; C's / on ints is //)."""
    text = ""
    for p in (os.path.join(os.path.dirname(path), "quant_cost_warp.cuh"),
              path):
        with open(p) as f:
            text += f.read()
    out = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):
        for part in decl.split(","):
            name, expr = (s.strip() for s in part.split("="))
            out[name] = eval(re.sub(r"//.*", "", expr).replace("/", "//"),
                             {}, dict(out))
    return out


def test_k4_constants_match_the_format():
    k = _cu_ints(RD_LOOP_CU)
    from mrcaudiocodec_tpu_torch.ops import rd
    assert k["kWarps"] == rd.REFINE_BLOCK == WARPS
    assert k["kRefineBlocks"] == rd.N_REFINE_BLOCKS == REFINE_BLOCKS == 4
    assert k["kRegion"] == REGION
    assert (k["kOuterMax"], k["kAmpStep"], k["kAmpMax"], k["kGainMax"]) == (
        C.OUTER_MAX, C.AMP_STEP, C.AMP_MAX, C.GAIN_MAX)
    assert k["kFixedBits"] == C.BLOCK_TYPE_BITS + C.GAIN_BITS
    assert (k["kCbBits"], k["kSfDeltaMax"]) == (C.CB_BITS, C.SF_DELTA_MAX)
    assert k["kLenSf"] == len(T.code_arrays()["len_sf"])
    # the table's length and the magnitudes' 16-bit slots
    assert k["kQmax"] == C.QMAX and C.QMAX < 1 << 16
    assert C.AMP_MAX < 256                   # a tuple's amp is one byte
    # the constants' offsets in rd_loop.consts(): K2's, then the fractions
    from mrcaudiocodec_tpu_torch import xpsy
    from mrcaudiocodec_tpu_torch.ops import quantize
    c = rd_loop.consts()
    assert c.dtype == np.float32 and len(c) == k["kAllConsts"]
    assert k["kConsts"] == k["kFrac"] == 11
    np.testing.assert_array_equal(c[:6], np.float32(xpsy.RSQRT_P))
    np.testing.assert_array_equal(c[6:10], quantize.INV_FRACS)
    assert c[10] == np.float32(quantize.QUANT_MAGIC)
    np.testing.assert_array_equal(c[k["kFrac"]:k["kFrac"] + 4],
                                  quantize.FRACS)
    # xlog2 and xexp2 left the kernel with their constants: the table
    # holds their values
    with open(RD_LOOP_CU) as f:
        src = f.read()
    assert "xlog2(" not in src and "xexp2(" not in src


def test_k4_static_shared_memory_fits_48_kb():
    """x (swizzled float4s), the 4 warps' kept magnitudes (4 x 1024
    uint16), the over-mask's d * d (float4s), K2's code tables, len_sf,
    the constants, allowed noise and edges of up to 128 bands, a byte a
    tuple for its band, offset and amp, a byte a band for its flag and its
    amp, the regions' cuts, first bands and widest bands, a warp reduction
    slot each and the refine block's double-buffered payloads. Under the
    48 KB of static shared memory, and the kMinBlocks blocks an SM that
    __launch_bounds__ asks for (with the 1 KB the card reserves a block)
    fit the 227 KB an SM offers, as do their registers (72 a thread)."""
    k = _cu_ints(RD_LOOP_CU)
    nbmax, tuples, w = 128, C.LONG_COEFFS // 4, k["kWarps"]
    used = (16 * tuples + 8 * w * tuples + 16 * tuples
            + 4 * (81 + 2 * 33 * 33) + 4 * k["kLenSf"]
            + 4 * k["kAllConsts"] + 4 * nbmax + 4 * (nbmax + 1)
            + 3 * tuples + 2 * nbmax + 2 * 4 * (w + 1) + 4 * w + 4 * w
            + 4 * 2 * w)
    assert used == 28120
    assert used < 48 * 1024
    assert k["kMinBlocks"] == 7
    assert k["kMinBlocks"] * (used + 1024) <= 227 * 1024
    assert k["kThreads"] == 128
    # registers in 8-register steps: 72 a thread for 7 blocks of 128
    assert k["kMinBlocks"] * k["kThreads"] * 72 <= 65536 < (
        k["kMinBlocks"] * k["kThreads"] * 80)


def _touch(path, t):
    with open(path, "w") as f:
        f.write("// test\n")
    os.utime(path, (t, t))


def test_build_staleness_follows_included_headers(tmp_path, monkeypatch):
    """A library is stale when its .cu or a csrc/*.cuh the .cu includes is
    newer than the .so; a header it does not include does not count. No
    nvcc is needed."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "CSRC", str(csrc))
    monkeypatch.setattr(build, "BUILD", str(out))
    (csrc / "quant_cost.cu").write_text(
        '#include <cuda_runtime.h>\n#include "quant_cost_warp.cuh"\n')
    for name in ("quant_cost_warp.cuh", "other.cuh"):
        _touch(csrc / name, 1000)
    os.utime(csrc / "quant_cost.cu", (1000, 1000))
    assert build.inputs("quant_cost") == [
        str(csrc / "quant_cost.cu"), str(csrc / "quant_cost_warp.cuh")]
    assert build.stale("quant_cost")                 # no library yet
    _touch(out / "libquant_cost.so", 2000)
    assert not build.stale("quant_cost")
    os.utime(csrc / "other.cuh", (3000, 3000))       # not included
    assert not build.stale("quant_cost")
    os.utime(csrc / "quant_cost_warp.cuh", (3000, 3000))
    assert build.stale("quant_cost")                 # the header is newer
    _touch(out / "libquant_cost.so", 4000)
    os.utime(csrc / "quant_cost.cu", (5000, 5000))
    assert build.stale("quant_cost")                 # the source is newer
    # the repository's own sources: K2 and K4 include the shared header
    monkeypatch.undo()
    for name in ("quant_cost", "rd_loop"):
        assert os.path.join(build.CSRC, "quant_cost_warp.cuh") in \
            build.inputs(name)
    assert build.inputs("probe_fma_contract") == [
        os.path.join(build.CSRC, "probe_fma.cu")]
