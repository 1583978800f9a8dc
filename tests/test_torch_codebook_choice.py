"""The decide layer's tail: K13 (`ops/kernels/codebook_choice.py`,
csrc/codebook_choice.cu) and its plain version against the entropy stage's
`payload_costs_and_choice` with the casts `decide_chunk` made, the port's
NumPy spec's `choose_codebooks` and the JAX package's
`payload_costs_and_choice`, bit for bit.

On the CPU: the plain version at three rates and 1, 31, 2586 and 8192
frames, on q drawn so that every codebook wins, the one tie the code
tables allow (CB_MID = CB_ESC) occurs, bands are all zero and |q| takes 1,
4, 15, 16, 17 and QMAX; a numpy model of the kernel's warp schedule (each
lane's runs of tuples, the segmented scan over the lanes, the choice
written where a band ends, the zeroed row) on the same q; the kernel's
band maps; the wrapper's checks. The `cuda` cases hold the kernel to the
plain version on the card: on the same inputs, on both benchmark cells'
own K4 outputs, one launch a chunk and no synchronize.
"""
import functools
import itertools

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import corpus, trace
from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import encoder
from mrcaudiocodec_tpu_torch.ops import entropy
from mrcaudiocodec_tpu_torch.ops.kernels import codebook_choice as K
from mrcaudiocodec_tpu_torch.ops.kernels import quant_cost
from mrcaudiocodec_tpu_torch.spec import entropy as sent

RATES = [44100, 48000, 32000]
FRAMES = [1, 31, 2586, 8192]
SPECIAL = (1, 4, 15, 16, 17, C.QMAX)
# a band's kind: all zero, |q| <= 1, <= 4, <= 16, escapes up to QMAX (the
# special magnitudes among them), a CB_MID = CB_ESC tie
KINDS = ("zero", "small", "mid", "esc16", "escape", "tie")


@functools.lru_cache(maxsize=1)
def tie_tuples() -> np.ndarray:
    """The 4-tuples in [-4, 4]^4 whose CB_MID and CB_ESC lengths are equal
    and which hold a |q| > 1 (so CB_SMALL is out). Zero pairs cost 3 bits
    in both codebooks, so such a tuple among zeros ties any band."""
    tups = np.array(list(itertools.product(range(-4, 5), repeat=4)))
    q = np.zeros((len(tups), C.LONG_COEFFS), np.int64)
    q[:, :4] = tups
    costs, _ = sent.payload_costs(q, np.array([0, 4, C.LONG_COEFFS]))
    c = costs[:, 0]
    return tups[(c[:, 2] == c[:, 3]) & (np.abs(tups).max(1) > 1)]


def make_q(frames, fs, seed):
    """-> (q [F, 1024] int32, bt [F] int32): a kind a band (KINDS), drawn
    at random; bt cycles through the five block types from a random
    start."""
    rng = np.random.default_rng(seed)
    lay = T.unified_layout(fs)
    nb = lay["nb"]
    bt = ((np.arange(frames) + rng.integers(0, C.N_BLOCK_TYPES))
          % C.N_BLOCK_TYPES).astype(np.int32)
    kind = rng.integers(0, len(KINDS), (frames, nb))
    band = lay["bin_band"][bt]                              # [F, 1024]
    k = np.take_along_axis(kind, band, 1)
    sign = np.where(rng.random((frames, C.LONG_COEFFS)) < 0.5, -1, 1)
    dense = rng.random((frames, C.LONG_COEFFS)) < rng.uniform(
        0.1, 1.0, (frames, 1))
    mag = np.select(
        [k == 1, k == 2, k == 3],
        [rng.integers(0, 2, k.shape), rng.integers(0, 5, k.shape),
         rng.integers(0, 17, k.shape)],
        np.where(rng.random(k.shape) < 0.5,
                 rng.choice(SPECIAL, k.shape),
                 rng.integers(0, C.QMAX + 1, k.shape)))
    q = np.where((k == 0) | (k == 5) | ~dense, 0, sign * mag)
    # a tie band: one tie tuple at a random tuple of the band, zeros else
    ties = tie_tuples()
    edges = lay["edges"]
    for f, b in zip(*np.nonzero(kind == 5)):
        lo, hi = edges[bt[f], b] // 4, edges[bt[f], b + 1] // 4
        if hi > lo:
            u = rng.integers(lo, hi)
            q[f, 4 * u:4 * u + 4] = ties[rng.integers(0, len(ties))]
    return q.astype(np.int32), bt


def make_inputs(frames, fs, seed):
    """(q, amp, gain, bt) int32 CPU tensors: amp 0 .. AMP_MAX, gain
    0 .. 255, as K4 gives them."""
    rng = np.random.default_rng(seed + 1)
    q, bt = make_q(frames, fs, seed)
    nb = T.unified_layout(fs)["nb"]
    amp = rng.integers(0, C.AMP_MAX + 1, (frames, nb)).astype(np.int32)
    gain = rng.integers(C.GAIN_MIN, C.GAIN_MAX + 1, frames).astype(np.int32)
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (q, amp, gain, bt))


def spec_choice(q, bt, fs):
    """[F, NB] int32: the NumPy spec's choice, a block type at a time."""
    lay = T.unified_layout(fs)
    out = np.zeros((q.shape[0], lay["nb"]), np.int32)
    for t in range(C.N_BLOCK_TYPES):
        rows = bt == t
        if rows.any():
            out[rows], _ = sent.choose_codebooks(
                q[rows].astype(np.int64), lay["edges"][t], lay["width"][t])
    return out


# -- a model of the kernel's warp schedule ------------------------------------

def tuple_sums(q):
    """(small, em, flags) [F, 256] int64, as the kernel's tuple_sums: the
    pair tables at the pairs' signed magnitudes clamped to [-16, 16], the
    escape suffixes of |q| >= 16."""
    em_tab, sf_tab = quant_cost.pair_tables()
    small_tab = T.code_arrays()["len_small"]
    q = q.astype(np.int64)
    v = (np.clip(q, -16, 16) + 16).reshape(q.shape[0], 256, 2, 2)
    idx = v[..., 0] * 33 + v[..., 1]                      # [F, 256, 2]
    em = em_tab[idx].sum(-1) + T.escape_len(np.abs(q)).reshape(
        q.shape[0], 256, 4).sum(-1)
    sf = sf_tab[idx].astype(np.int64)
    return (small_tab[(sf[..., 0] & 15) * 9 + (sf[..., 1] & 15)].astype(
        np.int64), em, (sf[..., 0] | sf[..., 1]) >> 4)


def join(a, b):
    return a[0] + b[0], a[1] + b[1], a[2] | b[2]


def choice(s):
    """The kernel's choice(): from CB_ESC back to CB_SMALL with <=."""
    small, em, fl = s
    esc, mid = em & 0xFFFF, em >> 16
    m = ((fl & 4) == 0) & (mid <= esc)
    cb, cost = np.where(m, 2, 3), np.where(m, mid, esc)
    cb = np.where(((fl & 2) == 0) & (small <= cost), 1, cb)
    return np.where(fl & 1, cb, 0)


def k13_model(q, bt, fs):
    """csrc/codebook_choice.cu's warp schedule, the frames of one block
    type side by side -> cb [F, NB] int32: the row zeroed, lane l's runs
    over tuples 8l .. 8l+7 with a band's choice written where it ends
    inside the lane, the segmented scan of the tails over the lanes, the
    heads with the lane before's scan, the tails that do not go on."""
    bmap = K.band_map(fs)
    nb = T.unified_layout(fs)["nb"]
    sums = tuple_sums(q)
    out = np.full((q.shape[0], nb), -1, np.int64)
    for t in range(C.N_BLOCK_TYPES):
        rows = np.nonzero(bt == t)[0]
        if not rows.size:
            continue
        band = bmap[t].astype(np.int64)
        row = np.zeros((rows.size, nb), np.int64)
        zero = tuple(np.zeros(rows.size, np.int64) for _ in range(3))
        tails, heads, firsts = [], [], []
        for lane in range(32):
            mine = band[8 * lane:8 * lane + 8]
            run, head, first = zero, zero, True
            for s in range(8):
                run = join(run, tuple(x[rows, 8 * lane + s] for x in sums))
                if s < 7:
                    end = mine[s + 1] != mine[s]
                    if end and not first:
                        row[:, mine[s]] = choice(run)
                    if end and first:
                        head = run
                    first = first and not end
                    run = zero if end else run
            tails.append(run)
            heads.append(head)
            firsts.append(first)
        tail_band = band[8 * np.arange(32) + 7]
        for r in range(5):
            d = 1 << r
            tails = [join(tails[lane], tails[lane - d])
                     if lane >= d and tail_band[lane - d] == tail_band[lane]
                     else tails[lane] for lane in range(32)]
        for lane in range(32):
            cont_in = lane > 0 and band[8 * lane - 1] == band[8 * lane]
            cont_out = lane < 31 and band[8 * lane + 8] == band[8 * lane + 7]
            if not firsts[lane]:
                carry = tails[lane - 1] if cont_in else zero
                row[:, band[8 * lane]] = choice(join(heads[lane], carry))
            if not cont_out:
                row[:, band[8 * lane + 7]] = choice(tails[lane])
        out[rows] = row
    return out


# -- the CPU -----------------------------------------------------------------

@pytest.mark.parametrize("fs", RATES)
def test_band_map_gives_each_tuple_its_band(fs):
    lay = T.unified_layout(fs)
    bmap = K.band_map(fs)
    assert bmap.dtype == np.uint8 and bmap.shape == (C.N_BLOCK_TYPES, 256)
    assert bmap.flags.c_contiguous
    np.testing.assert_array_equal(bmap, lay["bin_band"][:, ::4])
    # every real band holds a tuple; no band of width 0 does
    for t in range(C.N_BLOCK_TYPES):
        np.testing.assert_array_equal(
            np.bincount(bmap[t], minlength=lay["nb"]), lay["width"][t] // 4)


def test_cb_small_never_ties_and_mid_can_tie_esc():
    """Wherever CB_SMALL is valid it is 1-3 bits under CB_MID and 2-4 under
    CB_ESC a tuple, so a band's first cheapest is never a tie with it; a
    CB_MID pair costs within -1 .. +2 bits of CB_ESC, so they can tie."""
    tups = np.array(list(itertools.product([-1, 0, 1], repeat=4)))
    q = np.zeros((len(tups), C.LONG_COEFFS), np.int64)
    q[:, :4] = tups
    c = sent.payload_costs(q, np.array([0, 4, C.LONG_COEFFS]))[0][:, 0]
    assert (c[:, 1] < c[:, 2]).all() and (c[:, 1] < c[:, 3]).all()
    assert len(tie_tuples()) > 0


@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("fs", RATES)
def test_plain_equals_the_entropy_stage_the_spec_and_the_model(fs, frames):
    q, amp, gain, bt = make_inputs(frames, fs, 11 * frames + fs)
    got = K.codebook_choice(q, amp, gain, bt, fs)
    assert [t.dtype for t in got] == [torch.int16, torch.int8, torch.int16,
                                      torch.int8, torch.int8]
    cb, _ = entropy.payload_costs_and_choice(q, bt, fs)
    for g, want in zip(got, (q.to(torch.int16), amp.to(torch.int8),
                             gain.to(torch.int16), bt.to(torch.int8),
                             cb.to(torch.int8))):
        assert torch.equal(g, want)
    # the values survive the narrow types
    for g, wide in zip(got, (q, amp, gain, bt, cb)):
        assert torch.equal(g.to(torch.int32), wide.to(torch.int32))
    qn, btn = q.numpy(), bt.numpy()
    np.testing.assert_array_equal(got[4].numpy(), spec_choice(qn, btn, fs))
    np.testing.assert_array_equal(got[4].numpy(), k13_model(qn, btn, fs))
    # and the JAX package's choice (imported here: the card's machine runs
    # this file's cuda cases without JAX)
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import entropy as jent
    cb_j, _ = jent.payload_costs_and_choice(jnp.asarray(qn),
                                            jnp.asarray(btn), fs)
    np.testing.assert_array_equal(got[4].numpy(), np.asarray(cb_j))


@pytest.mark.parametrize("fs", RATES)
def test_the_cases_reach_every_codebook_tie_and_magnitude(fs):
    """At 2586 frames every block type's bands take each codebook, the
    CB_MID = CB_ESC tie is broken to CB_MID, bands are all zero, and |q|
    takes each special magnitude."""
    q, _, _, bt = (t.numpy() for t in make_inputs(2586, fs, 11 * 2586 + fs))
    lay = T.unified_layout(fs)
    assert set(np.unique(np.abs(q))) >= set(SPECIAL)
    cb = spec_choice(q, bt, fs)
    for t in range(C.N_BLOCK_TYPES):
        rows = bt == t
        real = lay["width"][t] > 0
        costs, valid = sent.payload_costs(q[rows].astype(np.int64),
                                          lay["edges"][t])
        costs, valid, got = costs[:, real], valid[:, real], cb[rows][:, real]
        assert set(np.unique(got)) == {0, 1, 2, 3}, t
        tie = valid[..., 2] & (costs[..., 2] == costs[..., 3]) \
            & ~valid[..., 1]
        assert tie.sum() > 0 and (got[tie] == 2).all(), t
        assert valid[..., 0].any(), t                     # all-zero bands
        # bands of width 0 read 0
        assert (cb[rows][:, ~real] == 0).all()


def test_plain_runs_on_the_cpu_path_and_counts_no_kernel(monkeypatch):
    """decide_chunk on CPU tensors takes the plain version, and
    `choice.kernel` counts nothing."""
    calls = []
    orig = K.codebook_choice_plain

    def rec(*a):
        calls.append(a[0].shape)
        return orig(*a)
    monkeypatch.setattr(K, "codebook_choice_plain", rec)
    counted = trace.counters().get("choice.kernel", 0)
    t = np.arange(44100 // 4) / 44100
    x = np.stack([0.3 * np.sin(2 * np.pi * 440 * t)] * 2, 1).astype(
        np.float32)
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    encoder.encode(x, cfg, device="cpu")
    nf = C.frames_for_samples(x.shape[0])
    spans = encoder.chunk_spans(nf, cfg.channels)
    assert calls == [(cfg.channels * s, C.LONG_COEFFS) for _, s in spans]
    assert trace.counters().get("choice.kernel", 0) == counted


def test_wrapper_refuses_what_the_kernel_cannot_take():
    q, amp, gain, bt = make_inputs(4, 44100, 3)
    with pytest.raises(ValueError, match="int32"):
        K.codebook_choice_kernel(q, amp, gain, bt, 44100)      # on the CPU
    with pytest.raises(ValueError, match="no codebook choice"):
        K.codebook_choice(q.to("meta"), amp, gain, bt, 44100)


# -- the card ----------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")


def on_card(args, fs):
    """K13 on the card -> (its outputs on the host, launches it made,
    `choice.kernel` counted); any synchronize inside raises (a first call
    has loaded the library and put the tables on the card)."""
    dev = [a.cuda() for a in args]
    K.codebook_choice(*dev, fs)
    torch.cuda.synchronize()
    launches, counted = K.launches, trace.counters().get("choice.kernel", 0)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = K.codebook_choice(*dev, fs)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return ([t.cpu() for t in got], K.launches - launches,
            trace.counters().get("choice.kernel", 0) - counted)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", FRAMES)
@pytest.mark.parametrize("fs", RATES)
def test_kernel_equals_plain_on_card(fs, frames):
    _need_card()
    args = make_inputs(frames, fs, 11 * frames + fs)
    got, launched, counted = on_card(args, fs)
    assert launched == 1 and counted == 1
    for g, want in zip(got, K.codebook_choice_plain(*args, fs)):
        assert g.dtype == want.dtype and torch.equal(g, want)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    _need_card()
    q, amp, gain, bt = (a.cuda() for a in make_inputs(8, 44100, 5))
    with pytest.raises(ValueError):
        K.codebook_choice_kernel(q.long(), amp, gain, bt, 44100)
    with pytest.raises(ValueError):
        K.codebook_choice_kernel(q, amp[:, :-1], gain, bt, 44100)
    with pytest.raises(ValueError):
        K.codebook_choice_kernel(q, amp.t().contiguous().t(), gain, bt,
                                 44100)
    buf = torch.zeros(8 * C.LONG_COEFFS + 4, dtype=torch.int32,
                      device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        K.codebook_choice_kernel(buf[1:8 * C.LONG_COEFFS + 1].view(8, -1),
                                 amp, gain, bt, 44100)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["clip", "batch"])
def test_kernel_on_the_cells_own_decisions(cell, monkeypatch):
    """The K4 outputs of the 30 s clip (one chunk of 2586 frame rows) and
    of the 64 x 10 s batch (7 chunks of 8192), captured at K13's wrapper
    during an encode: one launch and one `choice.kernel` a chunk, each ==
    the plain version."""
    _need_card()
    from mrcbench import gen
    from mrcaudiocodec_tpu_torch.models import codec
    caps = []
    orig = K.codebook_choice_kernel

    def rec(*a):
        caps.append(a)
        return orig(*a)
    monkeypatch.setattr(K, "codebook_choice_kernel", rec)
    counted = trace.counters().get("choice.kernel", 0)
    real = CodecConfig(fs=44100, channels=2, bitrate=128000)
    if cell == "clip":
        codec.encode(gen.to_i16(gen.music(44100, 30.0, 2, 0, 0)), real,
                     device="cuda")
    else:
        corpus.encode_batch(corpus._synth_corpus(64, 10.0), real,
                            device="cuda")
    chunks = 1 if cell == "clip" else 7
    assert len(caps) == chunks
    assert trace.counters().get("choice.kernel", 0) - counted == chunks
    for q, amp, gain, bt, fs in caps:
        assert q.shape == ((2586 if cell == "clip" else 8192),
                           C.LONG_COEFFS)
        got = orig(q, amp, gain, bt, fs)
        want = K.codebook_choice_plain(*(t.cpu() for t in (q, amp, gain,
                                                           bt)), fs)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
