"""The bit-reservoir budgets: K12 (`ops/kernels/budget_scan.py`,
csrc/budget_scan.cu) and its plain version against the torch scan that
`reservoir.allocate` runs on the CPU and the NumPy spec's
`spec.reservoir.allocate`, bit for bit.

On the CPU: the plain version, which follows the kernel's decomposition
(runs a thread, a scan of the runs' maps, a replay), at 32 and 256 threads
and the kernel's own 512, over 1 .. 12920 frames, 1 .. 128 rows, every
kind of row frame count and PE edges; the corners each case reaches; a
model of the kernel's integer quantization and division. The `cuda`
cases hold the kernel to the plain version on the card: on the same
inputs, on both benchmark cells' own PE, one launch a call and no
synchronize.
"""
import types

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch import corpus, trace
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.ops import reservoir
from mrcaudiocodec_tpu_torch.ops.kernels import budget_scan
from mrcaudiocodec_tpu_torch.spec import reservoir as sres

# (mean_bits, cap): the 30 s clip's 128 kbps stereo, and a rate so low
# that lo = floor(3 * 0.3) = 0, so budgets of 0 occur
REAL = CodecConfig(fs=44100, channels=2, bitrate=128000)
RATES = {"128k": (int(REAL.mean_frame_bits), REAL.reservoir_cap),
         "tiny": (3, 18)}
FRAMES = [1, 31, 32, 33, 448, 1293, 12920]
ROWS = [1, 2, 128]
THREADS = [32, 256, budget_scan.THREADS]
NF = ["none", "all", "mixed", "one"]
PE = ["music", "zeros", "edges"]
F0, F1 = np.float32(0), np.float32(1)


def cfg_of(rate, on=True):
    mean_bits, cap = RATES[rate]
    return types.SimpleNamespace(mean_frame_bits=float(mean_bits),
                                 reservoir=on, reservoir_cap=cap)


def args_of(rate):
    mean_bits, cap = RATES[rate]
    return (mean_bits, *reservoir.desired_bounds(mean_bits), cap)


def make_pe(kind, rows, frames, seed):
    """[rows, frames] float32 PE. music: quiet stretches that fill the
    reservoir to its cap and loud bursts that drain it to 0; edges: PE
    below 0, -0, subnormal, just under and at 1 and 65535, above 65535 and
    +inf, with row 0 all zero (its mean PE is 1)."""
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return torch.zeros((rows, frames), dtype=torch.float32)
    f = np.arange(frames)
    loud = (f // 15) % 3 == 2
    pe = np.where(loud, rng.uniform(3000, 9000, (rows, frames)),
                  rng.uniform(0, 300, (rows, frames))).astype(np.float32)
    if kind == "edges":
        special = np.array([-5.0, -0.0, 1e-42, np.nextafter(F1, F0), 1.0,
                            np.nextafter(np.float32(65535), F0), 65535.0,
                            65536.5, 1e9,
                            np.inf, 123.75, -np.inf], np.float32)
        pe[:, ::3] = special[(f[::3] // 3) % special.size]
        pe[0] = 0.0
    return torch.from_numpy(pe)


def make_nf(kind, rows, frames, seed):
    if kind == "none":
        return None
    if kind == "all":
        return torch.full((rows,), frames, dtype=torch.int64)
    if kind == "one":
        return torch.ones(rows, dtype=torch.int64)
    nf = torch.from_numpy(np.random.default_rng(seed).integers(
        1, frames + 1, rows))
    nf[0] = frames
    return nf


def spec_rows(pe, nf, rate, rows):
    """The spec's budgets of the given rows' real frames."""
    cfg = cfg_of(rate)
    return {r: sres.allocate(pe[r, :pe.shape[1] if nf is None
                                 else int(nf[r])].numpy(), cfg)
            for r in rows}


@pytest.mark.parametrize("kind", PE)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("frames", FRAMES)
def test_plain_equals_the_torch_scan_and_the_spec(frames, rows, kind):
    pe = make_pe(kind, rows, frames, 7 * frames + rows)
    for nf_kind in NF:
        nf = make_nf(nf_kind, rows, frames, frames + rows)
        for rate in RATES:
            want = reservoir.allocate(pe, cfg_of(rate), nf)
            for threads in THREADS:
                got = budget_scan.budget_scan_plain(pe, nf, *args_of(rate),
                                                    threads=threads)
                assert got.dtype == torch.int64
                assert torch.equal(got, want), (nf_kind, rate, threads)
            # the spec encodes one row alone: its real frames
            for r, b in spec_rows(pe, nf, rate, {0, rows // 2,
                                                 rows - 1}).items():
                assert np.array_equal(want[r, :b.size].numpy(), b), (
                    nf_kind, rate, r)


def levels(desired, mean_bits, cap):
    """The reservoir level before each frame, by the spec's loop."""
    r, out = 0, []
    for d in desired:
        out.append(r)
        r = min(max(r + mean_bits - int(d), 0), cap)
    return np.array(out)


@pytest.mark.parametrize("rate", list(RATES))
def test_the_music_case_reaches_every_corner(rate):
    # budgets at lo and at hi, levels at 0 (after a drain) and at the cap;
    # at the tiny rate, budgets of 0
    mean_bits, lo, hi, cap = args_of(rate)
    pe = make_pe("music", 1, 1293, 1)
    b = budget_scan.budget_scan_plain(pe, None, *args_of(rate))[0].numpy()
    pe_q = reservoir.quantize_pe(pe)[0]
    desired = reservoir.desired_bits(pe_q, mean_bits, reservoir.mean_pe_exact(
        pe_q)).numpy()
    lv = levels(desired, mean_bits, cap)
    assert (b == lo).any() and (b == hi).any()
    assert (lv[1:] == 0).any() and (lv == cap).any()
    assert ((b < desired) & (lv == 0)).any()    # the reservoir ran dry
    if rate == "tiny":
        assert lo == 0 and (b == 0).any()


def test_an_all_zero_row_takes_lo_everywhere():
    pe = make_pe("edges", 2, 448, 3)
    mean_bits, lo, _, _ = args_of("128k")
    got = budget_scan.budget_scan_plain(pe, None, *args_of("128k"))
    assert torch.equal(got[0], torch.full((448,), lo, dtype=torch.int64))


def test_reservoir_off_gives_mean_bits_everywhere():
    pe = make_pe("music", 2, 1293, 5)
    mean_bits = RATES["128k"][0]
    got = reservoir.allocate(pe, cfg_of("128k", on=False))
    assert torch.equal(got, torch.full((2, 1293), mean_bits,
                                       dtype=torch.int64))
    assert np.array_equal(sres.allocate(pe[0].numpy(),
                                        cfg_of("128k", on=False)),
                          got[0].numpy())


def test_desired_bounds_are_the_specs_clamp():
    # the (lo, hi) K12 takes, against the spec's desired bits at PE 0, at
    # the mean and far above it
    for mean_bits in (0, 1, 3, 4, 1486, 2972, 7000):
        lo, hi = reservoir.desired_bounds(mean_bits)
        pe_q = np.array([0, 1, 10 ** 6])
        want = sres.desired_bits(pe_q, mean_bits, 1)
        assert want.tolist() == [lo, min(max(mean_bits, lo), hi), hi]
        assert reservoir.desired_bits(torch.from_numpy(pe_q), mean_bits,
                                      torch.tensor(1)).tolist() == \
            want.tolist(), mean_bits


# -- a model of the kernel's integer arithmetic -------------------------------

def quantize_bits(x: np.ndarray) -> np.ndarray:
    """csrc/budget_scan.cu quantize(): floor(clamp(x, 0, 65535)) from the
    bits of finite or infinite float32 x."""
    u = x.astype(np.float32).view(np.uint32).astype(np.int64)
    e = (u >> 23) - 127
    mant = (u & 0x7FFFFF) | 0x800000
    body = mant >> np.clip(23 - e, 0, 63)
    return np.where(u >> 31, 0, np.where(
        u >= 0x477FFF00, 65535, np.where(u < 0x3F800000, 0, body)))


def test_the_kernels_quantization_from_bits_is_floor_of_the_clamp():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-10, 70000, 200000).astype(np.float32),
        np.arange(0, 65537, dtype=np.float32),
        np.nextafter(np.arange(1, 65537, dtype=np.float32), np.float32(0)),
        np.array([0.0, -0.0, 1e-45, 1e-38, 0.5, np.inf, -np.inf, 3e38,
                  -3e38], np.float32)])
    want = reservoir.quantize_pe(torch.from_numpy(x)).numpy()
    assert np.array_equal(quantize_bits(x), want)


def div_bits(n: int, d: int) -> int:
    """csrc/budget_scan.cu div_bits(): restoring division, 64 steps."""
    q = r = 0
    for i in range(63, -1, -1):
        r = (r << 1) | ((n >> i) & 1)
        q <<= 1
        if r >= d:
            r -= d
            q |= 1
    return q


def divide(n: int, d: int, m: int) -> int:
    """csrc/budget_scan.cu divide(): a multiply-high by m = floor((2^64 -
    1) / d), then one correction."""
    q = (n * m) >> 64
    if n - q * d >= d:
        q += 1
    return q


def test_the_kernels_division_is_floor_division():
    rng = np.random.default_rng(1)
    ds = [1, 2, 3, 7, 445, 1486, 65534, 65535] + rng.integers(
        1, 65536, 24).tolist()
    for d in ds:
        m = div_bits((1 << 64) - 1, d)
        assert m == ((1 << 64) - 1) // d
        # the products a frame divides (mean_bits * pe_q) and the row's
        # sums (up to 65535 a frame): edges around multiples of d
        ns = [0, 1, d - 1, d, d + 1, 7000 * 65535, (1 << 62) + 5] + [
            k * d + e for k in rng.integers(0, 1 << 40, 8).tolist()
            for e in (-1, 0, 1) if k * d + e >= 0]
        for n in ns:
            assert divide(n, d, m) == n // d, (n, d)
            assert div_bits(n, d) == n // d, (n, d)


# -- the card ------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")


def on_card(pe, nf, rate):
    """K12 on the card -> (its budgets on the host, launches it made,
    `budget.kernel` counted); any synchronize inside raises."""
    launches, counted = budget_scan.launches, trace.counters().get(
        "budget.kernel", 0)
    pe_d = pe.cuda()
    nf_d = None if nf is None else nf.cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = reservoir.allocate(pe_d, cfg_of(rate), nf_d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return (got.cpu(), budget_scan.launches - launches,
            trace.counters().get("budget.kernel", 0) - counted)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", PE)
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("frames", FRAMES)
def test_kernel_equals_plain_on_card(frames, rows, kind):
    _need_card()
    pe = make_pe(kind, rows, frames, 7 * frames + rows)
    for nf_kind in NF:
        nf = make_nf(nf_kind, rows, frames, frames + rows)
        for rate in RATES:
            got, launched, counted = on_card(pe, nf, rate)
            assert launched == 1 and counted == 1
            want = budget_scan.budget_scan_plain(pe, nf, *args_of(rate))
            assert torch.equal(got, want), (nf_kind, rate)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    _need_card()
    pe = torch.zeros((2, 8), device="cuda")
    args = args_of("128k")
    with pytest.raises(ValueError):
        budget_scan.budget_scan_kernel(pe.double(), None, *args)
    with pytest.raises(ValueError):
        budget_scan.budget_scan_kernel(pe.t(), None, *args)
    with pytest.raises(ValueError):
        budget_scan.budget_scan_kernel(pe, torch.ones(2, dtype=torch.int32,
                                                      device="cuda"), *args)
    with pytest.raises(ValueError):
        budget_scan.budget_scan_kernel(pe, None, -1, 0, 0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["clip", "batch"])
def test_kernel_on_the_cells_own_pe(cell, monkeypatch):
    """The PE `_analyze_chunk` gives the 30 s clip ([2, 1293]) and the
    64 x 10 s batch ([128, 448], each row masked by its frame count),
    captured at the kernel's wrapper during an encode: one launch a
    request, == the plain version and the torch scan."""
    _need_card()
    from mrcbench import gen
    from mrcaudiocodec_tpu_torch.models import codec
    caps = []
    orig = budget_scan.budget_scan_kernel

    def rec(*a):
        caps.append(a)
        return orig(*a)
    monkeypatch.setattr(budget_scan, "budget_scan_kernel", rec)
    counted = trace.counters().get("budget.kernel", 0)
    if cell == "clip":
        codec.encode(gen.to_i16(gen.music(44100, 30.0, 2, 0, 0)), REAL,
                     device="cuda")
    else:
        corpus.encode_batch(corpus._synth_corpus(64, 10.0), REAL,
                            device="cuda")
    assert len(caps) == 1
    assert trace.counters().get("budget.kernel", 0) - counted == 1
    pe, nf, *args = caps[0]
    assert pe.shape == ((2, 1293) if cell == "clip" else (128, 448))
    assert (nf is None) == (cell == "clip")
    got = orig(pe, nf, *args).cpu()
    pe_h, nf_h = pe.cpu(), None if nf is None else nf.cpu()
    assert torch.equal(got, budget_scan.budget_scan_plain(pe_h, nf_h, *args))
    assert torch.equal(got, reservoir.allocate(pe_h, REAL, nf_h))
