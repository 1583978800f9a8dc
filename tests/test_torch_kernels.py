"""The port's main-path CUDA kernels: their plain versions against the
JAX package, and (on a card only) each kernel against its plain version.

K1 (ops/kernels/fft_stages.py) replaces the Pallas `_stages_kernel`; its
plain version must equal `xmath.fft_dif(xp=np)` bitwise at all four FFT
sizes. K2 (ops/kernels/quant_cost.py) replaces the Pallas
`_quant_kernel`; its plain version, plus the fixed and sf bits, must
equal the Pallas kernel run in interpret mode and the JAX XLA path
(`rd._bits_for_gains`) exactly. K3 (ops/kernels/record_pack.py) has no
Pallas counterpart; its plain version is held against the JAX
`pack_records_device` in tests/test_torch_device_pack.py, and here (on a
card) the kernel against it for stream orders that are in turn, shuffled
or skipping, at record counts around a warp and a tile and up to 65536.
K4 (ops/kernels/rd_loop.py) has no Pallas counterpart either; its plain
version `rd.rd_loop_plain` is held against the JAX and spec RD loops in
tests/test_torch_rd_loop.py, and here (on a card) the kernel against it at
1, 31, 4096 and 8192 frames, all three rates, the RD corners and 20
repeats, and its |q|^(4/3) table built on the card against the CPU's.
K5-K8, the analysis stage's kernels (transients, analysis_pre, mdct_post,
psycho), have no Pallas counterpart either; their plain versions are held
to the eager chain and the JAX package's jit A in
tests/test_torch_analysis.py, and here (on a card) each kernel to its
plain version at all three rates, int16 and float32 rows, both windows,
window switching and full psycho on and off, silent and transient-dense
chunks. K9 and K10 (synth_pre, synth_post), the decoder's synthesis
around K1, have no Pallas counterpart either; their plain versions are
held to the JAX package's decoder jit in tests/test_torch_synthesis.py,
and here (on a card) each kernel to its plain version at 1, 31, 538 and
2048 frame rows on music, silent, all-SHORT and edge records (q over the
int16 range, exponents whose steps wrap to inf and NaN), non-finite
transforms, K10 at 1, 2 and 3 rows with the previous chunk's tail null,
real or non-finite, bad inputs, the card decode's
launch counts and the 30 s decode's one download.
Tests marked `cuda` need a card and skip here; the machine with the card
has no JAX, so this module imports JAX only inside the tests that compare
against it, and there the tests run as `MRC_TESTS_KEEP_TPU=1 python -m
pytest tests/test_torch_kernels.py -m cuda` (the variable skips conftest's
JAX set-up).
"""
import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu import config as JC
from mrcaudiocodec_tpu import tables as JT
from mrcaudiocodec_tpu import xmath as jxmath

from mrcaudiocodec_tpu_torch.ops import entropy, rd
from mrcaudiocodec_tpu_torch.ops import device_pack
from mrcaudiocodec_tpu_torch.ops.kernels import (analysis_pre, fft_stages,
                                                 mdct_post, psycho,
                                                 quant_cost, rd_loop,
                                                 record_pack, synth_post,
                                                 synth_pre, transients)

torch.set_num_threads(1)


def _shape(n, rows):
    return (rows, n) if n >= 512 else (rows, 8, n)


def _bits32(a):
    return np.asarray(a, np.float32).view(np.int32)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")


@pytest.mark.parametrize("n", fft_stages.FFT_SIZES)
def test_fft_plain_matches_jax_fft_dif(n):
    rng = np.random.default_rng(n)
    shape = _shape(n, 33)
    zr = rng.standard_normal(shape).astype(np.float32)
    zi = rng.standard_normal(shape).astype(np.float32)
    ar, ai = jxmath.fft_dif(zr, zi, np)
    pr, pi = fft_stages.fft(torch.from_numpy(zr), torch.from_numpy(zi))
    np.testing.assert_array_equal(_bits32(pr.numpy()), _bits32(ar))
    np.testing.assert_array_equal(_bits32(pi.numpy()), _bits32(ai))
    assert fft_stages.lanes_for(n) in (512, 1024)


def test_fft_kernel_rejects_cpu_and_bad_shapes():
    z = torch.zeros(4, 512)
    with pytest.raises(ValueError):
        fft_stages.fft_kernel(z, z)              # CPU tensor: no kernel
    with pytest.raises(ValueError):
        fft_stages.fft_kernel(torch.zeros(4, 256), torch.zeros(4, 256))


def _jax_frames(nf, seed, fs=44100):
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import dsp as jdsp
    rng = np.random.default_rng(seed)
    fr = (0.3 * rng.standard_normal((nf, JC.LONG_SIZE))).astype(np.float32)
    bt = rng.integers(0, 5, nf).astype(np.int32)
    coeffs = np.array(jdsp.analyze(jnp.asarray(fr), jnp.asarray(bt)))
    return coeffs, bt, rng


def _port_bits(coeffs, amp, gains, bt, fs=44100):
    x, a, g, b = (torch.from_numpy(np.ascontiguousarray(v))
                  for v in (coeffs, amp, gains, bt))
    amp_bin = entropy.amp_to_bins(a, b, fs).contiguous()
    return rd.bits_for_gains(x, a, g, b, fs, amp_bin).numpy()


@pytest.mark.parametrize("case", ["g32_zero_amp", "g4_random_amp"])
def test_quant_plain_matches_pallas_interpret(case):
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import rd as jrd
    from mrcaudiocodec_tpu.ops.pallas import quant_kernel
    nf = 32
    coeffs, bt, rng = _jax_frames(nf, 1 if case.startswith("g32") else 3)
    nb = JT.unified_layout(44100)["nb"]
    if case == "g32_zero_amp":
        amp = np.zeros((nf, nb), np.int32)
        gains = np.broadcast_to(jrd.COARSE[None, :], (nf, 32)).copy()
    else:
        amp = rng.integers(0, 12, (nf, nb)).astype(np.int32)
        gains = rng.integers(30, 70, (nf, 4)).astype(np.int32)
    ref = np.asarray(quant_kernel.bits_for_gains(
        jnp.asarray(coeffs), jnp.asarray(amp), jnp.asarray(gains),
        jnp.asarray(bt), 44100, interpret=True))
    np.testing.assert_array_equal(_port_bits(coeffs, amp, gains, bt), ref)


@pytest.mark.parametrize("g", [1, 8])
def test_quant_plain_matches_xla_path(g):
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import rd as jrd
    nf = 40
    coeffs, bt, rng = _jax_frames(nf, 10 + g)
    nb = JT.unified_layout(44100)["nb"]
    amp = rng.integers(0, JC.AMP_MAX + 1, (nf, nb)).astype(np.int32)
    gains = rng.integers(0, 256, (nf, g)).astype(np.int32)
    ref = np.asarray(jrd._bits_for_gains(
        jnp.asarray(coeffs), jnp.asarray(amp), jnp.asarray(gains),
        jnp.asarray(bt), 44100))
    np.testing.assert_array_equal(_port_bits(coeffs, amp, gains, bt), ref)


def test_quant_kernel_rejects_cpu():
    z = torch.zeros(2, 1024)
    zi = torch.zeros(2, 1024, dtype=torch.int32)
    g = torch.zeros(2, 4, dtype=torch.int32)
    b = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        quant_cost.payload_bits_kernel(z, zi, g, b, 44100)


@pytest.mark.cuda
@pytest.mark.parametrize("n", fft_stages.FFT_SIZES)
def test_fft_kernel_matches_plain_on_card(n):
    _need_card()
    rng = np.random.default_rng(100 + n)
    shape = _shape(n, 257)
    zr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    zi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before = fft_stages.launches
    kr, ki = fft_stages.fft(zr.cuda(), zi.cuda())
    assert fft_stages.launches == before + 1
    pr, pi = fft_stages.fft_plain(zr, zi)
    assert torch.equal(kr.cpu().view(torch.int32), pr.view(torch.int32))
    assert torch.equal(ki.cpu().view(torch.int32), pi.view(torch.int32))


def _fft_edge_input(case, shape, rng):
    """re, im of `shape` for one K1 edge case (no NaN or inf)."""
    if case == "pos_zero":
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32)
    if case == "neg_zero":
        z = np.full(shape, -0.0, np.float32)
        return z, z.copy()
    if case == "mixed_zero":
        return tuple(np.where(rng.random(shape) < 0.5, -0.0, 0.0
                              ).astype(np.float32) for _ in range(2))
    # subnormals, some beside zeros and normal values
    sub = (rng.integers(-2 ** 20, 2 ** 20, (2,) + shape)
           * np.float64(2.0 ** -149)).astype(np.float32)
    mix = rng.standard_normal((2,) + shape).astype(np.float32)
    pick = rng.random((2,) + shape)
    out = np.where(pick < 0.6, sub, np.where(pick < 0.8, -0.0, mix))
    return out[0].astype(np.float32), out[1].astype(np.float32)


def _fft_card_vs_plain(zr, zi):
    zr, zi = torch.from_numpy(zr), torch.from_numpy(zi)
    before = fft_stages.launches
    kr, ki = fft_stages.fft(zr.cuda(), zi.cuda())
    assert fft_stages.launches == before + 1
    pr, pi = fft_stages.fft_plain(zr, zi)
    assert torch.equal(kr.cpu().view(torch.int32), pr.view(torch.int32))
    assert torch.equal(ki.cpu().view(torch.int32), pi.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["pos_zero", "neg_zero", "mixed_zero",
                                  "subnormal"])
@pytest.mark.parametrize("n", fft_stages.FFT_SIZES)
def test_fft_kernel_edge_values_on_card(n, case):
    _need_card()
    rng = np.random.default_rng(n * 13 + len(case))
    _fft_card_vs_plain(*_fft_edge_input(case, _shape(n, 257), rng))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 257, 2600])
@pytest.mark.parametrize("n", fft_stages.FFT_SIZES)
def test_fft_kernel_row_counts_on_card(n, rows):
    """Row counts that leave the last block ragged (1, 257) or span many
    blocks (2600)."""
    _need_card()
    rng = np.random.default_rng(rows + n)
    shape = _shape(n, rows)
    _fft_card_vs_plain(rng.standard_normal(shape).astype(np.float32),
                       rng.standard_normal(shape).astype(np.float32))


def _mag_edges(e):
    """Per magnitude m in (1, 2, 5, 16, 4095): the smallest positive f32
    whose quantized magnitude at exponent e is >= m, by bisection over the
    f32 bit patterns with the plain quantizer; with each the f32 below it
    (magnitude m - 1, or 4094 and 4095 at the clamp)."""
    from mrcaudiocodec_tpu_torch.ops import quantize
    want = np.array([1, 2, 5, 16, JC.QMAX])
    lo = np.zeros(len(want), np.int64)
    hi = np.full(len(want), 0x7F000000, np.int64)
    e_bin = torch.full((len(want),), e, dtype=torch.int32)
    while (lo < hi).any():
        mid = (lo + hi) // 2
        x = torch.from_numpy(mid.astype(np.int32).view(np.float32))
        up = quantize.quantize(x, e_bin).numpy() >= want
        hi = np.where(up & (lo < hi), mid, hi)
        lo = np.where(~up & (lo < hi), mid + 1, lo)
    at = lo.astype(np.int32).view(np.float32)
    below = (lo - 1).astype(np.int32).view(np.float32)
    far = at[-1:] * np.float32(4.0)          # past the clamp, a stays finite
    return np.concatenate([at, below, far])


def _quant_edge_input(case, fs, nf, g, rng):
    """x, amp_bin, gains, bt for one K2 edge case (no NaN or inf)."""
    lay = JT.unified_layout(fs)
    nb = lay["nb"]
    bt = (np.arange(nf) % 5).astype(np.int32)
    amp = rng.integers(0, JC.AMP_MAX + 1, (nf, nb)).astype(np.int32)
    gains = rng.integers(0, 256, (nf, g)).astype(np.int32)
    x = (rng.standard_normal((nf, 1024))
         * 10.0 ** rng.uniform(-3, 2.5, (nf, 1))).astype(np.float32)
    if case == "zeros":
        x[0] = 0.0                                     # an all-zero frame
        x[1] = -0.0
        for f in range(2, nf):                          # zero bands
            band = lay["bin_band"][bt[f]]
            x[f, (band % 3 == 0)] = 0.0
    elif case == "mag_edges":
        amp[:] = 0                                     # e = gain
        e = int(rng.integers(60, 200))
        gains[:] = e
        vals = _mag_edges(e)
        x = np.resize(vals, (nf, 1024)).astype(np.float32)
        x = np.where(rng.random((nf, 1024)) < 0.5, -x, x).astype(np.float32)
        for f in range(nf):
            x[f] = np.roll(x[f], f)
    elif case == "tiny":
        pick = rng.random((nf, 1024))
        sub = (rng.integers(-2 ** 23 + 1, 2 ** 23, (nf, 1024))
               * np.float64(2.0 ** -149)).astype(np.float32)
        x = np.where(pick < 0.4, sub, np.where(pick < 0.6, np.float32(-0.0),
                                               x)).astype(np.float32)
        amp[:] = 0
        gains[:] = rng.integers(0, 40, (nf, g))        # the finest steps
    elif case == "clip":
        # gain - amp below 0 and above 255: e clips at 0 and at 255
        gains = rng.choice(np.array([-40, 0, 3, 255, 260, 400], np.int32),
                           (nf, g)).astype(np.int32)
    elif case == "per_bin_amp":
        # amp_bin that differs inside a tuple: the kernel's per-bin steps
        return x, rng.integers(0, JC.AMP_MAX + 1, (nf, 1024)).astype(
            np.int32), gains, bt
    amp_bin = np.take_along_axis(amp, lay["bin_band"][bt], 1)
    return x, amp_bin.astype(np.int32), gains, bt


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3, 4, 5, 8, 32])
@pytest.mark.parametrize("fs", [44100, 48000, 32000])
@pytest.mark.parametrize("case", ["zeros", "mag_edges", "tiny", "clip",
                                  "per_bin_amp"])
def test_quant_kernel_edge_cases_on_card(case, fs, g):
    """7 frames: blocks of 4 / G frames at G < 4 are left ragged."""
    _need_card()
    rng = np.random.default_rng(g * 31 + fs + len(case))
    args = [torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for v in _quant_edge_input(case, fs, 7, g, rng)]
    before = quant_cost.launches
    got = quant_cost.payload_bits(*args, fs)
    assert quant_cost.launches == before + 1
    want = quant_cost.payload_bits_plain(*[a.cpu() for a in args], fs)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_quant_kernel_rejects_unaligned_on_card():
    _need_card()
    buf = torch.zeros(2 * 1024 + 4, device="cuda")
    x = buf[1:2 * 1024 + 1].view(2, 1024)
    a = torch.zeros(2, 1024, dtype=torch.int32, device="cuda")
    g = torch.zeros(2, 4, dtype=torch.int32, device="cuda")
    b = torch.zeros(2, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        quant_cost.payload_bits_kernel(x, a, g, b, 44100)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [32, 8, 4, 1])
@pytest.mark.parametrize("fs", [44100, 48000, 32000])
def test_quant_kernel_matches_plain_on_card(g, fs):
    _need_card()
    rng = np.random.default_rng(g * 7 + fs)
    nf = 64
    nb = JT.unified_layout(fs)["nb"]
    x = (rng.standard_normal((nf, 1024))
         * 10.0 ** rng.uniform(-3, 2.5, (nf, 1))).astype(np.float32)
    bt = (np.arange(nf) % 5).astype(np.int32)
    amp = rng.integers(0, JC.AMP_MAX + 1, (nf, nb)).astype(np.int32)
    amp_bin = np.take_along_axis(amp, JT.unified_layout(fs)["bin_band"][bt], 1)
    gains = rng.integers(0, 256, (nf, g)).astype(np.int32)
    args = [torch.from_numpy(np.ascontiguousarray(v)).cuda()
            for v in (x, amp_bin, gains, bt)]
    before = quant_cost.launches
    got = quant_cost.payload_bits(*args, fs)
    assert quant_cost.launches == before + 1
    want = quant_cost.payload_bits_plain(*[a.cpu() for a in args], fs)
    assert torch.equal(got.cpu(), want)


def _order(kind, nf, rng):
    """Stream order over nf records: all in turn, shuffled, or skipping
    about a third (as the corpus batch's pad frames are skipped), shuffled."""
    if kind == "identity":
        return np.arange(nf, dtype=np.int32)
    if kind == "shuffled":
        return rng.permutation(nf).astype(np.int32)
    keep = np.flatnonzero(rng.random(nf) < 0.66)
    return rng.permutation(keep if len(keep) else np.arange(1)
                           ).astype(np.int32)


def _decisions_for(nf, fs, seed):
    """random_decisions, tiled from at most 4096 records for speed."""
    base = record_pack.random_decisions(np.random.default_rng(seed),
                                        min(nf, 4096), fs)
    reps = -(-nf // len(base[0]))
    return [np.ascontiguousarray(np.concatenate([v] * reps)[:nf])
            for v in base]


def _pack_card_vs_plain(d, fs, cap, order=None):
    """K3 on the card == its plain version (on the CPU up to 4096 records,
    on the card above), body, nbytes and status. -> the plain nbytes."""
    cpu = [torch.from_numpy(np.ascontiguousarray(v)) for v in d]
    nf = cpu[0].shape[0]
    order = torch.from_numpy(np.arange(nf, dtype=np.int32) if order is None
                             else order)
    card = [t.cuda() for t in cpu]
    before = record_pack.launches
    body, nbytes, status = device_pack.pack_stream(*card, order.cuda(), fs,
                                                   cap)
    assert record_pack.launches == before + 1
    ref = cpu + [order] if nf <= 4096 else card + [order.cuda()]
    want_body, want_n, want_status = device_pack.pack_stream_plain(
        *ref, fs, cap)
    total = int(want_status[0])
    assert torch.equal(status, want_status)
    assert torch.equal(nbytes.cpu(), want_n.cpu())
    assert torch.equal(body[:total].cpu(), want_body[:total].cpu())
    return want_n.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["identity", "shuffled", "skipping"])
@pytest.mark.parametrize("nf", [1, 7, 8, 9, 31, 32, 33, 300, 8192, 65536])
@pytest.mark.parametrize("fs", [44100, 48000, 32000])
def test_record_pack_kernel_matches_plain_on_card(fs, nf, kind):
    """Random decisions: every codebook, block type, escapes up to QMAX;
    one record, a tile (8 records at this cap) and one either side, a
    warp's worth either side, and long look-back chains."""
    _need_card()
    assert record_pack.warps_per_block(2048) == 8
    d = _decisions_for(nf, fs, fs + nf)
    order = _order(kind, nf, np.random.default_rng(nf + len(kind)))
    _pack_card_vs_plain(d, fs, 2048, order)


@pytest.mark.cuda
@pytest.mark.parametrize("nf", [1, 300])
def test_record_pack_kernel_max_cap_on_card(nf):
    """At the largest cap one warp's two staging buffers take more than
    48 KB: a block of one warp, with the opt-in to more shared memory."""
    _need_card()
    cap = record_pack.MAX_CAP_BYTES
    assert record_pack.warps_per_block(cap) == 1
    assert (record_pack.STATIC_SMEM + record_pack.dyn_smem(cap, 1)
            > record_pack.SMEM_LIMIT)
    d = _decisions_for(nf, 48000, nf)
    _pack_card_vs_plain(d, 48000, cap, _order("shuffled", nf,
                                              np.random.default_rng(nf)))


@pytest.mark.cuda
def test_record_pack_kernel_repeats_identical_on_card():
    """20 launches on one input give the same bytes (a race in the
    look-back would show as a moved or torn record)."""
    _need_card()
    fs, nf = 44100, 8192
    d = [torch.from_numpy(v).cuda() for v in _decisions_for(nf, fs, 11)]
    order = torch.from_numpy(_order("skipping", nf,
                                    np.random.default_rng(3))).cuda()
    first = device_pack.pack_stream(*d, order, fs, 2048)
    total = int(first[2][0])
    for _ in range(20):
        body, nbytes, status = device_pack.pack_stream(*d, order, fs, 2048)
        assert torch.equal(status, first[2])
        assert torch.equal(nbytes, first[1])
        assert torch.equal(body[:total], first[0][:total])
@pytest.mark.cuda
@pytest.mark.parametrize("case", ["zeros", "all_small", "all_mid",
                                  "max_escapes", "cap_exact"])
def test_record_pack_kernel_edge_cases_on_card(case):
    _need_card()
    fs = 44100
    rng = np.random.default_rng(len(case))
    q, amp, gain, bt, cb = record_pack.random_decisions(rng, 10, fs)
    lay = JT.unified_layout(fs)
    real = lay["width"][bt] > 0
    if case == "zeros":
        q[:] = 0
        cb[:] = 0
        amp[:] = 0
    elif case in ("all_small", "all_mid"):
        book, top = (1, 1) if case == "all_small" else (2, 4)
        cb[:] = np.where(real, book, 0)
        q[:] = rng.integers(-top, top + 1, q.shape)
    elif case == "max_escapes":
        cb[:] = np.where(real, 3, 0)
        q[:] = rng.choice(np.array([-JC.QMAX, JC.QMAX, 16, -16, 32]), q.shape)
        gain[:] = 255
        amp[:] = JC.AMP_MAX
    cap = 8192
    if case == "cap_exact":
        _, n = device_pack.pack_records_plain(
            *[torch.from_numpy(v) for v in (q, amp, gain, bt, cb)], fs, cap)
        cap = int(n.max())
    _pack_card_vs_plain((q, amp, gain, bt, cb), fs, cap)


@pytest.mark.cuda
def test_record_pack_kernel_raises_on_small_cap_and_bad_input():
    _need_card()
    fs = 44100
    d = [torch.from_numpy(v).cuda() for v in
         record_pack.random_decisions(np.random.default_rng(5), 6, fs)]
    order = torch.arange(6, dtype=torch.int32, device="cuda")
    _, n, status = device_pack.pack_stream(*d, order, fs, 2048)
    need = int(n.max())
    assert int(status[1]) == need
    with pytest.raises(ValueError, match="more than cap"):
        device_pack.pack_stream(*d, order, fs, need - 1)
    q, amp, gain, bt, cb = d
    buf = torch.zeros(6 * 1024 + 8, dtype=torch.int16, device="cuda")
    shifted = buf[1:6 * 1024 + 1].view(6, 1024)        # 2-byte offset
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        record_pack.pack_stream_kernel(shifted, amp, gain, bt, cb, order, fs,
                                       2048)
    with pytest.raises(ValueError, match="want contiguous"):
        record_pack.pack_stream_kernel(q.t().contiguous().t(), amp, gain,
                                       bt, cb, order, fs, 2048)
    with pytest.raises(ValueError, match="want contiguous"):
        record_pack.pack_stream_kernel(q, amp.cpu(), gain, bt, cb, order, fs,
                                       2048)
    with pytest.raises(ValueError, match="int32 order"):
        record_pack.pack_stream_kernel(q, amp, gain, bt, cb, order.cpu(), fs,
                                       2048)
    with pytest.raises(ValueError, match="int32 order"):
        record_pack.pack_stream_kernel(q, amp, gain, bt, cb, order.long(),
                                       fs, 2048)


@pytest.mark.cuda
@pytest.mark.parametrize("row_frames", [8192, 14])
def test_encode_launches_record_pack_on_card(monkeypatch, row_frames):
    """A card encode packs each chunk with one K3 launch and equals the CPU
    stream and the host packer's."""
    _need_card()
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec, encoder, packing
    rng = np.random.default_rng(9)
    x = np.clip(0.3 * rng.standard_normal((30000, 2)), -1, 1).astype(
        np.float32)
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    monkeypatch.setattr(encoder, "ENC_ROW_FRAMES", row_frames)
    chunks = len(encoder.chunk_spans(C.frames_for_samples(x.shape[0]), 2))
    assert (chunks == 1) == (row_frames == 8192)
    before = record_pack.launches
    bs = codec.encode(x, cfg, device="cuda")
    assert record_pack.launches == before + chunks
    assert bs == codec.encode(x, cfg, device="cpu")
    dec, nf = encoder.encode_arrays(x, cfg, device="cuda")
    assert bs == packing.pack_stream(dec, nf, x.shape[0], cfg)


def _rd_loop_inputs(rng, nf, fs, kind="music", device="cpu"):
    """numpy inputs of K4 (x, allowed, budget_content, bt, gain0, bits0)
    for nf frames: music-like spectra (a decaying envelope over the bins,
    random loudness), allowed noise a fraction of each band's energy, and
    budgets around a rate's mean; gain0/bits0 are the plain inner sweep's.
    kind: "music", "starved" (16 kbps stereo budgets), "lavish" (320
    kbps), "all_short", "silent_pad" (every third frame silent, budget 0),
    "outer_max" (allowed noise a millionth). The inner sweep runs on
    `device` (K2 on a card)."""
    lay = JT.unified_layout(fs)
    nb = lay["nb"]
    bt = rng.integers(0, 5, nf).astype(np.int32)
    if kind == "all_short":
        bt[:] = JC.SHORT
    env = np.exp(-np.arange(1024) / rng.uniform(60, 400, (nf, 1)))
    x = (rng.standard_normal((nf, 1024)) * env
         * 10.0 ** rng.uniform(-1, 3, (nf, 1))).astype(np.float32)
    e_bin = x.astype(np.float64) ** 2
    band = lay["bin_band"][bt]
    energy = np.zeros((nf, nb))
    np.add.at(energy, (np.arange(nf)[:, None], band), e_bin)
    allowed = (energy * 10.0 ** rng.uniform(-2.5, 1, (nf, nb))).astype(
        np.float32)
    kbps = {"starved": 16, "lavish": 320}.get(kind, 128)
    mean = kbps * 1000 * 1024 / fs / 2
    budgets = (mean * rng.uniform(0.3, 2.0, nf)).astype(np.int64)
    if kind == "outer_max":
        allowed = (allowed * np.float32(1e-6)).astype(np.float32)
    if kind == "silent_pad":
        pad = np.arange(nf) % 3 == 1
        x[pad], allowed[pad], budgets[pad], bt[pad] = 0.0, 0.0, 0, JC.LONG
    bc = torch.from_numpy(budgets - JC.FRAME_LEN_BITS - 7).to(torch.int32)
    xt, btt = torch.from_numpy(x).to(device), torch.from_numpy(bt).to(device)
    gain0, bits0 = rd.inner_gain_search(
        xt, torch.zeros((nf, nb), dtype=torch.int32, device=device),
        bc.to(device), btt, fs,
        torch.zeros((nf, 1024), dtype=torch.int32, device=device))
    return (x, allowed, bc.numpy(), bt, gain0.cpu().numpy(),
            bits0.cpu().numpy())


def _rd_loop_card_vs_plain(args, fs, plain_on_cpu=True):
    """K4 on the card == rd_loop_plain (on the CPU, or on the card for
    large batches), q, amp, gain and bits. -> the plain run's counts."""
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    card = [t.cuda() for t in cpu]
    before = rd_loop.launches
    got = rd.rd_loop(*card, fs)
    assert rd_loop.launches == before + 1
    ref = cpu if plain_on_cpu else card
    for g, w in zip(got, rd.rd_loop_plain(*ref, fs)):
        assert torch.equal(g.cpu(), w.cpu())
    return {k: v.cpu() for k, v in rd.loop_counts(*ref, fs).items()}


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [44100, 48000, 32000])
@pytest.mark.parametrize("nf", [1, 31, 4096, 8192])
def test_rd_loop_kernel_matches_plain_on_card(nf, fs):
    """One frame, a ragged few, and the main path's chunk sizes (nb 88 at
    44.1 and 48 kHz, 96 at 32 kHz)."""
    _need_card()
    args = _rd_loop_inputs(np.random.default_rng(nf + fs), nf, fs,
                           device="cuda")
    st = _rd_loop_card_vs_plain(args, fs, plain_on_cpu=nf <= 31)
    if nf >= 4096:
        assert st["outer"].max() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["starved", "lavish", "all_short",
                                  "silent_pad", "outer_max"])
def test_rd_loop_kernel_corners_on_card(kind):
    _need_card()
    fs = 48000 if kind == "starved" else 44100
    args = _rd_loop_inputs(np.random.default_rng(len(kind)), 300, fs, kind,
                           "cuda")
    st = _rd_loop_card_vs_plain(args, fs)
    if kind == "starved":
        assert st["fallbacks"].sum() > 0
    if kind == "outer_max":
        assert (st["outer"] == JC.OUTER_MAX - 1).any()
    if kind == "silent_pad":
        assert (st["outer"][1::3] == 0).all()


@pytest.mark.cuda
def test_rd_loop_kernel_repeats_identical_on_card():
    """20 launches on one input give the same outputs (the refine
    exchange through shared memory and the scan's barriers)."""
    _need_card()
    fs = 44100
    args = [torch.from_numpy(a).cuda() for a in
            _rd_loop_inputs(np.random.default_rng(3), 4096, fs,
                            device="cuda")]
    first = rd.rd_loop(*args, fs)
    for _ in range(20):
        for g, w in zip(rd.rd_loop(*args, fs), first):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_rd_loop_pow43_table_on_card_equals_cpu():
    """K4's |q|^(4/3) table built on the card by quantize.dequantize's
    torch ops, and the one the wrapper caches, equal the CPU-built table
    bit for bit."""
    _need_card()
    cpu = rd_loop.pow43_table("cpu")
    for card in (rd_loop.pow43_table("cuda"), rd_loop._dev_pow43("cuda:0")):
        assert card.is_cuda and card.shape == cpu.shape
        assert torch.equal(card.cpu().view(torch.int32),
                           cpu.view(torch.int32))


def test_rd_loop_kernel_rejects_cpu_and_bad_inputs():
    rng = np.random.default_rng(1)
    args = [torch.from_numpy(a) for a in _rd_loop_inputs(rng, 2, 44100)]
    with pytest.raises(ValueError, match="want contiguous"):
        rd_loop.rd_loop_kernel(*args, 44100)            # CPU tensors
    bad = list(args)
    bad[1] = args[1][:, :-1]                            # allowed [F, nb-1]
    with pytest.raises(ValueError, match="want contiguous"):
        rd_loop.check_inputs("k", *bad, JT.unified_layout(44100)["nb"],
                             False)
    bad = list(args)
    bad[4] = args[4].long()                             # gain0 int64
    with pytest.raises(ValueError, match="want contiguous"):
        rd_loop.check_inputs("k", *bad, JT.unified_layout(44100)["nb"],
                             False)
    rd_loop.check_inputs("k", *args, JT.unified_layout(44100)["nb"], False)


def _analysis_rows(fs, case, frames, seed):
    """Hop rows [2, (frames + 3) * 1024] of a chunk: "music" (tones,
    noise, a burst every ~0.12 s), "transient" (bursts every 1500
    samples, SHORT frames), "silent"; int16 unless "f32" is in case."""
    rng = np.random.default_rng(seed)
    n = (frames + 3) * 1024
    t = np.arange(n) / fs
    x = np.zeros((2, n), np.float32)
    if "silent" not in case:
        x[:] = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.02 * \
            rng.standard_normal((2, n))
        step = 1500 if "transient" in case else fs // 8
        for pos in range(700, n - 100, step):
            x[:, pos:pos + 40] += 0.7 * rng.standard_normal((2, 40))
    x = np.clip(x, -1, 1).astype(np.float32)
    if "f32" in case:
        return x
    return np.clip(np.round(x * 32768), -32768, 32767).astype(np.int16)


def _wrapper_inputs(name, device):
    """(dispatcher, kernel wrapper, plain version, args) of K1-K10 on
    small random inputs on `device`."""
    rng = np.random.default_rng(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if name in ("synth_pre", "synth_post"):
        args = tuple(t(a) for a in _synth_records(rng, 2, 3, 44100, "music"))
        if name == "synth_pre":
            return (synth_pre.synth_pre, synth_pre.synth_pre_kernel,
                    synth_pre.synth_pre_plain, args + (44100,))
        pre = synth_pre.synth_pre_plain(*args, 44100)
        return (synth_post.synth_post, synth_post.synth_post_kernel,
                synth_post.synth_post_plain,
                (*fft_stages.fft_plain(*pre[:2]),
                 *fft_stages.fft_plain(*pre[2:]), args[2], "sine", True))
    if name in ("transients", "analysis_pre", "mdct_post", "psycho"):
        a = t(_analysis_rows(44100, "transient", 5, 7))
        bt = transients.transients_plain(a, True)
        if name == "transients":
            return (transients.block_types, transients.transients_kernel,
                    transients.transients_plain, (a, True))
        if name == "analysis_pre":
            return (analysis_pre.analysis_pre,
                    analysis_pre.analysis_pre_kernel,
                    analysis_pre.analysis_pre_plain, (a, bt, "sine", "all"))
        pre = analysis_pre.analysis_pre_plain(a, bt, "sine")
        spec = [fft_stages.fft_plain(pre[i], pre[i + 1])
                for i in range(0, 8, 2)]
        btf = bt.reshape(-1)
        if name == "mdct_post":
            return (mdct_post.mdct_post, mdct_post.mdct_post_kernel,
                    mdct_post.mdct_post_plain, (*spec[0], *spec[1], btf))
        co = mdct_post.mdct_post_plain(*spec[0], *spec[1], btf)
        return (psycho.psycho, psycho.psycho_kernel, psycho.psycho_plain,
                (*spec[2], *spec[3], co, btf, 44100, True))
    if name == "fft_stages":
        z = rng.standard_normal((2, 512)).astype(np.float32)
        return (fft_stages.fft, fft_stages.fft_kernel, fft_stages.fft_plain,
                (t(z), t(-z)))
    if name == "quant_cost":
        x = rng.standard_normal((3, 1024)).astype(np.float32)
        return (quant_cost.payload_bits, quant_cost.payload_bits_kernel,
                quant_cost.payload_bits_plain,
                (t(x), t(np.zeros((3, 1024), np.int32)),
                 t(np.full((3, 4), 60, np.int32)),
                 t(np.arange(3, dtype=np.int32)), 44100))
    if name == "rd_loop":
        return (rd.rd_loop, rd_loop.rd_loop_kernel, rd.rd_loop_plain,
                tuple(t(a) for a in _rd_loop_inputs(rng, 3, 44100)) + (44100,))
    d = _decisions_for(5, 44100, 7)
    return (device_pack.pack_stream, record_pack.pack_stream_kernel,
            device_pack.pack_stream_plain,
            (*[t(v) for v in d], t(np.arange(5, dtype=np.int32)), 44100,
             4096))


@pytest.mark.parametrize("name", ["fft_stages", "quant_cost",
                                  "record_pack", "rd_loop", "transients",
                                  "analysis_pre", "mdct_post", "psycho",
                                  "synth_pre", "synth_post"])
def test_wrappers_launch_only_for_cuda_tensors(name, monkeypatch):
    """For CPU tensors the dispatcher takes the plain version and the
    kernel wrapper raises before its launch path (making the tensors'
    card current, the C entry, the launch count)."""
    mod = {"fft_stages": fft_stages, "quant_cost": quant_cost,
           "record_pack": record_pack, "rd_loop": rd_loop,
           "transients": transients, "analysis_pre": analysis_pre,
           "mdct_post": mdct_post, "psycho": psycho,
           "synth_pre": synth_pre, "synth_post": synth_post}[name]

    def reached(*a, **k):
        raise AssertionError("the launch path was reached")
    monkeypatch.setattr(torch.cuda, "device", reached)
    monkeypatch.setattr(mod, "_fn", reached)
    dispatch, kernel, plain, args = _wrapper_inputs(name, "cpu")
    before = mod.launches
    got, want = dispatch(*args), plain(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        kernel(*args)
    assert mod.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fft_stages", "quant_cost",
                                  "record_pack", "rd_loop", "transients",
                                  "analysis_pre", "mdct_post", "psycho",
                                  "synth_pre", "synth_post"])
def test_wrappers_launch_on_the_tensors_card(name):
    """Tensors on cuda:0 while cuda:1 is current: the kernel runs on the
    tensors' card and equals its plain version (needs two cards)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    dispatch, kernel, plain, args = _wrapper_inputs(name, "cuda:0")
    with torch.cuda.device(1):
        got = kernel(*args)
        torch.cuda.synchronize(0)
    want = plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name == "record_pack":
        total = int(want[2][0])
        got, want = ((got[0][:total],) + got[1:],
                     (want[0][:total],) + want[1:])
    for g, w in zip(got, want):
        assert g.device.index in (None, 0)
        assert torch.equal(g.cpu(), w.cpu())


ANALYSIS_CASES = [
    ("music", "sine", True, True), ("music f32", "sine", True, True),
    ("transient", "sine", True, True), ("transient f32", "kbd", True, True),
    ("music", "kbd", False, True), ("transient", "sine", True, False),
    ("silent", "sine", True, True), ("silent f32", "kbd", False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ANALYSIS_CASES,
                         ids=["-".join(map(str, c)) for c in ANALYSIS_CASES])
@pytest.mark.parametrize("fs", [44100, 48000, 32000])
def test_analysis_kernels_match_plain_on_card(fs, case):
    """K5-K8 against their plain versions on the card, bitwise: each on
    the plain outputs before it (K7 and K8 on K1's outputs), then the whole
    kernel path of encoder._analyze_chunk against the eager chain on the
    CPU, and repeated launches giving the same bits."""
    _need_card()
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import encoder
    kind, window, ws, full = case
    cfg = CodecConfig(fs=fs, channels=2, bitrate=128000, window=window,
                      window_switching=ws, full_psycho=full)
    a = torch.from_numpy(_analysis_rows(fs, kind, 300, fs)).cuda()

    def same(got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            g, w = g.cpu(), w.cpu()
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w)

    bt = transients.transients_plain(a, ws)
    same(transients.transients_kernel(a, ws), bt)
    pre = analysis_pre.analysis_pre_plain(a, bt, window)
    same(analysis_pre.analysis_pre_kernel(a, bt, window), pre)
    spec = [fft_stages.fft_kernel(pre[i], pre[i + 1]) for i in range(0, 8, 2)]
    btf = bt.reshape(-1)
    co = mdct_post.mdct_post_plain(*spec[0], *spec[1], btf)
    same(mdct_post.mdct_post_kernel(*spec[0], *spec[1], btf), co)
    args = (*spec[2], *spec[3], co, btf, fs, full)
    want = psycho.psycho_plain(*args)
    for _ in range(3):
        same(psycho.psycho_kernel(*args), want)
    same(encoder._analyze_chunk(a, cfg), encoder._analyze_chunk(a.cpu(), cfg))
    if "transient" in kind and ws:
        assert (bt == 2).any()


@pytest.mark.cuda
def test_psycho_kernel_alignment_on_card():
    """K8 reads its five float inputs with 16-byte loads and bt an int at a
    time: a bt view at any int offset is taken and gives the same bits, a
    float input off 16 bytes raises."""
    _need_card()
    fs = 44100
    a = torch.from_numpy(_analysis_rows(fs, "transient", 40, 3)).cuda()
    bt = transients.transients_plain(a, True).reshape(-1)
    pre = analysis_pre.analysis_pre_plain(a, bt.view(a.shape[0], -1), "sine")
    spec = [fft_stages.fft_plain(pre[i], pre[i + 1]) for i in range(0, 8, 2)]
    co = mdct_post.mdct_post_plain(*spec[0], *spec[1], bt)
    want = psycho.psycho_plain(*spec[2], *spec[3], co, bt, fs, True)
    buf = torch.zeros(bt.numel() + 1, dtype=torch.int32, device="cuda")
    bt1 = buf[1:]                                      # 4-byte offset
    bt1.copy_(bt)
    got = psycho.psycho_kernel(*spec[2], *spec[3], co, bt1, fs, True)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g.cpu().view(torch.int32),
                           w.cpu().view(torch.int32))
    fbuf = torch.zeros(co.numel() + 1, dtype=torch.float32, device="cuda")
    co1 = fbuf[1:].view(co.shape)
    co1.copy_(co)
    with pytest.raises(ValueError, match="16-byte aligned"):
        psycho.psycho_kernel(*spec[2], *spec[3], co1, bt, fs, True)


# ---------------------------------------------------------------------------
# K9 and K10: the decoder's synthesis
# ---------------------------------------------------------------------------


def _synth_records(rng, rows, s, fs, case):
    """A chunk's records as the decoder's slabs hold them: q int16 [rows,
    s, 1024], e_band int16 [rows, s, NB], bt int8 [rows, s]. "music":
    small q, exponents around the gain bias, every block type; "silent":
    q zero (signed zeros through the transforms); "short": every frame
    SHORT; "edge": q over the whole int16 range (-32768 and beyond QMAX,
    as a corrupt escape gives), exponents over the whole int16 range (the
    step's bit pattern wraps to huge, infinite and NaN values)."""
    nb = JT.unified_layout(fs)["nb"]
    shape = (rows, s, 1024)
    if case == "edge":
        q = rng.integers(-32768, 32768, shape)
        q[..., :8] = [-32768, 32767, 4095, -4095, 4096, -4096, 0, 1]
        e = rng.integers(-32768, 32768, (rows, s, nb))
        e[..., :4] = [0, 255, 127, 128]
    else:
        q = np.round(rng.standard_normal(shape) * rng.uniform(
            0, 40, (rows, s, 1)))
        q[rng.random(shape) < 0.01] *= 200
        if case == "silent":
            q[:] = 0
        e = rng.integers(90, 170, (rows, s, nb))
    bt = rng.integers(0, 5, (rows, s))
    if case == "short":
        bt[:] = 2
    return (q.astype(np.int16), e.astype(np.int16), bt.astype(np.int8))


def _same_bits(got, want, nan_payload=False):
    """Bitwise equality; with nan_payload a NaN equals any NaN (the CPU
    and the card make NaNs with other sign and payload bits)."""
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        g, w = g.cpu().contiguous(), w.cpu().contiguous()
        assert g.dtype == w.dtype and g.shape == w.shape
        if g.dtype == torch.float32:
            if nan_payload:
                assert torch.equal(g.isnan(), w.isnan())
                g, w = g.nan_to_num(0.0), w.nan_to_num(0.0)
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


SYNTH_SHAPES = [(1, 1), (1, 31), (2, 269), (2, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["music", "silent", "short", "edge"])
@pytest.mark.parametrize("shape", SYNTH_SHAPES,
                         ids=[f"{r}x{s}" for r, s in SYNTH_SHAPES])
def test_synthesis_kernels_match_plain_on_card(shape, case):
    """K9 on the records and K10 on K1's outputs of K9's plain outputs,
    each bitwise equal to its plain version on the card, at 1, 31, 538 and
    2048 frame rows, all three rates, both windows, f32 and int16 PCM;
    the whole card _synth_chunk equal to the CPU's (on the edge records,
    whose steps wrap to inf and NaN, a NaN equals any NaN: the devices
    make NaNs with other payloads); repeats identical."""
    _need_card()
    from mrcaudiocodec_tpu_torch.models import decoder
    rows, s = shape
    for fs, window in ((44100, "sine"), (48000, "kbd"), (32000, "sine")):
        rng = np.random.default_rng(rows * s + fs)
        recs = _synth_records(rng, rows, s, fs, case)
        args = tuple(torch.from_numpy(a).cuda() for a in recs)
        pre = synth_pre.synth_pre_plain(*args, fs)
        for _ in range(2):
            _same_bits(synth_pre.synth_pre_kernel(*args, fs), pre)
        spec = (*fft_stages.fft_kernel(*pre[:2]),
                *fft_stages.fft_kernel(*pre[2:]))
        for pcm16 in (False, True):
            want = synth_post.synth_post_plain(*spec, args[2], window, pcm16)
            for _ in range(2):
                _same_bits(synth_post.synth_post_kernel(
                    *spec, args[2], window, pcm16), want)
            cpu = [torch.from_numpy(a) for a in recs]
            _same_bits(decoder._synth_chunk(*args, fs, window, pcm16),
                       decoder._synth_chunk(*cpu, fs, window, pcm16),
                       nan_payload=case == "edge")


def _k10_tails(rng, rows, kind):
    """A previous chunk's tail [rows, 1024] f32: None, "real" (values a
    tail holds) or "special" (+0, -0, +-inf and NaN among them)."""
    if kind == "none":
        return None
    t = (rng.standard_normal((rows, 1024)) * 0.3).astype(np.float32)
    if kind == "special":
        t[:, 0::5] = 0.0
        t[:, 1::5] = -0.0
        t[:, 2::17] = np.inf
        t[:, 3::19] = -np.inf
        t[:, 4::23] = np.nan
    return torch.from_numpy(t).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("prev", ["none", "real", "special"])
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_synth_post_kernel_prev_and_rows_on_card(rows, prev):
    """K10 at R = 1, 2, 3 rows (row groups of 2: 3 rows leave one of 1),
    with the previous chunk's tail null, real or holding +-0, +-inf and
    NaN, f32 and int16: pcm (time-major),
    first and tail bitwise equal to the plain version's on the card; into
    a slice of a clip buffer too, leaving the rest of it as it was."""
    _need_card()
    rng = np.random.default_rng(rows * 10 + len(prev))
    for s, case in ((1, "music"), (7, "short"), (40, "music"),
                    (269, "silent")):
        recs = _synth_records(rng, rows, s, 44100, case)
        args = tuple(torch.from_numpy(a).cuda() for a in recs)
        pre = synth_pre.synth_pre_plain(*args, 44100)
        spec = (*fft_stages.fft_plain(*pre[:2]),
                *fft_stages.fft_plain(*pre[2:]))
        tail = _k10_tails(rng, rows, prev)
        for pcm16 in (False, True):
            want = synth_post.synth_post_plain(*spec, args[2], "kbd", pcm16,
                                               tail)
            got = synth_post.synth_post_kernel(*spec, args[2], "kbd",
                                               pcm16, tail)
            assert got[0].shape == (s * 1024, rows)
            _same_bits(got, want)
            clip = torch.full(((s + 2) * 1024, rows), 5,
                              dtype=want[0].dtype, device="cuda")
            got = synth_post.synth_post_kernel(
                *spec, args[2], "kbd", pcm16, tail, clip[1024:-1024])
            _same_bits((clip[1024:-1024],) + got[1:], want)
            assert (clip[:1024] == 5).all() and (clip[-1024:] == 5).all()
            if prev == "special" and not pcm16:
                assert want[0][:1024].isnan().any()


@pytest.mark.cuda
def test_synth_post_kernel_nonfinite_on_card():
    """K10 on transforms holding inf and NaN (what a corrupt stream's
    exponents can give), with and without a tail holding them too: int16
    and f32 PCM equal the plain version's on the card, clamp, rounding and
    the cast of a NaN included."""
    _need_card()
    rng = np.random.default_rng(3)
    rows, s = 2, 40
    bt = torch.from_numpy(rng.integers(0, 5, (rows, s)).astype(np.int8))
    planes = []
    for shape in ((rows * s, 512),) * 2 + ((rows * s, 8, 64),) * 2:
        a = (rng.standard_normal(shape) * 30).astype(np.float32)
        flat = a.reshape(-1)
        pick = rng.random(flat.size)
        flat[pick < 0.002] = np.inf
        flat[(pick >= 0.002) & (pick < 0.004)] = -np.inf
        flat[(pick >= 0.004) & (pick < 0.005)] = np.nan
        flat[(pick >= 0.005) & (pick < 0.1)] *= 1e4      # beyond the clamp
        planes.append(torch.from_numpy(a).cuda())
    bt = bt.cuda()
    for tail in (None, _k10_tails(rng, rows, "special")):
        for pcm16 in (True, False):
            want = synth_post.synth_post_plain(*planes, bt, "sine", pcm16,
                                               tail)
            got = synth_post.synth_post_kernel(*planes, bt, "sine", pcm16,
                                               tail)
            _same_bits(got, want)
            if pcm16:
                assert (want[0].cpu() == 32767).any()
                assert (want[0].cpu() == -32768).any()


@pytest.mark.cuda
def test_synthesis_kernels_reject_bad_inputs_on_card():
    _need_card()
    rng = np.random.default_rng(5)
    q, e, bt = (torch.from_numpy(a).cuda()
                for a in _synth_records(rng, 2, 5, 44100, "music"))
    with pytest.raises(ValueError):
        synth_pre.synth_pre_kernel(q.to(torch.int32), e, bt, 44100)
    with pytest.raises(ValueError):
        synth_pre.synth_pre_kernel(q, e[..., :-1].contiguous(), bt, 44100)
    with pytest.raises(ValueError):
        synth_pre.synth_pre_kernel(q, e, bt.cpu(), 44100)
    with pytest.raises(ValueError):
        synth_pre.synth_pre_kernel(q, e, bt, 32000)    # another band count
    pre = synth_pre.synth_pre_kernel(q, e, bt, 44100)
    with pytest.raises(ValueError):
        synth_post.synth_post_kernel(pre[2], pre[3], pre[0], pre[1], bt,
                                     "sine", False)        # families swapped
    spec = (*fft_stages.fft_kernel(*pre[:2]), *fft_stages.fft_kernel(*pre[2:]))
    with pytest.raises(ValueError):
        synth_post.synth_post_kernel(*spec, bt.reshape(-1), "sine", False)
    with pytest.raises(ValueError):
        synth_post.synth_post_kernel(*spec, bt.to(torch.int32), "sine", True)
    with pytest.raises(ValueError):                         # prev's rows
        synth_post.synth_post_kernel(*spec, bt, "sine", True,
                                     torch.zeros(1, 1024, device="cuda"))
    with pytest.raises(ValueError):                         # prev on host
        synth_post.synth_post_kernel(*spec, bt, "sine", True,
                                     torch.zeros(2, 1024))
    with pytest.raises(ValueError):                         # out's dtype
        synth_post.synth_post_kernel(
            *spec, bt, "sine", True, None,
            torch.empty(5 * 1024, 2, device="cuda"))
    with pytest.raises(ValueError):                         # out [R, n]
        synth_post.synth_post_kernel(
            *spec, bt, "sine", False, None,
            torch.empty(2, 5 * 1024, device="cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("dec_chunk", [1024, 7])
def test_decode_launches_synthesis_kernels_on_card(monkeypatch, dec_chunk):
    """codec.decode on the card runs K9 and K10 once a chunk and K1 twice,
    no other kernel, and equals the CPU decode bitwise (f32 and int16)."""
    _need_card()
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec, decoder
    from mrcaudiocodec_tpu_torch.spec import codec as spec
    monkeypatch.setattr(decoder, "DEC_CHUNK", dec_chunk)
    fs = 44100
    n = int(fs * 0.5)
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    x[n // 4:] = 0.0                       # silence across chunk seams
    x[n // 8:n // 8 + 64] += 0.5
    x = np.stack([x, 0.8 * x], 1)
    bs = spec.encode(x, CodecConfig(fs=fs, channels=2, bitrate=128000))
    nf = len(decoder.record_slabs(bs))
    mods = (fft_stages, quant_cost, record_pack, rd_loop, transients,
            analysis_pre, mdct_post, psycho, synth_pre, synth_post)
    for pcm_dtype in ("float32", "int16"):
        torch.cuda.synchronize()
        for m in mods:
            m.launches = 0
        y, _ = codec.decode(bs, device="cuda", pcm_dtype=pcm_dtype)
        torch.cuda.synchronize()
        counts = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in mods}
        assert counts == {**{m.__name__.rsplit(".", 1)[-1]: 0 for m in mods},
                          "synth_pre": nf, "synth_post": nf,
                          "fft_stages": 2 * nf}
        yc, _ = codec.decode(bs, device="cpu", pcm_dtype=pcm_dtype)
        assert y.dtype == yc.dtype
        if y.dtype == np.float32:
            y, yc = y.view(np.int32), yc.view(np.int32)
        np.testing.assert_array_equal(y, yc)


@pytest.mark.cuda
def test_30s_decode_launches_and_one_download_on_card():
    """The 30 s stereo clip's decode (2 chunks of 1024 and 269 frames) on
    the card: K9 x 2, K1 x 4 and K10 x 2 and no other kernel, and one
    device-to-host copy, the PCM already [n, channels]; f32 and int16 ==
    the CPU decode by bits."""
    _need_card()
    from torch.profiler import ProfilerActivity, profile
    from mrcbench import gen
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    bs = codec.encode(gen.to_i16(gen.music(44100, 30.0, 2, 0, 0)), cfg,
                      device="cuda")
    mods = (fft_stages, quant_cost, record_pack, rd_loop, transients,
            analysis_pre, mdct_post, psycho, synth_pre, synth_post)
    names = {m.__name__.rsplit(".", 1)[-1] for m in mods}
    for pcm_dtype in ("float32", "int16"):
        codec.decode(bs, device="cuda", pcm_dtype=pcm_dtype)   # warm-up
        torch.cuda.synchronize()
        for m in mods:
            m.launches = 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            y, _ = codec.decode(bs, device="cuda", pcm_dtype=pcm_dtype)
            torch.cuda.synchronize()
        counts = {m.__name__.rsplit(".", 1)[-1]: m.launches for m in mods}
        assert counts == {**{n: 0 for n in names}, "synth_pre": 2,
                          "synth_post": 2, "fft_stages": 4}
        events = [(e.key, e.count) for e in prof.key_averages()
                  if getattr(e, "self_device_time_total", 0) > 0]
        down = sum(c for k, c in events if "DtoH" in k or
                   "Device -> Host" in k)
        kernels = [(k, c) for k, c in events if "Memcpy" not in k
                   and "Memset" not in k]
        assert down == 1, events
        assert all(any(f"{n}_kernel" in k for n in names)
                   for k, _ in kernels), kernels
        assert y.shape == (30 * 44100, 2) and y.flags.c_contiguous
        yc, _ = codec.decode(bs, device="cpu", pcm_dtype=pcm_dtype)
        assert y.dtype == yc.dtype
        if y.dtype == np.float32:
            y, yc = y.view(np.int32), yc.view(np.int32)
        np.testing.assert_array_equal(y, yc)
