"""The encoder's analysis stage as the port's kernels split it, on the CPU.

On the card `encoder._analyze_chunk` runs K5 (ops/kernels/transients.py),
K6 (analysis_pre.py), K1 (fft_stages.py), K7 (mdct_post.py) and K8
(psycho.py); a CPU tensor takes each kernel's plain version. Here that
split plain path (`encoder.analyze_split` on CPU tensors) must equal,
bitwise on every output (bt, coeffs, allowed, pe), the eager chain
(`encoder._analyze_chunk` on the CPU) and the JAX package's jit A
(`mrcaudiocodec_tpu.models.encoder._analyze_chunk`, on the CPU as its own
tests run it). The kernels' constant blobs are held value for value to
the JAX package's native blobs, and numpy models of two kernel schedules
(K8's in-place shared-memory scan, K5's warp tree and ladder) to the
plain DAG. The kernels themselves are held to these plain versions on a
card (tests/test_torch_kernels.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu import xmath as jxmath
from mrcaudiocodec_tpu import xpsy as jxpsy

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import xmath, xpsy
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import encoder
from mrcaudiocodec_tpu_torch.ops import dsp, psycho
from mrcaudiocodec_tpu_torch.ops.kernels import (analysis_pre, fft_stages,
                                                 mdct_post, transients)
from mrcaudiocodec_tpu_torch.ops.kernels import psycho as kpsycho

torch.set_num_threads(1)
F32 = np.float32


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits(got, ref):
    got, ref = _bits(got), _bits(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


def _signal(fs, seconds, kind, seed):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    if kind == "silent":
        return np.zeros((n, 2), F32)
    x = (0.35 * np.sin(2 * np.pi * 440 * t) + 0.12 * np.sin(
        2 * np.pi * 3100 * t) + 0.02 * rng.standard_normal(n)).astype(F32)
    step = fs // 9 if kind == "music" else 1500
    for pos in range(fs // 10, n - 200, step):
        x[pos:pos + 48] += (0.7 * rng.standard_normal(48)).astype(F32)
    x = np.clip(x, -1, 1)
    return np.stack([x, np.roll(x, 7) * np.float32(0.9)], 1)


def _chunk(fs, kind, dtype, seed=0, first=3, frames=13):
    """A chunk's hop rows [2, (frames + 3) * HOP] from frame `first` of a
    0.6 s stereo clip: both outer frames are real neighbours."""
    x = _signal(fs, 0.6, kind, seed)
    if dtype == "int16":
        x = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    nf = C.frames_for_samples(x.shape[0])
    P = encoder._padded_rows(x, nf)
    return np.ascontiguousarray(
        P[:, first * C.HOP:(first + frames + 3) * C.HOP])


# (fs, dtype, window, window switching, full psycho, signal)
CASES = [
    (44100, "int16", "sine", True, True, "music"),
    (32000, "int16", "sine", True, True, "music"),
    (48000, "int16", "sine", True, True, "music"),
    (44100, "float32", "sine", True, True, "music"),
    (44100, "int16", "kbd", True, True, "music"),
    (44100, "int16", "sine", False, True, "music"),
    (44100, "int16", "sine", True, False, "music"),
    (44100, "int16", "sine", True, True, "silent"),
    (44100, "int16", "sine", True, True, "transient"),
    (32000, "float32", "kbd", False, False, "transient"),
    (48000, "float32", "sine", True, False, "silent"),
    (48000, "int16", "kbd", True, True, "transient"),
]


def _ids(c):
    return "-".join([str(c[0]), c[1], c[2], "ws" if c[3] else "nows",
                     "full" if c[4] else "simple", c[5]])


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_split_path_equals_eager_and_jax(case):
    from mrcaudiocodec_tpu.models import encoder as jenc
    fs, dtype, window, ws, full, kind = case
    cfg = CodecConfig(fs=fs, channels=2, bitrate=128000, window=window,
                      window_switching=ws, full_psycho=full)
    a = _chunk(fs, kind, dtype, seed=fs)
    audio = torch.from_numpy(a)
    split = encoder.analyze_split(audio, cfg)
    eager = encoder._analyze_chunk(audio, cfg)
    jax_out = jenc._analyze_chunk(a, fs=fs, window_switching=ws,
                                  full_psycho=full, window=window)
    r, s = split[0].shape
    for got, ref, j in zip(split, eager, jax_out):
        assert_bits(got, ref)
        assert_bits(got.reshape(np.asarray(j).shape), np.asarray(j))
    if kind == "transient" and ws:
        assert (split[0] == C.SHORT).any()
    if kind == "silent":
        assert not (split[0] == C.SHORT).any()
    assert (r, s) == (2, 13)


def test_split_path_launches_nothing_on_the_cpu():
    """CPU tensors run the plain versions: no kernel count moves."""
    mods = (transients, analysis_pre, fft_stages, mdct_post, kpsycho)
    before = [m.launches for m in mods]
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    encoder.analyze_split(torch.from_numpy(_chunk(44100, "music", "int16")),
                          cfg)
    assert [m.launches for m in mods] == before


def test_strided_rows_equal_contiguous_rows():
    """The sharded path hands over a column slice of longer rows."""
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    whole = torch.from_numpy(_chunk(44100, "transient", "int16", first=0,
                                    frames=20))
    part = whole[:, 4 * C.HOP:(4 + 9 + 3) * C.HOP]
    assert not part.is_contiguous()
    got = encoder.analyze_split(part, cfg)
    ref = encoder._analyze_chunk(part.contiguous(), cfg)
    for g, r in zip(got, ref):
        assert_bits(g, r)


@pytest.mark.parametrize("part", ["mdct", "psycho"])
def test_frames_layout_equals_rows_layout(part):
    """analysis_pre on frames [F, 2048] (dsp.analyze, psycho.analyze)
    gives the rows layout's values for the same frames; dsp.analyze and
    psycho.analyze on the CPU are the eager chains."""
    a = torch.from_numpy(_chunk(44100, "transient", "float32"))
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    bt = transients.block_types(a, True)
    rows = analysis_pre.analysis_pre(a, bt, "kbd", part)
    fr = analysis_pre.frames_of(a, bt)
    frames = analysis_pre.analysis_pre(fr, bt.reshape(-1), "kbd", part)
    assert len(rows) == len(frames) == 4
    for g, r in zip(frames, rows):
        assert_bits(g, r)
    coeffs = dsp.analyze(fr, bt.reshape(-1), "kbd")
    if part == "mdct":
        spec = [fft_stages.fft(rows[i], rows[i + 1]) for i in (0, 2)]
        assert_bits(mdct_post.mdct_post(*spec[0], *spec[1], bt.reshape(-1)),
                    coeffs)
    else:
        spec = [fft_stages.fft(rows[i], rows[i + 1]) for i in (0, 2)]
        got = kpsycho.psycho(*spec[0], *spec[1], coeffs, bt.reshape(-1),
                             cfg.fs, True)
        for g, r in zip(got, psycho.analyze(fr, coeffs, bt.reshape(-1),
                                            cfg.fs, True)):
            assert_bits(g, r)


def test_wrappers_reject_cpu_tensors_and_bad_shapes():
    a = torch.from_numpy(_chunk(44100, "music", "int16"))
    bt = transients.block_types(a, True)
    with pytest.raises(ValueError):
        transients.transients_kernel(a, True)
    with pytest.raises(ValueError):
        analysis_pre.analysis_pre_kernel(a, bt, "sine")
    with pytest.raises(ValueError):
        analysis_pre.analysis_pre(a[:, :-C.HOP], bt, "sine")
    with pytest.raises(ValueError):
        analysis_pre.analysis_pre(a, bt, "sine", "neither")
    pre = analysis_pre.analysis_pre(a, bt, "sine")
    btf = bt.reshape(-1)
    with pytest.raises(ValueError):
        mdct_post.mdct_post_kernel(*pre[:4], btf)
    with pytest.raises(ValueError):
        kpsycho.psycho_kernel(*pre[4:], torch.zeros(btf.shape[0], 1024),
                              btf, 44100, True)
    with pytest.raises(ValueError):
        transients.block_types(a.reshape(1, -1)[:, :100], True)


# ---------------------------------------------------------------------------
# Constant blobs against the JAX package's native blobs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("long_block", [True, False])
@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_kernel_blobs_match_jax_ffi_blobs(fs, long_block):
    """kernel_blobs is ffi_blobs without the FFT stage twiddles (i32 blob
    whole; f32: hann, then from the untwist tables on)."""
    f32, i32 = xpsy.kernel_blobs(fs, long_block)
    jf, ji = jxpsy.ffi_blobs(fs, long_block)
    np.testing.assert_array_equal(i32, ji)
    n, h = int(ji[0]), int(ji[1])
    want = np.concatenate([jf[:n], jf[n + 2 * (h - 1):]])
    assert_bits(f32, want)
    assert f32.dtype == np.float32 and i32.dtype == np.int32


@pytest.mark.parametrize("m_size", [1024, 128])
def test_dct4_blob_matches_jax_ffi_table(m_size):
    """dct4_blob is ffi_table's pre, post and scale fields."""
    h = m_size // 2
    got = xmath.dct4_blob(m_size)
    jt = jxmath.ffi_table(m_size)
    want = np.concatenate([jt[:2 * h], jt[4 * h - 2:]])
    assert got.shape == (4 * h + 1,)
    assert_bits(got, want)


def test_kernel_consts_are_the_modules_roundings():
    c = xpsy.kernel_consts()
    assert c.dtype == np.float32 and c.shape == (66,)
    names = ("TINY", "LN2", "SQRT2")
    for i, nm in enumerate(names):
        assert c[i] == np.float32(getattr(jxpsy, nm))
    np.testing.assert_array_equal(c[3:16], np.asarray(jxpsy._LOG2_P, F32))
    np.testing.assert_array_equal(c[16:24], np.asarray(jxpsy._EXP_K, F32))
    tail = [jxpsy.SFM_FLOOR_REL, jxpsy.TMN_DB, jxpsy.NMT_DB,
            jxpsy._SIMPLE_FACTOR, jxpsy._TEN_LOG10_2, jxpsy._INV_NEG60,
            jxpsy._NEG_L210_10, np.float32(1e30), jxpsy._LOG2_INV_SMR_CEIL,
            jxpsy._LOG2_INV_SMR_FLOOR, jxpsy.ATTACK_RATIO, jxpsy.ATTACK_ABS]
    np.testing.assert_array_equal(c[24:36], np.asarray(tail, F32))
    np.testing.assert_array_equal(c[36:51], jxpsy._EPS_I)
    np.testing.assert_array_equal(c[51:66], jxpsy._INV_I)


# ---------------------------------------------------------------------------
# numpy models of the kernels' schedules, one f32 op at a time
# ---------------------------------------------------------------------------


def k8_scan_model(values, start, stages, threads=256):
    """csrc/xpsy_dev.cuh seg_scan as K8 runs it: shared memory of 4 *
    threads bins, thread t owning bins t + threads * j; each stage every
    thread reads its bins' sums (bin + bin - d where bin - d is in its
    segment) before a barrier and writes them after it."""
    s = np.array(values, F32)
    n = s.size
    assert n == 4 * threads
    d = 1
    for _ in range(stages):
        pending = []
        for t in range(threads):
            for j in range(4):
                k = t + threads * j
                if k - d >= start[k]:
                    pending.append((k, F32(s[k] + s[k - d])))
        for k, v in pending:            # after the barrier
            s[k] = v
        d *= 2
    return s


def _family_starts(fs, long_block, which):
    """K8's absolute segment starts over 1024 bins (group g's bins at
    g * H, H = 1024 or 128) and the segment ends, from kernel_blobs."""
    f32, i32 = xpsy.kernel_blobs(fs, long_block)
    n, h, npart, nb, pst, bst, groups = (int(v) for v in i32[:7])
    part_start = i32[8:8 + h]
    part_ends = i32[8 + h:8 + h + npart]
    band_start = i32[8 + h + npart:8 + 2 * h + npart]
    band_ends = i32[8 + 2 * h + npart:8 + 2 * h + npart + nb]
    seg, ends, st = ((part_start, part_ends, pst) if which == "part"
                     else (band_start, band_ends, bst))
    start = np.concatenate([g * h + seg for g in range(groups)])
    end = np.concatenate([g * h + ends for g in range(groups)])
    return start, end, st, h, groups


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k8_scan_model_equals_seg_sums(fs):
    """K8's in-place scan over the group-offset layout leaves, at every
    segment's end, xpsy.seg_sums' value: partitions and bands of both
    families, on power spectra with a wide dynamic range and on their
    xlog2 (negative values)."""
    rng = np.random.default_rng(fs)
    p = (rng.standard_normal(1024) ** 2 * 10.0 ** rng.uniform(-8, 6, 1024)
         ).astype(F32)
    lg = xpsy.xlog2(torch.from_numpy(p) + xpsy.TINY).numpy()
    for long_block in (True, False):
        cst = xpsy.psy_tables(fs, long_block)
        for which in ("part", "band"):
            start, end, stages, h, groups = _family_starts(fs, long_block,
                                                           which)
            edges = cst["part_edges" if which == "part" else "band_edges"]
            for v in (p, lg):
                got = k8_scan_model(v, start, stages)[end]
                want = xpsy.seg_sums(torch.from_numpy(v).reshape(groups, h),
                                     edges).reshape(-1)
                assert_bits(got, want)
    # the unified edges of e_mdct are the family's bands, then 0-width ones
    assert kpsycho.check_layout(fs) == \
        len(psycho.unified_band_edges(fs)[0]) - 1


def k5_attack_model(frame, cst):
    """csrc/transients.cu's attack for one extended frame: lane l's 4 bins
    of each 128-bin sub-block as (q1 + q0) + (q3 + q2), 5 shuffle-xor
    rounds (lane l adds lane l ^ o's sum), the 1-2-4-8 ladder with its
    zeros added, the EPS-in-numerator compare."""
    x = np.asarray(frame, F32)
    d = np.zeros(2048, F32)
    d[1:] = x[1:] - x[:-1]
    q = d * d
    eps_i, inv_i = cst[36:51], cst[51:66]
    ratio, absl = cst[34], cst[35]
    e = np.zeros(16, F32)
    for g in range(16):
        lanes = q[g * 128:(g + 1) * 128].reshape(32, 4)
        s = (lanes[:, 1] + lanes[:, 0]) + (lanes[:, 3] + lanes[:, 2])
        o = 1
        while o < 32:
            s = s + s[np.arange(32) ^ o]
            o *= 2
        assert (s == s[0]).all()
        e[g] = s[0]
    cs = e.copy()
    for step in (1, 2, 4, 8):
        sh = np.concatenate([np.zeros(step, F32), cs[:-step]])
        cs = cs + sh
    pm = (cs[:15] + eps_i) * inv_i
    thr = pm * ratio
    return bool(((e[1:] > thr) & (e[1:] > absl)).any())


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k5_tree_and_ladder_model_equals_transient_detect(fs):
    """K5's warp tree and ladder give xpsy.transient_detect's flags and
    its sub-block energies' exact values, at every rate's signals,
    including silence, a lone click and noise bursts."""
    cst = xpsy.kernel_consts()
    a = torch.from_numpy(_chunk(fs, "transient", "float32", seed=fs,
                                first=0, frames=20))
    frames = transients.hop_frames(a, 20, 0, 22).numpy()
    extra = np.zeros((3, 2048), F32)
    extra[1, 1500] = F32(0.5)
    extra[2] = np.random.default_rng(fs).standard_normal(2048).astype(F32)
    frames = np.concatenate([frames, extra])
    got = np.array([k5_attack_model(f, cst) for f in frames])
    want = xpsy.transient_detect(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()
    # the tree's sub-block energies are seg_sums' bit for bit
    d = np.zeros_like(frames)
    d[:, 1:] = frames[:, 1:] - frames[:, :-1]
    q = (d * d).reshape(-1, 16, 32, 4)
    s = (q[..., 1] + q[..., 0]) + (q[..., 3] + q[..., 2])
    for o in (1, 2, 4, 8, 16):
        s = s + s[..., np.arange(32) ^ o]
    want_e = xpsy.seg_sums(torch.from_numpy(d * d), xpsy._SUB_EDGES).numpy()
    assert_bits(s[..., 0], want_e)


def test_analyze_turns_needs_a_card(tmp_path):
    """The in-turns measurement is card only: without a card it exits 2."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from mrcaudiocodec_tpu_torch import analyze_turns
    assert analyze_turns.main([str(tmp_path)]) == 2
