"""The encoder's analysis stage as the port's kernels split it, on the CPU.

On the card `encoder._analyze_chunk` runs K5 (ops/kernels/transients.py),
K6 (analysis_pre.py), K1 (fft_stages.py), K7 (mdct_post.py) and K8
(psycho.py); a CPU tensor takes each kernel's plain version. Here that
split plain path (`encoder.analyze_split` on CPU tensors) must equal,
bitwise on every output (bt, coeffs, allowed, pe), the eager chain
(`encoder._analyze_chunk` on the CPU) and the JAX package's jit A
(`mrcaudiocodec_tpu.models.encoder._analyze_chunk`, on the CPU as its own
tests run it). The kernels' constant blobs are held value for value to
the JAX package's native blobs, and numpy models of the kernels'
schedules to the plain DAG: K8's scan in a warp's registers, its band
ranges and level-wise PE tree; K5's warp tree and ladder and its tile map.
The kernels themselves are held to these plain versions on a card
(tests/test_torch_kernels.py, chip_smoke.py).
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


def _sched(fs, long_block):
    """xpsy.kernel_sched split into its tables."""
    sc = xpsy.kernel_sched(fs, long_block)
    cst = xpsy.psy_tables(fs, long_block)
    npart, nb = cst["npart"], cst["nb"]
    o = 512
    return {"part_take": sc[0:256].reshape(8, 32),
            "band_take": sc[256:512].reshape(8, 32),
            "part_end": sc[o:o + npart],
            "band_end": sc[o + npart:o + npart + nb],
            "lo": sc[o + npart + nb:o + npart + 2 * nb],
            "hi": sc[o + npart + 2 * nb:o + npart + 3 * nb]}


def _bit(m, j):
    return (int(np.uint32(np.int32(m))) >> j) & 1


def _keep(v, m, j):
    """csrc/psycho.cu keep: v where bit j of m is set, else +0 (the bits
    ANDed with 0)."""
    mask = np.uint32(0xFFFFFFFF) if _bit(m, j) else np.uint32(0)
    return (np.asarray(v, F32).view(np.uint32) & mask).view(F32)


def k8_scan_model(values, take, stages):
    """csrc/psycho.cu scan_row, one f32 op at a time: lane l holds bins
    32 l + j in a[l, j]; stage st (d = 2^st) first takes the partners that
    come from other lanes (d < 32: a[l - 1, 32 - d + j] for j < d by
    __shfl_up 1; d >= 32: a[l - d/32, j] by __shfl_up d/32; a lane below
    the shift gets its own value), then adds to every bin, j running down
    in the lane, each add on the previous stage's values: the partner
    where bit j of take[st][l] is set, else its bits ANDed to +0 (keep)
    -> the scanned 1024 bins."""
    a = np.array(values, F32).reshape(32, 32)
    for st in range(stages):
        d = 1 << st
        old = a.copy()
        for l in range(32):
            m = take[st][l]
            row = old[l].copy()
            if d < 32:
                src = l - 1 if l >= 1 else l
                up = [old[src, 32 - d + j] for j in range(d)]
                for j in range(31, d - 1, -1):
                    row[j] = F32(row[j] + _keep(row[j - d], m, j))
                for j in range(d):
                    row[j] = F32(row[j] + _keep(up[j], m, j))
            else:
                src = l - d // 32 if l >= d // 32 else l
                for j in range(32):
                    row[j] = F32(row[j] + _keep(old[src, j], m, j))
            a[l] = row
    return a.reshape(-1)


def _family_starts(fs, long_block, which):
    """The family's scan stages, group width H and group count, from
    kernel_blobs."""
    f32, i32 = xpsy.kernel_blobs(fs, long_block)
    n, h, npart, nb, pst, bst, groups = (int(v) for v in i32[:7])
    return (pst if which == "part" else bst), h, groups


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k8_scan_model_equals_seg_sums(fs):
    """K8's scan of the 1024 bins in a warp's registers, with the lane
    tables of xpsy.kernel_sched, leaves at every segment's end (the
    tables' ends, group by group) xpsy.seg_sums' value: partitions and
    bands of both families, on power spectra with a wide dynamic range and
    on their xlog2 (negative values)."""
    rng = np.random.default_rng(fs)
    p = (rng.standard_normal(1024) ** 2 * 10.0 ** rng.uniform(-8, 6, 1024)
         ).astype(F32)
    lg = xpsy.xlog2(torch.from_numpy(p) + xpsy.TINY).numpy()
    for long_block in (True, False):
        cst = xpsy.psy_tables(fs, long_block)
        sc = _sched(fs, long_block)
        for which in ("part", "band"):
            stages, h, groups = _family_starts(fs, long_block, which)
            edges = cst["part_edges" if which == "part" else "band_edges"]
            ends = np.concatenate([g * h + sc[f"{which}_end"]
                                   for g in range(groups)])
            for v in (p, lg):
                got = k8_scan_model(v, sc[f"{which}_take"], stages)[ends]
                want = xpsy.seg_sums(torch.from_numpy(v).reshape(groups, h),
                                     edges).reshape(-1)
                assert_bits(got, want)
    # the unified edges of e_mdct are the family's bands, then 0-width ones
    assert kpsycho.check_layout(fs) == \
        len(psycho.unified_band_edges(fs)[0]) - 1


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k8_band_ranges_equal_pb_mask(fs):
    """Each band's partition range in the lane tables is exactly the
    partitions pb_mask maps to it (1 to 4, contiguous), in both
    families; the slots' group and index by the kernel's multiply-shift
    equal integer division for every slot a warp holds."""
    for long_block in (True, False):
        cst = xpsy.psy_tables(fs, long_block)
        sc = _sched(fs, long_block)
        npart, nb = cst["npart"], cst["nb"]
        i = np.arange(npart)[:, None]
        ranges = (i >= sc["lo"]) & (i <= sc["hi"])
        np.testing.assert_array_equal(ranges, cst["pb_mask"])
        width = sc["hi"] - sc["lo"] + 1
        assert width.min() >= 1 and width.max() <= 4
        for n in (npart, nb):
            magic = (65536 + n - 1) // n
            s = np.arange(256)
            np.testing.assert_array_equal((s * magic) >> 16, s // n)


def k8_pe_levels_model(terms, nb, groups):
    """csrc/psycho.cu's PE: each group's nb terms padded with zeros to p2
    (a power of two) in a row, then level h = p2/2 .. 1 adds v[b] +
    v[b + h] for b < h, lane i taking pairs i, i + 32, ...; then the
    groups folded left to right."""
    p2 = 1 << (nb - 1).bit_length()
    pev = np.zeros(groups * p2, F32)
    for g in range(groups):
        pev[g * p2:g * p2 + nb] = terms[g]
    h = p2 // 2
    while h >= 1:
        lh = h.bit_length() - 1
        new = pev.copy()
        for lane in range(32):
            for i in range(lane, groups * h, 32):
                k = (i >> lh) * p2 + (i & (h - 1))
                new[k] = F32(pev[k] + pev[k + h])
        pev = new
        h //= 2
    s = pev[0]
    for g in range(1, groups):
        s = F32(s + pev[g * p2])
    return s


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k8_pe_levels_model_equals_band_pe(fs):
    """K8's level-wise PE tree gives xpsy.band_pe's value (long) and
    xpsy.groups_pe's (short) bit for bit, on band energies and thresholds
    spread over many decades (silent bands included)."""
    rng = np.random.default_rng(fs + 1)
    for long_block, groups in ((True, 1), (False, C.N_SHORT)):
        cst = xpsy.psy_tables(fs, long_block)
        nb = cst["nb"]
        width = torch.from_numpy(cst["width"])
        for _ in range(4):
            e = (10.0 ** rng.uniform(-12, 8, (groups, nb))).astype(F32)
            t = (10.0 ** rng.uniform(-12, 8, (groups, nb))).astype(F32)
            e[:, ::5] = 0.0
            et, tt = torch.from_numpy(e), torch.from_numpy(t)
            s = xpsy.xexp2(0.5 * (xpsy.xlog2(et + xpsy.TINY)
                                  - xpsy.xlog2(tt + xpsy.TINY)))
            terms = (width * xpsy.xlog2(1.0 + s)).numpy()
            got = k8_pe_levels_model(terms, nb, groups)
            want = (xpsy.band_pe(et[0], tt[0], width) if long_block
                    else xpsy.groups_pe(et, tt, width))
            assert_bits(np.asarray(got, F32), want.numpy())


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


def k5_tile_map(rows, s, row_stride, sms=132):
    """csrc/transients.cu's grid as the wrapper sizes it: T =
    transients.tile_outputs(rows, s, sms), block (x, r) of T + 2 warps;
    warp w computes row r's extended frame x T + w where it is < s + 2,
    reading samples r * row_stride + (x T + w) * HOP + [0, 2048); thread t
    < T writes bt[r, x T + t] where that is < s, from the flags of warps
    t, t + 1, t + 2. -> (T, {(r, frame): [the extended frames its flags
    came from, as (block, warp) pairs]}, {block: sample span read},
    the warps a block computes nothing with)."""
    tile = transients.tile_outputs(rows, s, sms)
    warps = tile + 2
    grid = -(-s // tile)
    out, spans, idle = {}, {}, []
    for r in range(rows):
        for x in range(grid):
            f0 = x * tile
            ext = {w: f0 + w for w in range(warps) if f0 + w < s + 2}
            idle.append(warps - len(ext))
            if ext:
                lo = r * row_stride + min(ext.values()) * C.HOP
                hi = r * row_stride + max(ext.values()) * C.HOP + 2 * C.HOP
                spans[(r, x)] = (lo, hi)
            for t in range(tile):
                f = f0 + t
                if f < s:
                    assert all(t + k in ext for k in range(3))
                    out.setdefault((r, f), []).append(
                        [ext[t + k] for k in range(3)])
    return tile, out, spans, idle


@pytest.mark.parametrize("rows,s,stride", [
    (2, 1293, None), (128, 64, None), (1, 1, None), (3, 31, None),
    (2, 500, 1296 * 1024)])
def test_k5_tile_map_covers_every_frame_once(rows, s, stride):
    """K5's tiles write each block type exactly once, from the flags of
    the extended frames f, f + 1, f + 2 of its own row, reading only its
    row's (s + 3) hops (also where rows have a stride of their own, as the
    sharded path hands them over); a block is at most 16 warps; the 30 s
    chunk's grid covers all 132 SMs, and at 128 x 64 no tile leaves more
    than 2 warps idle."""
    row_stride = stride or (s + 3) * C.HOP
    tile, out, spans, idle = k5_tile_map(rows, s, row_stride)
    assert 1 <= tile <= transients.MAX_TILE
    assert sorted(out) == [(r, f) for r in range(rows) for f in range(s)]
    for (r, f), srcs in out.items():
        assert srcs == [[f, f + 1, f + 2]]
    for (r, x), (lo, hi) in spans.items():
        assert r * row_stride <= lo and hi <= r * row_stride + (s + 3) * C.HOP
    blocks = rows * -(-s // tile)
    if (rows, s) == (2, 1293):
        assert tile == 10 and blocks >= 132
    if (rows, s) == (128, 64):
        assert tile == 13 and max(idle) <= 2
