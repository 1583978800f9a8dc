"""The decoder's synthesis as the port's kernels split it, on the CPU.

On the card `decoder._synth_chunk` runs K9 (ops/kernels/synth_pre.py:
dequantize and the DCT-IV pre-twiddles), K1 twice (fft_stages.py) and K10
(synth_post.py: post-twiddles, unfold, window, short overlap, select,
overlap-add, int16); a CPU tensor takes each kernel's plain version. Here
that split plain path must equal the JAX package's decoder jit
(`mrcaudiocodec_tpu.models.decoder._synth_chunk`, on the CPU as its own
tests run it) bit for bit on every output, with one exception the tests
name: the JAX jit returns its first hop as `first + 0`, which turns a -0
into +0, where the port returns frame 0's first half as it is; the port's
`first` is held to the spec's synthesis instead, and the whole decode
across chunk seams to the spec's by int32 view. The kernels' constant
blobs are held to the JAX package's tables, numpy models of the kernels'
thread -> sample maps to the plain DAG, and crafted escapes beyond QMAX
through K9's plain version to the JAX dequantize. The kernels themselves
are held to these plain versions on a card (tests/test_torch_kernels.py,
chip_smoke.py).
"""
import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu import tables as jtables
from mrcaudiocodec_tpu import xmath as jxmath

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import native
from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch import xmath
from mrcaudiocodec_tpu_torch.bitstream import read_header
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec, decoder
from mrcaudiocodec_tpu_torch.ops import dsp, entropy, quantize
from mrcaudiocodec_tpu_torch.ops.kernels import (fft_stages, rd_loop,
                                                 synth_post, synth_pre)
from mrcaudiocodec_tpu_torch.spec import codec as spec
from mrcaudiocodec_tpu_torch.spec import dsp as sdsp
from mrcaudiocodec_tpu_torch.spec import quantize as squant
from mrcaudiocodec_tpu_torch.utils.bits import BitWriter

torch.set_num_threads(1)
F32 = np.float32
NEG_ZERO = np.int32(-2 ** 31)          # the bits of -0.0


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_bits(got, ref):
    got, ref = _bits(got), _bits(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_array_equal(got, ref)


def _clip(fs, seconds, kind, seed=0):
    """Stereo float32: "music" (two tones, noise, a burst every ~0.11 s),
    "transient" (bursts every 1500 samples from 0.1 to 0.2 s: START, SHORT
    and STOP frames), "silent", or "fade" (music, silent after 1/8 of the
    clip)."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = (0.35 * np.sin(2 * np.pi * 440 * t) + 0.12 * np.sin(
        2 * np.pi * 3100 * t) + 0.02 * rng.standard_normal(n)).astype(F32)
    step, end = (1500, fs // 5) if kind == "transient" else (fs // 9,
                                                               n - 200)
    for pos in range(fs // 10, end, step):
        x[pos:pos + 48] += (0.7 * rng.standard_normal(48)).astype(F32)
    if kind == "silent":
        x[:] = 0.0
    if kind == "fade":
        x[n // 8:] = 0.0
    x = np.clip(x, -1, 1)
    return np.stack([x, np.roll(x, 7) * F32(0.9)], 1)


def _stream(fs, window, kind, seconds=0.6, seed=0):
    cfg = CodecConfig(fs=fs, channels=2, bitrate=128000, window=window)
    return spec.encode(_clip(fs, seconds, kind, seed), cfg)


def _random_records(fs, frames, seed):
    """Records no encoder writes but the format holds: every block type,
    magnitudes up to 4 x QMAX (an escape the int16 slab keeps), exponents
    over the parser's range [0, 255]."""
    rng = np.random.default_rng(seed)
    nb = T.unified_layout(fs)["nb"]
    q = np.round(rng.standard_normal((2, frames, 1024))
                 * rng.uniform(0, 60, (2, frames, 1)))
    big = rng.random(q.shape) < 0.003
    q[big] = rng.integers(-4 * C.QMAX, 4 * C.QMAX, int(big.sum()))
    q[0, 0, :4] = [-32768, 32767, C.QMAX + 1, -C.QMAX]
    e = rng.integers(0, 256, (2, frames, nb))
    bt = np.arange(2 * frames).reshape(2, frames) % C.N_BLOCK_TYPES
    return q.astype(np.int16), e.astype(np.int16), bt.astype(np.int8)


def _records(fs, window, kind, frames, first=3):
    """(q, e_band, bt) slabs of `frames` frames from frame `first`."""
    if kind == "random":
        return _random_records(fs, frames, fs + frames)
    slab = decoder.record_slabs(_stream(fs, window, kind))[0]
    return tuple(np.ascontiguousarray(a[:, first:first + frames])
                 for a in slab)


def _jax_synth(q, e, bt, fs, window, pcm16):
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.models import decoder as jdec
    return [np.asarray(o) for o in jdec._synth_chunk(
        jnp.asarray(q), jnp.asarray(e), jnp.asarray(bt), fs=fs,
        window=window, pcm16=pcm16)]


def _spec_first(q, e, bt, fs, window):
    """Frame 0's first half of each row by the spec's synthesis."""
    lay = T.unified_layout(fs)
    out = []
    for r in range(bt.shape[0]):
        b = int(bt[r, 0])
        xhat = squant.dequantize(q[r, 0].astype(np.int32),
                                 e[r, 0].astype(np.int32)[lay["bin_band"][b]])
        out.append(sdsp.synthesize_frame(xhat, b, window)[:C.HOP])
    return np.stack(out)


# (fs, window, records, frames)
CASES = [
    (44100, "sine", "music", 13),
    (48000, "kbd", "music", 13),
    (32000, "sine", "music", 13),
    (44100, "kbd", "transient", 13),
    (32000, "sine", "transient", 9),
    (44100, "sine", "music", 1),
    (44100, "sine", "silent", 13),
    (48000, "sine", "random", 9),
    (32000, "kbd", "random", 1),
]


@pytest.mark.parametrize("pcm16", [False, True], ids=["f32", "int16"])
@pytest.mark.parametrize("case", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_split_synthesis_equals_jax(case, pcm16):
    """pcm and tail bitwise == the JAX jit; first == the JAX jit's first
    in value, == the port's first + 0 in bits (the JAX jit returns its hop
    0, first + prev with prev = +0), and == the spec's synthesis of frame 0
    in bits (the port keeps -0: the host's seam add needs the raw half)."""
    fs, window, kind, frames = case
    q, e, bt = _records(fs, window, kind, frames,
                        first=1 if kind == "transient" else 3)
    pcm, first, tail = decoder._synth_chunk(
        *(torch.from_numpy(a) for a in (q, e, bt)), fs, window, pcm16)
    jpcm, jfirst, jtail = _jax_synth(q, e, bt, fs, window, pcm16)
    assert pcm.dtype == (torch.int16 if pcm16 else torch.float32)
    assert_bits(pcm, jpcm.T)              # time-major: [s * HOP, R]
    assert_bits(tail, jtail)
    np.testing.assert_array_equal(first.numpy(), jfirst)
    assert_bits(first + 0.0, jfirst)
    assert_bits(first, _spec_first(q, e, bt, fs, window))
    if kind == "transient":
        assert {C.SHORT, C.START, C.STOP} <= set(np.unique(bt).tolist())
    if kind == "silent":
        # the exception is real here: -0 in the port's first, +0 in JAX's
        assert (_bits(first) == NEG_ZERO).any()
        assert not (_bits(jfirst) == NEG_ZERO).any()


def test_one_frame_chunk_jax_folds_the_zero_add():
    """A silent chunk of one frame: the port's hop 0 is first + (+0), the
    spec's add, so its -0 samples come out +0. The JAX jit's hop 0 keeps
    them -0: with one frame its `prev` is a constant zero and XLA folds
    first + 0 into first. The values are equal; the port's bits are the
    spec's (the JAX decode never runs a chunk under 16 frames)."""
    q, e, bt = _records(44100, "sine", "silent", 1)
    pcm, first, tail = decoder._synth_chunk(
        *(torch.from_numpy(a) for a in (q, e, bt)), 44100, "sine", False)
    jpcm, jfirst, jtail = _jax_synth(q, e, bt, 44100, "sine", False)
    np.testing.assert_array_equal(pcm.numpy(), jpcm.T)
    assert_bits(pcm.T, first + 0.0)
    assert_bits(jpcm, first)
    assert_bits(jfirst, first)
    assert_bits(tail, jtail)
    assert (_bits(first) == NEG_ZERO).any()
    assert not (_bits(pcm) == NEG_ZERO).any()


def test_split_synthesis_launches_nothing_on_the_cpu():
    """CPU tensors run the plain versions: no kernel count moves."""
    mods = (synth_pre, fft_stages, synth_post)
    before = [m.launches for m in mods]
    q, e, bt = _random_records(44100, 3, 1)
    decoder._synth_chunk(*(torch.from_numpy(a) for a in (q, e, bt)), 44100,
                         "sine", True)
    assert [m.launches for m in mods] == before


def test_synthesis_wrappers_reject_bad_inputs():
    q, e, bt = (torch.from_numpy(a) for a in _random_records(44100, 3, 2))
    with pytest.raises(ValueError):
        synth_pre.synth_pre_kernel(q, e, bt, 44100)      # CPU: no kernel
    with pytest.raises(ValueError):
        synth_pre.synth_pre(q.to(torch.int32), e, bt, 44100)
    with pytest.raises(ValueError):
        synth_pre.synth_pre(q, e, bt, 32000)             # 96 bands, not 88
    pre = synth_pre.synth_pre(q, e, bt, 44100)
    spec_ = (*fft_stages.fft(*pre[:2]), *fft_stages.fft(*pre[2:]))
    with pytest.raises(ValueError):
        synth_post.synth_post_kernel(*spec_, bt, "sine", False)
    with pytest.raises(ValueError):
        synth_post.synth_post(*spec_, bt.reshape(-1), "sine", False)
    with pytest.raises(ValueError):
        synth_post.synth_post(*spec_[:2], *pre[:2], bt, "sine", False)


# ---------------------------------------------------------------------------
# The decode across chunk seams
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pcm_dtype", ["float32", "int16"])
@pytest.mark.parametrize("chunks", ["5 frames", "3 chunks"])
def test_decode_at_small_chunks_equals_spec_by_bits(monkeypatch, chunks,
                                                    pcm_dtype):
    """A 0.5 s stereo stream that falls silent after 1/8 s, decoded in
    chunks of 5 frames and in 3 chunks, each chunk's K10 taking the one
    before's tail: the port's float32 PCM equals the port's spec decode by
    int32 view, its int16 PCM the spec's rounded as K10 rounds (half to
    even, clamped). The JAX decode (at the same DEC_CHUNK) equals it in
    value; in float32 its bits differ only where the spec has -0 and JAX
    +0, each in the first hop of a JAX chunk: the JAX jit's `first + 0`
    before the seam add."""
    from mrcaudiocodec_tpu.models import decoder as jdec
    from mrcaudiocodec_tpu.models.encoder import _chunk_schedule
    bs = _stream(44100, "sine", "fade", seconds=0.5, seed=4)
    want, _ = spec.decode(bs)
    nf = read_header(bs)[1]
    size = 5 if chunks == "5 frames" else -(-nf // 3)
    monkeypatch.setattr(decoder, "DEC_CHUNK", size)
    n_chunks = len(decoder.record_slabs(bs))
    assert n_chunks > 2 and (chunks == "5 frames" or n_chunks == 3)
    got, _ = codec.decode(bs, device="cpu", pcm_dtype=pcm_dtype)
    monkeypatch.setattr(jdec, "DEC_CHUNK", size)
    jgot, _ = jdec.decode(bs, pcm_dtype=pcm_dtype)
    if pcm_dtype == "int16":
        want16 = np.clip(np.round(want * F32(32767.0)), -32768,
                         32767).astype(np.int16)
        assert_bits(got, want16)
        assert_bits(jgot, want16)
        return
    assert_bits(got, want)
    assert (_bits(want) == NEG_ZERO).sum() > 1000    # silence across seams
    np.testing.assert_array_equal(jgot, want)
    diff = np.nonzero(_bits(jgot) != _bits(want))
    assert len(diff[0]) > 0
    assert (_bits(want)[diff] == NEG_ZERO).all()
    assert (_bits(jgot)[diff] == 0).all()
    seam = np.zeros(want.shape[0], bool)
    for f0 in np.cumsum(_chunk_schedule(nf, size))[:-1]:
        seam[(f0 - 1) * C.HOP:f0 * C.HOP] = True    # the PCM of hop f0
    assert seam[diff[0]].all()


def _old_join(outs, n_samples, pcm16):
    """The host seam the decoder used before K10 took it: each chunk's
    [R, s*HOP] pcm with +0 for the previous chunk, its raw first hop and
    tail (numpy); each seam hop first + the chunk before's tail (one f32
    add), then numpy's round, clip and int16 cast; the chunks joined and
    transposed, the priming hop dropped."""
    pcms = [o[0] for o in outs]
    for c in range(1, len(outs)):
        seam = outs[c][1] + outs[c - 1][2]
        if pcm16:
            pcms[c][:, :C.HOP] = np.clip(np.round(seam * 32767.0),
                                         -32768, 32767).astype(np.int16)
        else:
            pcms[c][:, :C.HOP] = seam
    flat = np.concatenate(pcms, axis=1)
    return np.ascontiguousarray(flat[:, C.HOP:C.HOP + n_samples].T)


def _with_records(bs, swap):
    """bs with the records {index: content bytes} swapped in (each behind
    its 20-bit length prefix, the content's zero padding counted)."""
    from mrcaudiocodec_tpu_torch.bitstream import (HEADER_BYTES,
                                                   frame_byte_offsets)
    cfg, nf, _, _ = read_header(bs)
    offs, _ = frame_byte_offsets(bs, HEADER_BYTES, nf * cfg.channels)
    ends = list(offs[1:]) + [len(bs)]
    out = bs[:HEADER_BYTES]
    for i, (a, b) in enumerate(zip(offs, ends)):
        if i not in swap:
            out += bs[a:b]
            continue
        w = BitWriter()
        w.write(8 * len(swap[i]), C.FRAME_LEN_BITS)
        for byte in swap[i]:
            w.write(byte, 8)
        w.align()
        out += w.getvalue()
    return out


def test_decode_crafted_escapes_at_seams_equals_old_join(monkeypatch):
    """Records with escapes beyond QMAX (test_torch_hardening.py's crafted
    escape: q -16507 and -32768 once the int16 slab cuts them) on both
    sides of chunk seams, decoded at DEC_CHUNK 5: f32 and int16 PCM ==
    the host seam the decoder used to add (_old_join), bit for bit, and
    == the JAX decoder in value. Their samples reach 256 x full scale, so
    the int16 seam hops clamp; none is NaN (no cast of a NaN at a seam
    changed with the seam's move into K10)."""
    from mrcaudiocodec_tpu.models import decoder as jdec
    bs = _stream(44100, "sine", "music", seconds=0.5, seed=6)
    # frames 4 and 5 (seam hop 5), 9 and 10 (hop 10); 2 channels a frame
    swap = {8: _escape_content(44100, 10, 123),
            11: _escape_content(44100, 11, 0),
            18: _escape_content(44100, 11, 0),
            20: _escape_content(44100, 10, 123)}
    bs = _with_records(bs, swap)
    _, nf, n_samples, _ = read_header(bs)
    monkeypatch.setattr(decoder, "DEC_CHUNK", 5)
    monkeypatch.setattr(jdec, "DEC_CHUNK", 5)
    slabs = decoder.record_slabs(bs)
    assert (slabs[0][0][0, 4] == -16507).any()
    seam = np.zeros(n_samples, bool)
    for f0 in (5, 10):
        seam[(f0 - 1) * C.HOP:f0 * C.HOP] = True
    for pcm16 in (False, True):
        outs = []
        for sl in slabs:
            pcm, first, tail = decoder._synth_chunk(
                *(torch.from_numpy(a) for a in sl), 44100, "sine", pcm16)
            outs.append([pcm.numpy().T.copy(), first.numpy(), tail.numpy()])
        want = _old_join(outs, n_samples, pcm16)
        dtype = "int16" if pcm16 else "float32"
        got, _ = codec.decode(bs, device="cpu", pcm_dtype=dtype)
        assert_bits(got, want)
        np.testing.assert_array_equal(got, jdec.decode(bs, dtype)[0])
        if pcm16:
            assert (np.abs(got[seam].astype(np.int32)) == 32767).any()
        else:
            assert np.isfinite(got).all()
            assert np.abs(got[seam]).max() > 100.0


# ---------------------------------------------------------------------------
# Constant blobs against the JAX package's tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_k9_tables_equal_jax(fs):
    """K9 reads bin_band, the step fractions, the |q|^(4/3) table and the
    DCT-IV pre-twiddles: each equals the JAX package's."""
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import quantize as jquant
    tb = entropy.dev_tables(fs, "cpu")
    np.testing.assert_array_equal(tb["bin_band"].numpy(),
                                  jtables.unified_layout(fs)["bin_band"])
    assert_bits(quantize.FRACS, np.asarray(jquant._FRACS, F32))
    q = np.arange(C.QMAX + 1, dtype=np.int32)
    want = np.asarray(jquant.dequantize(jnp.asarray(q), jnp.full(
        q.shape, C.GAIN_BIAS, jnp.int32)))
    assert_bits(rd_loop.pow43_table("cpu"), want)
    for m in (1024, 128):
        h = m // 2
        assert_bits(xmath.dct4_blob(m)[:2 * h], jxmath.ffi_table(m)[:2 * h])


@pytest.mark.parametrize("window", ["sine", "kbd"])
def test_k10_tables_equal_jax(window):
    """K10 reads the long and short windows and the DCT-IV post-twiddles
    and scale: each equals the JAX package's."""
    from mrcaudiocodec_tpu.ops import dsp as jdsp
    lw, sw = dsp._windows(window, "cpu")
    jc = jdsp._consts(window)
    assert_bits(lw, jc["long_windows"])
    assert_bits(sw, jc["short_window"])
    for m in (1024, 128):
        h = m // 2
        assert_bits(xmath.dct4_blob(m)[2 * h:],
                    jxmath.ffi_table(m)[4 * h - 2:])


# ---------------------------------------------------------------------------
# Numpy models of the kernels' thread -> sample maps
# ---------------------------------------------------------------------------


def _signed(rng, shape):
    """f32 values with +0 and -0 among them."""
    a = rng.standard_normal(shape).astype(F32)
    pick = rng.random(shape)
    a[pick < 0.2] = F32(0.0)
    a[pick > 0.8] = F32(-0.0)
    return a


def test_k9_pre_twiddle_map_equals_dct_iv_pre():
    """K9's thread k writes long value k (x[2k], x[1023-2k]) and short value
    k of sub-block k >> 6 (x[128g + 2m], x[128g + 127 - 2m], m = k & 63),
    f32 ops in _cmul's order: == xmath.dct_iv_pre of [F, 1024] and of its
    [F, 8, 128] view."""
    rng = np.random.default_rng(1)
    x = _signed(rng, (5, 1024))
    blob_l, blob_s = xmath.dct4_blob(1024), xmath.dct4_blob(128)
    k = np.arange(512)
    ue, uo = x[:, 2 * k], x[:, 1023 - 2 * k]
    pr, pi = blob_l[:512], blob_l[512:1024]
    want = xmath.dct_iv_pre(torch.from_numpy(x))
    assert_bits(ue * pr - uo * pi, want[0])
    assert_bits(ue * pi + uo * pr, want[1])
    g, m = k >> 6, k & 63
    ue, uo = x[:, 128 * g + 2 * m], x[:, 128 * g + 127 - 2 * m]
    pr, pi = blob_s[m], blob_s[64 + m]
    want = xmath.dct_iv_pre(torch.from_numpy(x).reshape(5, 8, 128))
    assert_bits((ue * pr - uo * pi).reshape(5, 8, 64), want[0])
    assert_bits((ue * pi + uo * pr).reshape(5, 8, 64), want[1])


@pytest.mark.parametrize("m_size", [1024, 128])
def test_k10_unfold_map_equals_unfold(m_size):
    """K10's sample j of the unfold: j < h: +c[h + j]; j < 3h: -c[3h-1-j];
    else -c[j - 3h] == xmath.unfold, signed zeros included."""
    rng = np.random.default_rng(m_size)
    c = _signed(rng, (3, m_size))
    h = m_size // 2
    j = np.arange(2 * m_size)
    k = np.where(j < h, h + j, np.where(j < 3 * h, 3 * h - 1 - j, j - 3 * h))
    model = np.where(j < h, c[:, k], -c[:, k])
    assert_bits(model, xmath.unfold(torch.from_numpy(c)))


def test_k10_short_overlap_order_equals_plain():
    """K10's SHORT frame sample p: +0.0, plus each sub-block g in
    [(p-448)//128 - 1, (p-448)//128] within 0..7, in group order; a lone
    -0 comes out +0 and samples outside every sub-block are +0: ==
    dsp.synth_windowed (zeros_like, then += a group at a time)."""
    rng = np.random.default_rng(2)
    nf = 4
    s_re, s_im = (_signed(rng, (nf, 8, 64)) for _ in range(2))
    s_re[0] = 0.0                              # a silent frame
    s_im[0] = -0.0
    l_re, l_im = (np.zeros((nf, 512), F32) for _ in range(2))
    bt = torch.full((nf,), C.SHORT, dtype=torch.int8)
    got = dsp.synth_windowed(*(torch.from_numpy(a) for a in
                               (l_re, l_im, s_re, s_im)), bt, "sine")
    _, sw = dsp._windows("sine", "cpu")
    subs = (xmath.unfold(xmath.dct_iv_post(torch.from_numpy(s_re),
                                           torch.from_numpy(s_im)))
            * sw).numpy()
    model = np.zeros((nf, C.LONG_SIZE), F32)
    for p in range(C.LONG_SIZE):
        d = p - C.SHORT_OFFSET
        v = np.full(nf, F32(0.0))
        if d >= 0:
            for g in range(max(d // 128 - 1, 0), min(d // 128, 7) + 1):
                v = v + subs[:, g, d - 128 * g]
        model[:, p] = v
    assert_bits(model, got)
    assert (_bits(subs[0]) == NEG_ZERO).any()
    assert not (_bits(got[0]) == NEG_ZERO).any()


def _k10_planes(rng, r, s, silent=4):
    """K1's output planes of r x s frames (signed zeros among the values,
    the first `silent` frames all zero) and block types cycling 0..4."""
    planes = [torch.from_numpy(_signed(rng, sh)) for sh in
              ((r * s, 512),) * 2 + ((r * s, 8, 64),) * 2]
    for i, p in enumerate(planes):
        p[:silent] = -0.0 if i % 2 else 0.0    # silent frames
    bt = torch.from_numpy((np.arange(r * s) % 5).reshape(r, s).astype(
        np.int8))
    return planes, bt


def _k10_pairs(ar, ai, tab, h, m):
    """K10's coefficient pair (c[2m], c[2m+1]) of a size-2h DCT-IV, f32 ops
    in dct_iv_post's order: A[m] for the even one, A[h-1-m] for the odd."""
    pr, pi, scale = tab[2 * h:3 * h], tab[3 * h:4 * h], tab[4 * h]
    i = h - 1 - m
    even = ar[..., m] * pr[m] - ai[..., m] * pi[m]
    odd = -(ar[..., i] * pi[i] + ai[..., i] * pr[i])
    return even * scale, odd * scale


def _k10_put(y, owner, tag, at, vals):
    """Entries `at` of y get vals; each must be written once."""
    assert (owner[at] != tag).all()
    y[at] = vals
    owner[at] = tag


def _k10_stage(planes, fi, b, first, y, owner, tag, w, sw):
    """K10's staging of frame fi's half (`first`: the first half, else the
    second) into y, f32 [1280], by its 256 threads: each pair (c[k],
    c[k+1]), k = 2m, computed once, then the two samples the unfold gives
    each, negated where it says, times the window: a long frame's half as
    its 1024 samples (w: the half's long window), a SHORT frame's 5
    sub-blocks that meet the half as 256 windowed samples each (sw: the
    short window). owner records `tag` on every sample written."""
    l_re, l_im, s_re, s_im = planes
    if b != C.SHORT:
        m = np.arange(256) + (256 if first else 0)
        ce, co = _k10_pairs(l_re[fi], l_im[fi], xmath.dct4_blob(1024), 512,
                            m)
        k = 2 * m
        if first:      # c[k] at k - 512 (+) and 1535 - k (-)
            a, sign = k - 512, F32(1.0)
        else:          # c[k] at 512 + k (-) and 511 - k (-)
            a, sign = 512 + k, F32(-1.0)
        b_ = 1534 - k if first else 510 - k
        _k10_put(y, owner, tag, a, (sign * ce) * w[a])
        _k10_put(y, owner, tag, a + 1, (sign * co) * w[a + 1])
        _k10_put(y, owner, tag, b_, (-co) * w[b_])
        _k10_put(y, owner, tag, b_ + 1, (-ce) * w[b_ + 1])
        return
    # threads t with t >> 6 == g % 4 take sub-block g, pair m = t & 63
    m = np.arange(64)
    k = 2 * m
    for g in (range(0, 5) if first else range(3, 8)):
        ce, co = _k10_pairs(s_re[fi, g], s_im[fi, g], xmath.dct4_blob(128),
                            64, m)
        base = 256 * (g - (0 if first else 3))
        a = np.where(k >= 64, k - 64, 192 + k)
        sign = np.where(k >= 64, F32(1.0), F32(-1.0)).astype(F32)
        _k10_put(y, owner, tag, base + a, (sign * ce) * sw[a])
        _k10_put(y, owner, tag, base + a + 1, (sign * co) * sw[a + 1])
        _k10_put(y, owner, tag, base + 190 - k, (-co) * sw[190 - k])
        _k10_put(y, owner, tag, base + 191 - k, (-ce) * sw[191 - k])


def _k10_read(y, owner, tag, b, first, i):
    """K10's sample i (an array, 0 .. 1023) of a staged half: a long
    frame's as staged; a SHORT frame's sub-blocks whose span holds it
    added onto +0 in group order. Every entry read must carry `tag`."""
    if b != C.SHORT:
        assert (owner[i] == tag).all()
        return y[i]
    g_base = 0 if first else 3
    p = i + (0 if first else C.HOP) - C.SHORT_OFFSET
    v = np.full(i.shape, F32(0.0))
    for g in range(C.N_SHORT):
        q = p - 128 * g
        inside = (q >= 0) & (q < 256)
        if not inside.any():
            continue
        at = 256 * (g - g_base) + q[inside]
        assert 0 <= g - g_base < 5 and (owner[at] == tag).all()
        v[inside] = v[inside] + y[at]
    return v


def _k10_model(planes, bt, window, pcm16, prev):
    """A numpy model of K10's blocks: block (h, row pair) stages frame h-1's
    second half and frame h's first half as windowed samples (`owner`
    shows what each entry holds), then writes hop h: frame h's first half
    + frame h-1's second half (prev's row, or +0, at hop 0), time-major,
    and at hop s the tail."""
    planes = [p.numpy() for p in planes]
    bt = bt.numpy()
    r, s = bt.shape
    lw, sw = (w.numpy() for w in dsp._windows(window, "cpu"))
    pcm = np.full((s * C.HOP, r), np.nan, F32)
    first, tail = (np.full((r, C.HOP), np.nan, F32) for _ in range(2))
    i = np.arange(C.HOP)
    for r0 in range(0, r, 2):
        for h in range(s + 1):
            ys = np.full((2, 2, 1280), np.nan, F32)
            owner = np.full((2, 2, 1280), -9)
            for rr in range(min(2, r - r0)):
                row = r0 + rr
                for k, fr in enumerate((h - 1, h)):
                    if 0 <= fr < s:
                        b = int(bt[row, fr])
                        w = lw[b, (0 if k else C.HOP):][:C.HOP]
                        _k10_stage(planes, row * s + fr, b, k == 1,
                                   ys[k, rr], owner[k, rr], fr, w, sw)
                if h > 0:
                    pv = _k10_read(ys[0, rr], owner[0, rr], h - 1,
                                   int(bt[row, h - 1]), False, i)
                else:
                    pv = (prev[row].numpy() if prev is not None
                          else np.zeros(C.HOP, F32))
                if h == s:
                    tail[row] = pv
                    continue
                fv = _k10_read(ys[1, rr], owner[1, rr], h, int(bt[row, h]),
                               True, i)
                if h == 0:
                    first[row] = fv
                pcm[h * C.HOP:(h + 1) * C.HOP, row] = fv + pv
    if pcm16:
        pcm = np.clip(np.round(pcm * F32(32767.0)), -32768, 32767).astype(
            np.int16)
    return pcm, first, tail


@pytest.mark.parametrize("pcm16", [False, True], ids=["f32", "int16"])
@pytest.mark.parametrize("rows,with_prev", [
    (2, False), (2, True), (1, False), (3, True), (1, True)])
def test_k10_hop_map_equals_plain(rows, with_prev, pcm16):
    """K10's blocks (the numpy model: a block a hop and a row pair, the
    staged halves, the sample map, the seam) write the time-major pcm,
    `first` and `tail` == synth_post_plain, at R = 1, 2, 3, with and
    without the previous chunk's tail, signed zeros included."""
    rng = np.random.default_rng(3 + rows + with_prev)
    s = 6
    planes, bt = _k10_planes(rng, rows, s)
    prev = (torch.from_numpy(_signed(rng, (rows, C.HOP)))
            if with_prev else None)
    got = _k10_model(planes, bt, "kbd", pcm16, prev)
    want = synth_post.synth_post_plain(*planes, bt, "kbd", pcm16, prev)
    for g, w in zip(got, want):
        assert_bits(g, w)
    assert want[0].shape == (s * C.HOP, rows)
    assert (_bits(want[1]) == NEG_ZERO).any()


@pytest.mark.parametrize("kind", ["long", "short"])
def test_k10_staging_map_equals_unfold(kind):
    """K10's staging of one frame's half: the pairs (c[2m], c[2m+1]) from
    A[m] and A[H-1-m] (long: m = t + 256 for the first half, t for the
    second; SHORT: the sub-blocks 0..4, or 3..7, that meet the half), each
    coefficient's two samples by the unfold's index map, negated where it
    says, times the window, every sample written once: == xmath.unfold of
    dct_iv_post times the window (sub-block by sub-block for SHORT),
    signed zeros included."""
    rng = np.random.default_rng(9)
    planes = [_signed(rng, sh) for sh in ((1, 512),) * 2 + ((1, 8, 64),) * 2]
    b = C.SHORT if kind == "short" else C.START
    tp = [torch.from_numpy(p) for p in planes]
    lw, sw = (w.numpy() for w in dsp._windows("kbd", "cpu"))
    if kind == "long":
        want = (xmath.unfold(xmath.dct_iv_post(*tp[:2]))[0].numpy()
                * lw[b])
    else:
        want = xmath.unfold(xmath.dct_iv_post(*tp[2:]))[0].numpy() * sw
    for first in (True, False):
        y = np.full(1280, np.nan, F32)
        owner = np.full(1280, -1)
        w = lw[b, (0 if first else C.HOP):][:C.HOP]
        _k10_stage(planes, 0, b, first, y, owner, 0, w, sw)
        if kind == "long":
            assert (owner[:C.HOP] == 0).all() and (owner[C.HOP:] < 0).all()
            assert_bits(y[:C.HOP], want[(0 if first else C.HOP):][:C.HOP])
        else:
            assert (owner == 0).all()
            for slot in range(5):
                g = slot + (0 if first else 3)
                assert_bits(y[256 * slot:256 * (slot + 1)], want[g])
        assert (_bits(y[owner == 0]) == NEG_ZERO).any()


def test_synth_post_prev_equals_old_seam():
    """synth_post_plain with prev == the seam the host used to add: two
    chunks synthesized apart, chunk 1's hop 0 = its raw `first` + chunk
    0's tail (one f32 add), then round / clip / int16 as numpy did; and
    the two chunks' time-major pcm joined == one chunk of both."""
    rng = np.random.default_rng(21)
    planes, bt = _k10_planes(rng, 2, 10, silent=0)
    for i in range(4):
        planes[i][[5, 6, 15, 16]] = -0.0 if i % 2 else 0.0   # around seam
    parts = [([p[sl] for p in planes], bt[:, c].contiguous())
             for sl, c in ((np.r_[0:5, 10:15], slice(0, 5)),
                           (np.r_[5:10, 15:20], slice(5, 10)))]
    a = synth_post.synth_post_plain(*parts[0][0], parts[0][1], "sine",
                                    False)
    raw = synth_post.synth_post_plain(*parts[1][0], parts[1][1], "sine",
                                      False)
    seam = raw[1].numpy() + a[2].numpy()          # the old host seam add
    for pcm16 in (False, True):
        got = synth_post.synth_post_plain(*parts[1][0], parts[1][1], "sine",
                                          pcm16, a[2])
        old = raw[0].numpy().copy()
        if pcm16:
            old = np.clip(np.round(old * F32(32767.0)), -32768,
                          32767).astype(np.int16)
            old[:C.HOP] = np.clip(np.round(seam * F32(32767.0)), -32768,
                                  32767).astype(np.int16).T
        else:
            old[:C.HOP] = seam.T
        assert_bits(got[0], old)
        assert_bits(got[1], raw[1])
        assert_bits(got[2], raw[2])
        whole = synth_post.synth_post_plain(*planes, bt, "sine", pcm16)
        joined = np.concatenate([synth_post.synth_post_plain(
            *parts[0][0], parts[0][1], "sine", pcm16)[0].numpy(),
            got[0].numpy()])
        assert_bits(joined, whole[0])
    assert (_bits(seam) == NEG_ZERO).any()
    assert (_bits(raw[1].numpy() + F32(0.0)) != _bits(raw[1])).any()


def test_synth_post_out_is_written_in_place():
    """`out`, a slice of a clip buffer, receives pcm; the rest of the
    buffer is left as it was; a misshapen or mistyped `out` raises."""
    rng = np.random.default_rng(4)
    planes, bt = _k10_planes(rng, 2, 3)
    clip = torch.full((5 * C.HOP, 2), 7, dtype=torch.int16)
    got = synth_post.synth_post_plain(*planes, bt, "sine", True,
                                      out=clip[C.HOP:4 * C.HOP])
    want = synth_post.synth_post_plain(*planes, bt, "sine", True)
    assert got[0].data_ptr() == clip[C.HOP:].data_ptr()
    assert_bits(clip[C.HOP:4 * C.HOP], want[0])
    assert (clip[:C.HOP] == 7).all() and (clip[4 * C.HOP:] == 7).all()
    with pytest.raises(ValueError):
        synth_post.synth_post(*planes, bt, "sine", False,
                              out=clip[C.HOP:4 * C.HOP])
    with pytest.raises(ValueError):
        synth_post.synth_post(*planes, bt, "sine", True,
                              out=clip[C.HOP:3 * C.HOP])
    with pytest.raises(ValueError):
        synth_post.synth_post(*planes, bt, "sine", True,
                              prev=torch.zeros(2, C.HOP - 1))


# ---------------------------------------------------------------------------
# Escapes beyond QMAX (the native parser reads exponents up to 31)
# ---------------------------------------------------------------------------


def _escape_content(fs, run, suffix):
    """One LONG record whose band 0 opens with a negative escape: `run`
    ones of unary prefix (exponent 4 + run), then `suffix` in 4 + run bits
    (tests/test_torch_hardening.py's crafted escape, with its run and
    suffix chosen)."""
    lay = T.unified_layout(fs)
    ca = T.code_arrays()
    real = np.where(lay["width"][C.LONG] > 0)[0]
    w = BitWriter()
    w.write(C.LONG, C.BLOCK_TYPE_BITS)
    w.write(100, C.GAIN_BITS)
    for b in real:
        w.write(C.CB_ESC if b == real[0] else C.CB_ZERO, C.CB_BITS)
    for _ in real:                                # sf delta 0
        w.write(int(ca["codes_sf"][C.SF_DELTA_MAX]),
                int(ca["len_sf"][C.SF_DELTA_MAX]))
    sym = 16 * (C.ESC_MAG + 1) + 0                # magnitudes (16, 0)
    w.write(int(ca["codes_esc"][sym]), int(ca["len_esc"][sym]))
    w.write(1, 1)                                 # sign: negative
    w.write((1 << run) - 1, run)
    w.write(0, 1)
    w.write(suffix, 4 + run)
    w.write(0, 64)                                # no read runs off the end
    return w.getvalue()


@pytest.mark.parametrize("run,suffix,q16", [(10, 123, -16507),
                                            (11, 0, -32768), (14, 0, 0)])
@pytest.mark.parametrize("fs", [44100, 32000])
def test_over_qmax_escape_through_synth_pre_equals_jax(fs, run, suffix,
                                                       q16):
    """The native parser's q beyond QMAX, cut to int16 as record_slabs
    cuts it (to -16507, -32768 and 0 here), through synth_pre_plain ==
    xmath.dct_iv_pre of the JAX dequantize of the same q; and the whole
    split synthesis == the JAX jit's."""
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import quantize as jquant
    data = _escape_content(fs, run, suffix)
    q, e, bt, _ = native.decode_records(data + bytes(8),
                                        np.zeros(1, np.int64), fs)
    assert q[0, 0] == -((1 << (4 + run)) + suffix)
    # a chunk of two frames, the record twice (a chunk of one frame would
    # meet the JAX jit's folded zero add: test_one_frame_chunk_jax_...)
    q, e, bt = (np.repeat(a[None], 2, 1) for a in (
        q.astype(np.int16), e.astype(np.int16), bt.astype(np.int8)))
    assert q[0, 0, 0] == q16
    args = (torch.from_numpy(q), torch.from_numpy(e), torch.from_numpy(bt))
    got = synth_pre.synth_pre_plain(*args, fs)
    e_bin = e[0, 0].astype(np.int32)[T.unified_layout(fs)["bin_band"][
        int(bt[0, 0])]]
    xhat = np.array(jquant.dequantize(jnp.asarray(q[0].astype(np.int32)),
                                      jnp.asarray(e_bin[None])))
    x = torch.from_numpy(xhat)
    want = (*xmath.dct_iv_pre(x), *xmath.dct_iv_pre(x.reshape(2, 8, 128)))
    for g, w in zip(got, want):
        assert_bits(g, w)
    pcm, _, tail = decoder._synth_chunk(*args, fs, "sine", False)
    jpcm, _, jtail = _jax_synth(q, e, bt, fs, "sine", False)
    assert_bits(pcm, jpcm.T)
    assert_bits(tail, jtail)
