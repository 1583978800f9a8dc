"""The port's sharded encode and decode (mrcaudiocodec_tpu_torch/parallel/
sharded.py) on the CPU, every shard in turn in one process (LocalShards).

Bitwise, with no tolerance: sharded streams and decisions == the port's
unsharded encode at (data, seq) = (1, 8), (2, 4), (8, 1) as
tests/test_sharded.py holds the JAX engine, with mixed lengths, int16
input and window switching on and off; the decisions and the decoded PCM
== the JAX `sharded_encode_step` / `sharded_decode` at (2, 4) on the 8
virtual CPU devices of tests/conftest.py; the block types of the wider
halo == those of the JAX flag exchange at every shard edge; the
reservoir's split-and-carry == `budgets_scan` on the whole row. Tests
marked `cuda` run the same equalities on a card and skip here. The
multi-process runs (gloo) are in tests/test_torch_launch.py.
"""
import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec, encoder
from mrcaudiocodec_tpu_torch.ops import reservoir
from mrcaudiocodec_tpu_torch.parallel import mesh, sharded

torch.set_num_threads(1)
GRIDS = [(1, 8), (2, 4), (8, 1)]
MONO = CodecConfig(fs=44100, channels=1, bitrate=96000)
KEYS = ("q", "amp", "gain", "bt", "cb")


def _clip(nf, seed, channels=1, fs=44100, bursts=()):
    """A clip of nf frames: two tones, noise, a burst a third in, and a
    burst at each sample position in `bursts`. [n, channels] float32."""
    rng = np.random.default_rng(seed)
    n = (nf - 1) * C.HOP            # frames_for_samples(n) == nf
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * (300 + 100 * seed) * t)
         + 0.05 * rng.standard_normal(n)).astype(np.float32)
    for p in (n // 3,) + tuple(bursts):
        x[p:p + 64] += (0.5 * rng.standard_normal(64)).astype(np.float32)
    x = np.clip(x, -1, 1)
    if channels == 2:
        return np.stack([x, np.roll(x, 7) * 0.8], 1)
    return x[:, None]


def _encode(clips, cfg, n_data, n_seq, pack=True, device="cpu"):
    grid = mesh.make_grid(n_data, n_seq)
    rows, nf_row, n_samples = sharded.pad_rows(clips, n_seq)
    return sharded.sharded_encode(rows, nf_row, cfg, grid,
                                  sharded.LocalShards(grid, device),
                                  pack=pack, n_samples=n_samples)


@pytest.mark.parametrize("n_data,n_seq", GRIDS)
def test_sharded_encode_equals_unsharded(n_data, n_seq):
    """Mono 44.1 kHz 96 kbps, 8 frames a shard: streams and decisions."""
    nf = 8 * n_seq
    clips = [_clip(nf, c) for c in range(max(n_data, 2))]
    streams = _encode(clips, MONO, n_data, n_seq)
    dec = _encode(clips, MONO, n_data, n_seq, pack=False)
    for c, x in enumerate(clips):
        assert streams[c] == codec.encode(x, MONO, device="cpu"), c
        want, nf2 = encoder.encode_arrays(x, MONO, device="cpu")
        assert nf2 == nf
        for k in KEYS:
            np.testing.assert_array_equal(dec[k][c], want[k][0],
                                          f"clip {c} {k}")


@pytest.mark.parametrize("n_data,n_seq,dtype,switching", [
    (2, 3, "int16", True), (1, 4, "float32", False)])
def test_sharded_stereo_mixed_lengths(n_data, n_seq, dtype, switching):
    """Stereo clips of 9 .. 23 frames share rows of the longest: each
    row's true frame count (nf_row) masks its pad frames out of the
    reservoir, and stream order out of the body; int16 rides the halos
    as int16."""
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000,
                      window_switching=switching)
    clips = [_clip(nf, 10 + i, channels=2)
             for i, nf in enumerate([23, 9, 17])]
    if dtype == "int16":
        clips = [np.clip(np.round(x * 32768.0), -32768, 32767).astype(
            np.int16) for x in clips]
    streams = _encode(clips, cfg, n_data, n_seq)
    for c, x in enumerate(clips):
        assert streams[c] == codec.encode(x, cfg, device="cpu"), c


def test_shard_chunks_inside_a_shard(monkeypatch):
    """A shard longer than ENC_ROW_FRAMES // rows runs its frames in the
    encoder's chunks; inner seams use the shard's own samples."""
    monkeypatch.setattr(encoder, "ENC_ROW_FRAMES", 10)       # 5 frames x 2
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    x = _clip(24, 3, channels=2)
    assert _encode([x], cfg, 1, 2)[0] == codec.encode(x, cfg, device="cpu")


def test_too_short_shards_raise():
    grid = mesh.make_grid(1, 4)
    rows = np.zeros((1, 4 * C.HOP), np.float32)
    with pytest.raises(ValueError, match="at least 2 frames"):
        sharded.sharded_encode(rows, [4], MONO, grid,
                               sharded.LocalShards(grid, "cpu"),
                               n_samples=[100])
    assert sharded.pad_rows([np.zeros((100, 1), np.float32)], 4)[0].shape \
        == (1, 8 * C.HOP)


@pytest.mark.parametrize("n_seq", range(1, 9))
def test_reservoir_split_and_carry_equals_scan(n_seq):
    """S-way split of random desired bits (long runs below the mean fill
    the reservoir to its cap, runs above drain it to 0): the shard totals'
    carry and each shard's prefix give budgets_scan's budgets; the shards'
    masked PE sums give the whole row's."""
    rng = np.random.default_rng(n_seq)
    mean, cap, rows, f = 2000, 3000, 3, 12 * n_seq
    lo = rng.integers(400, 1200, (rows, f))
    hi = rng.integers(2600, 3600, (rows, f))
    runs = (np.arange(f) // 5) % 2 == 0
    desired = torch.from_numpy(np.where(runs, lo, hi))
    want = reservoir.budgets_scan(desired, mean, cap)
    r, level = np.zeros((rows, f), np.int64), np.zeros(rows, np.int64)
    for i in range(f):
        r[:, i] = level
        level = np.clip(level + mean - desired[:, i].numpy(), 0, cap)
    assert (r == cap).any() and (r[:, 1:] == 0).any()
    np.testing.assert_array_equal(want.numpy(),
                                  np.minimum(desired.numpy(), mean + r))
    k = f // n_seq
    prefix = [reservoir.local_maps(desired[:, s * k:(s + 1) * k], mean, cap)
              for s in range(n_seq)]
    totals = tuple(torch.stack([p[i][:, -1] for p in prefix])
                   for i in range(3))
    got = torch.cat([reservoir.budgets_from_prefix(
        desired[:, s * k:(s + 1) * k], prefix[s],
        reservoir.carry_in(totals, s), mean) for s in range(n_seq)], 1)
    assert torch.equal(got, want)

    pe = torch.from_numpy(rng.uniform(0, 70000, (rows, f)).astype(np.float32))
    nf_row = [f, f - k // 2 - 1, 1]
    whole = reservoir.masked_pe(pe, nf_row).sum(-1)
    parts = sum(reservoir.masked_pe(pe[:, s * k:(s + 1) * k], nf_row,
                                    s * k).sum(-1) for s in range(n_seq))
    assert torch.equal(parts, whole)


def test_block_types_equal_jax_flag_exchange():
    """The wider halo's block types == JAX `_block_types_sharded` fed the
    neighbours' boundary transient flags, at (1, 4) with bursts on and
    around the shard edges (frames 7/8, 16, 23/24)."""
    import jax.numpy as jnp
    from mrcaudiocodec_tpu.ops import dsp as jdsp
    from mrcaudiocodec_tpu.parallel.sharded import _block_types_sharded
    from mrcaudiocodec_tpu.spec.dsp import frame_signal

    nf, n_seq, k = 32, 4, 8
    # a burst at sample p lies in frames p // HOP and p // HOP + 1
    x = _clip(nf, 5, bursts=(7 * C.HOP + 500, 15 * C.HOP + 300,
                             23 * C.HOP + 900))
    tr = np.asarray(jdsp.detect_transients(jnp.asarray(frame_signal(x[:, 0]))))
    want = []
    for s in range(n_seq):
        t = tr[s * k:(s + 1) * k]
        prev = tr[s * k - 1] if s else False
        nxt = tr[(s + 1) * k] if s + 1 < n_seq else False
        want.append(np.asarray(_block_types_sharded(
            jnp.asarray(t), jnp.asarray(prev), jnp.asarray(nxt), True)))
    want = np.concatenate(want)
    got = _encode([x], MONO, 1, n_seq, pack=False)["bt"][0]
    np.testing.assert_array_equal(got, want)
    edges = [f for s in range(1, n_seq) for f in (s * k - 1, s * k)]
    assert (want[edges] != C.LONG).sum() >= 4, want


def test_decisions_equal_jax_sharded_encode_step():
    """The port's decisions (pack=False) == JAX sharded_encode_step's at
    (2, 4), mono 44.1 kHz 96 kbps, 2 clips x 64 frames."""
    import jax
    from mrcaudiocodec_tpu.config import CodecConfig as JCfg
    from mrcaudiocodec_tpu.parallel import mesh as jmesh
    from mrcaudiocodec_tpu.parallel.sharded import sharded_encode_step
    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    nf = 64
    clips = [_clip(nf, c) for c in range(2)]
    rows, _, _ = sharded.pad_rows(clips, 4)
    assert rows.shape[1] == nf * C.HOP
    jm = jmesh.make_mesh(2, 4)
    step = sharded_encode_step(jm, JCfg(fs=44100, channels=1,
                                        bitrate=96000), nf)
    out = step(jax.device_put(rows, jmesh.seq_sharding(jm)))
    want = dict(zip(("q", "amp", "gain", "bt", "bits", "cb"),
                    (np.asarray(v) for v in out)))
    got = _encode(clips, MONO, 2, 4, pack=False)
    for k in KEYS:
        np.testing.assert_array_equal(got[k], want[k].reshape(got[k].shape),
                                      k)


def test_sharded_decode_equals_jax_sharded_decode():
    import jax
    from mrcaudiocodec_tpu.parallel import mesh as jmesh
    from mrcaudiocodec_tpu.parallel.sharded import sharded_decode as jdecode
    if jax.device_count() < 8:
        pytest.skip("needs the 8 virtual CPU devices of tests/conftest.py")
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    bs = codec.encode(_clip(20, 1, channels=2), cfg, device="cpu")
    want, _ = jdecode(bs, jmesh.make_mesh(2, 4))
    grid = mesh.make_grid(2, 4)
    got, cfg2 = sharded.sharded_decode(bs, grid,
                                       sharded.LocalShards(grid, "cpu"))
    assert cfg2 == cfg
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_data,n_seq", GRIDS)
def test_sharded_decode_equals_decode(n_data, n_seq):
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    bs = codec.encode(_clip(27, 2, channels=2), cfg, device="cpu")
    want, _ = codec.decode(bs, device="cpu")
    grid = mesh.make_grid(n_data, n_seq)
    got, _ = sharded.sharded_decode(bs, grid,
                                    sharded.LocalShards(grid, "cpu"))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n_data,n_seq", [(1, 4), (2, 2)])
def test_sharded_decode_silence_across_shard_edges(n_data, n_seq):
    """A stereo clip silent from its fifth frame on, so -0 samples meet at
    the shard edges: the sharded float32 PCM equals codec.decode's by int32
    view (each shard's first hop is first + the halo's tail, one f32 add,
    where a chunk of codec.decode has first + prev too)."""
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    x = _clip(24, 3, channels=2)
    x[4 * C.HOP:] = 0.0
    bs = codec.encode(x, cfg, device="cpu")
    want, _ = codec.decode(bs, device="cpu")
    assert (want.view(np.int32) == np.int32(-2 ** 31)).sum() > 1000
    grid = mesh.make_grid(n_data, n_seq)
    got, _ = sharded.sharded_decode(bs, grid,
                                    sharded.LocalShards(grid, "cpu"))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_exchange_for_another_grid_raises():
    a, b = mesh.make_grid(1, 2), mesh.make_grid(2, 1)
    with pytest.raises(ValueError, match="another grid"):
        sharded.sharded_decode(b"", a, sharded.LocalShards(b, "cpu"))


def test_local_shards_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA"):
        sharded.LocalShards(mesh.make_grid(1, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("n_data,n_seq", [(1, 4), (2, 2)])
def test_sharded_on_card(n_data, n_seq):
    """On the card: sharded streams == codec.encode, sharded decode ==
    codec.decode, both on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    clips = [_clip(nf, 20 + i, channels=2) for i, nf in enumerate([40, 33])]
    streams = _encode(clips, cfg, n_data, n_seq, device="cuda")
    for c, x in enumerate(clips):
        assert streams[c] == codec.encode(x, cfg, device="cuda"), c
    grid = mesh.make_grid(n_data, n_seq)
    got, _ = sharded.sharded_decode(streams[0], grid,
                                    sharded.LocalShards(grid, "cuda"))
    want, _ = codec.decode(streams[0], device="cuda")
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
