"""Stream bodies built on the device (ops/device_pack.py, kernel K3) held
against the JAX package on the CPU.

The per-record plain packer (`device_pack.pack_records_plain`) must equal
the JAX `pack_records_device` byte for byte, rec and nbytes, and the
port's native host packer, on random decisions that reach every codebook,
block type and escape length at all three sample rates. The plain version
of K3 (`pack_stream_plain`, what `pack_stream` runs for CPU tensors) must
give the JAX records of its `order` back to back, for a shuffled order
and one that skips records. `codec.encode(..., device="cpu")` must equal
the JAX `encode_device_packed` and the spec stream. K3 on the card is
held against the plain version in tests/test_torch_kernels.py (`-m
cuda`).
"""
import functools

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu.config import CodecConfig as JCfg
from mrcaudiocodec_tpu.ops import device_pack as jdevice_pack
from mrcaudiocodec_tpu.spec import codec as scodec

from mrcaudiocodec_tpu_torch import native
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec, encoder, packing
from mrcaudiocodec_tpu_torch.ops import device_pack
from mrcaudiocodec_tpu_torch.ops.kernels import record_pack

from tests.test_conformance import CASES, make_clip

torch.set_num_threads(1)
RATES = (32000, 44100, 48000)


def _decisions(fs, nf=10, seed=0):
    return record_pack.random_decisions(np.random.default_rng(seed + fs), nf,
                                        fs)


def _pack_plain(d, fs, cap):
    rec, nbytes = device_pack.pack_records_plain(*map(torch.from_numpy, d),
                                                 fs, cap)
    return rec.numpy(), nbytes.numpy()


@functools.lru_cache(maxsize=None)
def _jax_records(fs, nf, cap):
    """The JAX pack_records_device records of _decisions(fs, nf): (rec
    [nf, cap], nbytes [nf]) as numpy."""
    import jax.numpy as jnp
    jrec, jn = jdevice_pack.pack_records_device(
        *map(jnp.asarray, _decisions(fs, nf)), fs=fs, cap_bytes=cap)
    return np.asarray(jrec), np.asarray(jn)


def _order(kind, nf, rng):
    if kind == "shuffled":
        return rng.permutation(nf)
    # skips records, as the corpus batch's pad frames are skipped, and
    # takes the rest out of order
    keep = np.flatnonzero(rng.random(nf) < 0.6)
    return rng.permutation(keep)


def test_random_decisions_reach_every_slot_kind():
    for fs in RATES:
        q, amp, gain, bt, cb = _decisions(fs)
        assert set(bt.tolist()) == set(range(5))
        assert set(np.unique(cb).tolist()) == {0, 1, 2, 3}
        mags = np.abs(q.astype(np.int64))
        assert mags.max() == 4095 and 15 in mags and 16 in mags
        assert (q < 0).any()


@pytest.mark.parametrize("fs", RATES)
def test_plain_matches_jax_pack_records_device(fs):
    import jax.numpy as jnp
    d = _decisions(fs)
    cap = 1024
    rec, nbytes = _pack_plain(d, fs, cap)
    jrec, jn = jdevice_pack.pack_records_device(
        *map(jnp.asarray, d), fs=fs, cap_bytes=cap)
    np.testing.assert_array_equal(rec, np.asarray(jrec))
    np.testing.assert_array_equal(nbytes, np.asarray(jn))


@pytest.mark.parametrize("fs", RATES)
def test_plain_matches_native_packer(fs):
    d = _decisions(fs, nf=25, seed=1)
    rec, nbytes = _pack_plain(d, fs, 2048)
    body = b"".join(rec[i, :n].tobytes() for i, n in enumerate(nbytes))
    assert body == native.pack_records_native(*d, fs)


@pytest.mark.parametrize("kind", ["shuffled", "skipping"])
@pytest.mark.parametrize("fs", RATES)
def test_pack_stream_plain_is_jax_records_in_order(fs, kind):
    nf, cap = 10, 1024
    order = _order(kind, nf, np.random.default_rng(fs))
    assert kind == "shuffled" or 0 < len(order) < nf
    jrec, jn = _jax_records(fs, nf, cap)
    body, nbytes, status = device_pack.pack_stream(
        *map(torch.from_numpy, _decisions(fs, nf)),
        torch.from_numpy(order.astype(np.int32)), fs, cap)
    want = b"".join(jrec[r, :jn[r]].tobytes() for r in order)
    total = len(want)
    assert status.tolist() == [total, int(jn[order].max())]
    np.testing.assert_array_equal(nbytes.numpy(), jn[order])
    assert body.shape == (len(order) * cap,)
    assert body[:total].numpy().tobytes() == want
    assert not body[total:].any()


def test_pack_stream_empty_order():
    d = [torch.from_numpy(v) for v in _decisions(44100, nf=3)]
    body, nbytes, status = device_pack.pack_stream(
        *d, torch.zeros(0, dtype=torch.int32), 44100, 256)
    assert body.numel() == nbytes.numel() == 0
    assert status.tolist() == [0, 0]


def test_stream_order_skips_pad_frames():
    """A corpus chunk of frames [4, 8) over 3 stereo clips of 9, 6 and 3
    true frames: clip by clip, frame by frame, channels within a frame."""
    order, counts = encoder.stream_order(np.repeat([9, 6, 3], 2), 2, 4, 4, 6)
    rec = lambda j, c, f: (j * 2 + c) * 4 + f - 4
    want = ([rec(0, c, f) for f in range(4, 8) for c in (0, 1)]
            + [rec(1, c, f) for f in range(4, 6) for c in (0, 1)])
    assert order.dtype == np.int32 and order.tolist() == want
    assert counts.tolist() == [8, 4, 0]
    body = np.arange(sum(range(1, 13)), dtype=np.uint8)
    parts = encoder.clip_slices(body, np.arange(1, 13), counts)
    assert [len(p) for p in parts] == [36, 42, 0]
    assert b"".join(parts) == body.tobytes()
    whole, counts = encoder.stream_order(None, 2, 0, 5, 2)   # one clip
    assert whole.tolist() == [0, 5, 1, 6, 2, 7, 3, 8, 4, 9]
    assert counts.tolist() == [10]
    mono, counts = encoder.stream_order(None, 1, 0, 5, 2)    # two clips
    assert mono.tolist() == list(range(10)) and counts.tolist() == [5, 5]


def _escape_clip():
    rng = np.random.default_rng(0)
    x = np.clip(0.9 * rng.standard_normal(30000), -1, 1).astype(np.float32)
    return x[:, None]


@pytest.mark.parametrize("case", ["mono_96k", "stereo_128k",
                                  "noise_256k_escapes"])
def test_encode_matches_jax_device_packed_and_spec(case):
    """Every case against the spec stream; the escape case also against
    the JAX encode_device_packed (one XLA compile, ~10 s on the CPU)."""
    from mrcaudiocodec_tpu.models import encoder as jencoder
    if case == "noise_256k_escapes":
        x, ch, br = _escape_clip(), 1, 256000
    else:
        ch, br = (1, 96000) if case == "mono_96k" else (2, 128000)
        x = make_clip(44100, 0.5, ch)
    cfg = CodecConfig(fs=44100, channels=ch, bitrate=br)
    bs = codec.encode(x, cfg, device="cpu")
    jcfg = JCfg(fs=44100, channels=ch, bitrate=br)
    if case == "noise_256k_escapes":
        assert bs == jencoder.encode_device_packed(x, jcfg)
    assert bs == scodec.encode(x, jcfg)
    dec, nf = encoder.encode_arrays(x, cfg, device="cpu")
    assert bs == packing.pack_stream(dec, nf, x.shape[0], cfg)
    if case == "noise_256k_escapes":
        assert np.abs(dec["q"]).max() >= 16


@pytest.mark.parametrize("name,fs,channels,bitrate,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_record_cap_bytes_matches_jax(name, fs, channels, bitrate, kw):
    cfg = CodecConfig(fs=fs, channels=channels, bitrate=bitrate, **kw)
    jcfg = JCfg(fs=fs, channels=channels, bitrate=bitrate, **kw)
    assert device_pack.record_cap_bytes(cfg) == \
        jdevice_pack.record_cap_bytes(jcfg)
    assert device_pack.pack_cap_bytes(cfg) == \
        device_pack.record_cap_bytes(cfg)


@pytest.mark.parametrize("fs,ch,br", [(48000, 2, 16000), (44100, 1, 8000)],
                         ids=["16k_stereo_48k", "8k_mono_44k"])
def test_low_bitrate_encode_matches_spec(fs, ch, br):
    """Frames no gain fits send more than record_cap_bytes (the JAX
    device pack truncates them); the encoder packs with pack_cap_bytes."""
    cfg = CodecConfig(fs=fs, channels=ch, bitrate=br)
    assert device_pack.pack_cap_bytes(cfg) > device_pack.record_cap_bytes(cfg)
    x = make_clip(fs, 0.5, ch)
    bs = codec.encode(x, cfg, device="cpu")
    assert bs == scodec.encode(x, JCfg(fs=fs, channels=ch, bitrate=br))
    dec, nf = encoder.encode_arrays(x, cfg, device="cpu")
    need = int(device_pack.pack_records_plain(
        *[torch.from_numpy(np.swapaxes(dec[k], 0, 1).reshape(
            (nf * ch,) + dec[k].shape[2:]).astype(dt)) for k, dt in (
            ("q", np.int16), ("amp", np.int8), ("gain", np.int16),
            ("bt", np.int8), ("cb", np.int8))], fs, 4096)[1].max())
    assert device_pack.record_cap_bytes(cfg) < need
    assert need <= device_pack.pack_cap_bytes(cfg)


def test_too_small_cap_raises():
    d = _decisions(44100, nf=4)
    _, nbytes = _pack_plain(d, 44100, 2048)
    need = int(nbytes.max())
    rec, _ = _pack_plain(d, 44100, need)           # exactly enough: packs
    assert rec.shape == (4, need)
    with pytest.raises(ValueError, match="more than cap"):
        _pack_plain(d, 44100, need - 1)
    order = torch.arange(4, dtype=torch.int32)
    args = [*map(torch.from_numpy, d), order, 44100]
    assert device_pack.pack_stream(*args, need)[2].tolist() == [
        int(nbytes.sum()), need]
    with pytest.raises(ValueError, match="more than cap"):
        device_pack.pack_stream(*args, need - 1)


def test_pack_records_rejects_bad_inputs():
    q, amp, gain, bt, cb = map(torch.from_numpy, _decisions(44100, nf=2))
    order = torch.arange(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="want contiguous"):
        device_pack.pack_stream(q.to(torch.int32), amp, gain, bt, cb, order,
                                44100, 512)
    with pytest.raises(ValueError, match="want contiguous"):
        device_pack.pack_stream(q, amp[:, :-1], gain, bt, cb, order, 44100,
                                512)
    with pytest.raises(ValueError, match="int32 order"):
        device_pack.pack_stream(q, amp, gain, bt, cb, order.long(), 44100,
                                512)
    with pytest.raises(ValueError, match="want contiguous"):
        record_pack.pack_stream_kernel(q, amp, gain, bt, cb, order, 44100,
                                       512)


def test_code_table_and_pair_band():
    """The kernel's merged codebook and pair -> band map, on the host."""
    from mrcaudiocodec_tpu_torch import tables as T
    tab = record_pack.code_table().astype(np.int64)
    ca = T.code_arrays()
    at = 0
    for book, size in zip(record_pack.BOOKS, (81, 81, 289, 121)):
        part = tab[at:at + size]
        np.testing.assert_array_equal(part & 0xFFFFFF, ca[f"codes_{book}"])
        np.testing.assert_array_equal(part >> 24, ca[f"len_{book}"])
        at += size
    assert at == len(tab) == 572
    for fs in RATES:
        lay = T.unified_layout(fs)
        pb = record_pack.pair_band(fs)
        np.testing.assert_array_equal(pb, lay["bin_band"][:, 1::2])
        assert lay["nb"] <= 128
