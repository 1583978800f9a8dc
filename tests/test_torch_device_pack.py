"""Record bytes built on the device (ops/device_pack.py, kernel K3) held
against the JAX package on the CPU.

The plain version of K3 (`device_pack.pack_records_plain`, what
`pack_records` runs for CPU tensors) must equal the JAX
`pack_records_device` byte for byte, rec and nbytes, and the port's
native host packer, on random decisions that reach every codebook, block
type and escape length at all three sample rates. `codec.encode(...,
device="cpu")` (device-packed records) must equal the JAX
`encode_device_packed` and the spec stream. K3 on the card is held
against the plain version in tests/test_torch_kernels.py (`-m cuda`).
"""
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
    rec, nbytes = device_pack.pack_records(*map(torch.from_numpy, d), fs, cap)
    return rec.numpy(), nbytes.numpy()


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


def test_pack_records_rejects_bad_inputs():
    q, amp, gain, bt, cb = map(torch.from_numpy, _decisions(44100, nf=2))
    with pytest.raises(ValueError, match="want contiguous"):
        device_pack.pack_records(q.to(torch.int32), amp, gain, bt, cb,
                                 44100, 512)
    with pytest.raises(ValueError, match="want contiguous"):
        device_pack.pack_records(q, amp[:, :-1], gain, bt, cb, 44100, 512)
    with pytest.raises(ValueError, match="want contiguous"):
        record_pack.pack_records_kernel(q, amp, gain, bt, cb, 44100, 512)


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
