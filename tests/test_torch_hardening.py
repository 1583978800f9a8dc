"""The port's copies of the stream guards, held to the reference's cases.

The port keeps its own copies of the JAX package's stream parsing: the
header and record-prefix reader (`bitstream.py`), the native record
decoder (`native/mrc_native.cpp`) and the spec decoder's escape-exponent
guard (`spec/entropy.py`). These are the reference's hardening cases
(tests/test_native.py, the corrupt-stream fuzz of decode_records;
tests/test_spec_roundtrip.py, header and prefix hardening, corrupt and
random streams, the oversized escape and the QMAX escape round trip) run
on the port's copies, plus the port's own decoder (`models/decoder.py`) on
the CPU and, on a card only, on the card. Every seed is fixed. Streams
come from the port's NumPy spec encoder, so this module imports nothing of
the JAX package and runs on the card's machine as well.
"""
import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch import bitstream, native
from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import decoder
from mrcaudiocodec_tpu_torch.spec import codec as spec
from mrcaudiocodec_tpu_torch.spec.entropy import (_Bits, decode_frame_content,
                                                  encode_frame_symbols)
from mrcaudiocodec_tpu_torch.utils.bits import BitWriter, pack_codes

torch.set_num_threads(1)


def make_clip(fs, seconds, seed=0):
    """A mono test clip: two tones, a noise floor and a burst."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.15 * np.sin(2 * np.pi * 2750 * t)
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
    x[n // 3:n // 3 + 64] += (0.6 * rng.standard_normal(64)).astype(
        np.float32)
    return np.clip(x, -1, 1)[:, None]


def _bits(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, dtype=np.uint8))


def _stream(fs=44100, seconds=0.3, seed=5):
    cfg = CodecConfig(fs=fs, channels=1, bitrate=96000)
    return spec.encode(make_clip(fs, seconds, seed), cfg), cfg


def _corrupt(data: bytes, rng, flips: int) -> bytes:
    """data with `flips` random bytes of its body XORed, cut at a random
    length past the header."""
    buf = bytearray(data)
    for _ in range(flips):
        pos = int(rng.integers(bitstream.HEADER_BYTES, len(buf)))
        buf[pos] ^= int(rng.integers(1, 256))
    return bytes(buf[:int(rng.integers(bitstream.HEADER_BYTES + 4,
                                       len(buf) + 1))])


@pytest.mark.parametrize("fs", [44100, 32000])
def test_native_decode_corrupt_stream_safe(fs):
    """Corrupt and truncated payloads through the native record decoder
    raise ValueError or decode; never a crash or an overrun
    (tests/test_native.py:63)."""
    rng = np.random.default_rng(9)
    data, cfg = _stream(fs=fs)
    _, nf, _, hb = bitstream.read_header(data)
    offs, _ = bitstream.frame_byte_offsets(data, hb // 8, nf)
    content_offs = offs * 8 + C.FRAME_LEN_BITS
    raised = 0
    for _ in range(12):
        cut = _corrupt(data, rng, 40)
        n_fit = int(np.searchsorted(offs, len(cut)))
        try:
            q, e_band, bt, gain = native.decode_records(
                cut, content_offs[:max(n_fit, 1)], cfg.fs)
            assert q.shape[1] == C.LONG_COEFFS and len(bt) == len(gain)
        except ValueError:
            raised += 1
    assert raised > 0


def test_native_decode_clean_stream_is_the_spec_records():
    data, cfg = _stream()
    _, nf, _, hb = bitstream.read_header(data)
    offs, _ = bitstream.frame_byte_offsets(data, hb // 8, nf)
    q, _, bt, gain = native.decode_records(
        data, offs * 8 + C.FRAME_LEN_BITS, cfg.fs)
    bits = _bits(data)
    for r in (0, nf // 2, nf - 1):
        q2, _, bt2, gain2 = decode_frame_content(
            _Bits(bits, int(offs[r]) * 8 + C.FRAME_LEN_BITS), cfg.fs)
        np.testing.assert_array_equal(q[r], q2)
        assert (bt[r], gain[r]) == (bt2, gain2)


def test_header_and_prefix_hardening():
    """Corrupt headers and truncated record scans raise ValueError, never
    IndexError (tests/test_spec_roundtrip.py:140)."""
    bs, _ = _stream()
    buf = bytearray(bs)
    buf[5] = (0xF << 4) | (buf[5] & 0x0F)         # fs_code 15
    with pytest.raises(ValueError):
        bitstream.read_header(bytes(buf))
    with pytest.raises(ValueError):
        bitstream.read_header(bs[:10])            # shorter than the header
    buf = bytearray(bs)
    buf[10:14] = (0).to_bytes(4, "big")           # n_frames = 0
    with pytest.raises(ValueError):
        bitstream.read_header(bytes(buf))
    _, nf, _, hb = bitstream.read_header(bs)
    with pytest.raises(ValueError):               # the scan runs off the end
        bitstream.frame_byte_offsets(bs[:len(bs) - 2], hb // 8, nf)
    with pytest.raises(ValueError):               # absurd count, O(1)
        bitstream.frame_byte_offsets(bs, hb // 8, 2 ** 31)
    with pytest.raises(ValueError):
        bitstream.read_header(b"RIFF" + bs[4:])   # not an MRC1 stream


def test_spec_decode_corrupt_stream_safe():
    """The port's spec decoder rejects corrupt and truncated payloads with
    ValueError (tests/test_spec_roundtrip.py:189)."""
    rng = np.random.default_rng(11)
    bs, _ = _stream(seed=6)
    for _ in range(16):
        try:
            spec.decode(_corrupt(bs, rng, 30))
        except ValueError:
            pass


def test_spec_decode_random_bytes_safe():
    """A garbage body after a valid header: ValueError or a decoded signal
    (tests/test_spec_roundtrip.py:258)."""
    rng = np.random.default_rng(12)
    bs, _ = _stream(seconds=0.2, seed=7)
    head = bs[:bitstream.HEADER_BYTES]
    for _ in range(8):
        body = rng.integers(0, 256, size=len(bs) // 2, dtype=np.uint8)
        try:
            y, _ = spec.decode(head + body.tobytes())
            assert np.isfinite(y).all()
        except ValueError:
            pass


def _oversized_escape_content(fs):
    """One LONG record's content whose band 0 escapes with a unary prefix
    that would reach exponent 18 (QMAX needs at most 11)."""
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
    w.write(0, 1)                                 # sign
    w.write((1 << 14) - 1, 14)                    # the unary run
    w.write(0, 50)                                # no read runs off the end
    return w.getvalue()


def test_spec_decode_oversized_escape_rejected():
    """spec/entropy.py's escape guard (tests/test_spec_roundtrip.py:211)."""
    with pytest.raises(ValueError, match="escape exponent"):
        decode_frame_content(_Bits(_bits(_oversized_escape_content(44100))),
                             44100)


@pytest.mark.parametrize("fs", [44100, 48000, 32000])
def test_max_escape_roundtrips(fs):
    """QMAX itself (e = 11, all-ones suffix) decodes, in the spec decoder
    and the native one (tests/test_spec_roundtrip.py:242)."""
    q = np.zeros(C.LONG_COEFFS, dtype=np.int32)
    q[0], q[1], q[700] = C.QMAX, -C.QMAX, C.QMAX - 1
    amp = np.zeros(T.unified_layout(fs)["nb"], dtype=np.int32)
    codes, lens = encode_frame_symbols(q, amp, 120, 0, fs)
    data = pack_codes(np.asarray(codes, np.uint64), np.asarray(lens,
                                                               np.int64))
    q2, _, bt2, gain2 = decode_frame_content(_Bits(_bits(data)), fs)
    assert bt2 == 0 and gain2 == 120
    np.testing.assert_array_equal(q2, q)
    qn, _, btn, gainn = native.decode_records(data + bytes(8),
                                              np.zeros(1, np.int64), fs)
    np.testing.assert_array_equal(qn[0], q)
    assert (btn[0], gainn[0]) == (0, 120)


def _decoder_fuzz(device, trials, seed):
    """The port's decoder on corrupt streams -> how many raised ValueError
    (any other exception fails); a decoded stream has the header's shape
    and finite samples."""
    rng = np.random.default_rng(seed)
    bs, cfg = _stream(seed=8)
    _, _, n_samples, _ = bitstream.read_header(bs)
    raised = 0
    for _ in range(trials):
        try:
            y, _ = decoder.decode(_corrupt(bs, rng, 30), device=device)
            assert y.shape == (n_samples, 1) and np.isfinite(y).all()
        except ValueError:
            raised += 1
    with pytest.raises(ValueError):
        decoder.decode(bs[:len(bs) - 3], device=device)
    return raised


def test_decoder_cpu_corrupt_streams_raise_value_error():
    assert _decoder_fuzz("cpu", 16, 13) > 0


@pytest.mark.cuda
def test_decoder_card_corrupt_streams_raise_value_error():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    assert _decoder_fuzz("cuda", 16, 13) > 0
    bs, _ = _stream(seed=8)
    y_card, _ = decoder.decode(bs, device="cuda")
    y_cpu, _ = decoder.decode(bs, device="cpu")
    np.testing.assert_array_equal(y_card.view(np.int32), y_cpu.view(np.int32))
