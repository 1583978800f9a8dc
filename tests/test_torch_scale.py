"""Acceptance config 3 at its true length through the port: a 5-minute
48 kHz stereo 192 kbps encode, the port's stream held record for record
to the port's NumPy spec codec (`mrcaudiocodec_tpu_torch/spec/`).

The port's counterpart of tests/test_scale.py. It encodes on the card
where there is one (the kernels K1-K8 on the path), else on the CPU. The
spec encode runs about real time on one core, so the test is skipped
unless MRC_RUN_SLOW=1:

    MRC_RUN_SLOW=1 MRC_TESTS_KEEP_TPU=1 python -m pytest tests/test_torch_scale.py -q -s

It imports nothing of the JAX package, so it runs on the card's machine.
"""
import os
import time

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch import bitstream
from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec
from mrcaudiocodec_tpu_torch.spec import codec as spec
from mrcaudiocodec_tpu_torch.spec import entropy

pytestmark = pytest.mark.skipif(
    not os.environ.get("MRC_RUN_SLOW"),
    reason="minutes-scale run; set MRC_RUN_SLOW=1")


def make_track(fs, seconds, seed=0):
    """tests/test_scale.py's 5-minute program: a tone stack, a noise
    floor, transients every ~0.7 s and a slow loudness arc that works the
    reservoir at its horizon."""
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = np.zeros(n, np.float32)
    for f0, a in [(220, 0.3), (554, 0.18), (1320, 0.1), (3520, 0.06)]:
        x += (a * np.sin(2 * np.pi * f0 * t
                         + 0.1 * np.sin(2 * np.pi * 0.25 * t))
              ).astype(np.float32)
    x += (0.015 * rng.standard_normal(n)).astype(np.float32)
    for pos in range(fs // 2, n - 300, int(0.7 * fs)):
        x[pos:pos + 96] += (0.5 * rng.standard_normal(96)).astype(np.float32)
    x *= (0.675 + 0.325 * np.sin(2 * np.pi * t / seconds - np.pi / 2)
          ).astype(np.float32)
    x = np.clip(x, -1, 1)
    return np.stack([x, np.roll(x, 11) * 0.9], axis=1)


def records_of(bs):
    """An MRC1 stream's records, in stream order."""
    cfg, n_frames, _, bitpos = bitstream.read_header(bs)
    offs, lens = bitstream.frame_byte_offsets(bs, bitpos // 8,
                                              n_frames * cfg.channels)
    return [bs[int(o):int(o) + (C.FRAME_LEN_BITS + int(ln) + 7) // 8]
            for o, ln in zip(offs, lens)]


def decode_record(rec, fs):
    bits = np.unpackbits(np.frombuffer(rec, np.uint8))
    return entropy.decode_frame_content(
        entropy._Bits(bits, pos=C.FRAME_LEN_BITS), fs)


def snr_db(x, y):
    n = min(len(x), len(y))
    e = np.mean((x[:n].astype(np.float64) - y[:n]) ** 2)
    return 10 * np.log10(np.mean(x[:n].astype(np.float64) ** 2) / e)


def test_config3_five_minutes_record_for_record():
    device = "cuda" if torch.cuda.is_available() else "cpu"
    fs, seconds = 48000, 300.0
    cfg = CodecConfig(fs=fs, channels=2, bitrate=192000)
    x = make_track(fs, seconds)
    t0 = time.perf_counter()
    bs = codec.encode(x, cfg, device=device)
    t1 = time.perf_counter()
    bs_spec = spec.encode(x, cfg)
    t2 = time.perf_counter()
    recs, recs_spec = records_of(bs), records_of(bs_spec)
    same = sum(a == b for a, b in zip(recs, recs_spec))
    print(f"\nconfig 3, 5 min: {same}/{len(recs_spec)} records identical, "
          f"streams equal {bs == bs_spec}; port encode on {device} "
          f"{t1 - t0:.2f} s, spec encode {t2 - t1:.1f} s")
    assert len(recs) == len(recs_spec) == C.frames_for_samples(
        x.shape[0]) * 2
    for i, (a, b) in enumerate(zip(recs, recs_spec)):
        if a != b:
            qa, ea, bta, ga = decode_record(a, fs)
            qb, eb, btb, gb = decode_record(b, fs)
            raise AssertionError(
                f"{same}/{len(recs)} records identical; first diff record "
                f"{i}: bt {bta}/{btb}, gain {ga}/{gb}, sf diffs "
                f"{int((ea != eb).sum())}, q diffs {int((qa != qb).sum())}")
    assert bs == bs_spec
    assert len(bs) * 8 / seconds / 1000 <= 192.0 + 1.0
    y, _ = codec.decode(bs, device=device)
    s = snr_db(x, y)
    print(f"decode on {device}: SNR {s:.1f} dB")
    assert s > 25.0
