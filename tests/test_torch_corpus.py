"""The port's corpus path (mrcaudiocodec_tpu_torch/corpus.py) on the CPU.

A fused batch (every channel of every clip one row, tail-padded to a
shared frame count, each row's true frame count carried into the
reservoir) must give each clip the stream that encoding it alone gives,
and that the spec codec gives. `run_corpus` mirrors
tests/test_corpus_parallel.py: resume, basename de-collision, one batch
per bucket of mixed lengths.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu.config import CodecConfig as JCfg
from mrcaudiocodec_tpu.spec import codec as scodec

from mrcaudiocodec_tpu_torch import audiofile, corpus
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec, encoder
from mrcaudiocodec_tpu_torch.ops import reservoir

torch.set_num_threads(1)
CFG = CodecConfig(fs=44100, channels=2, bitrate=128000)


@pytest.fixture(autouse=True)
def _small_bucket(monkeypatch):
    """Pad fused rows to 32 frames, not 64: the CPU runs every pad frame
    through the plain kernels. The clips here (12 .. 28 frames) still
    share one bucket and still carry tail padding."""
    monkeypatch.setattr(corpus, "FRAME_BUCKET", 32)


def _mixed_lengths():
    """0.25 .. 0.62 s: frame counts 12 .. 28, one bucket."""
    return [corpus._synth_corpus(1, sec, seed=100 + i)[0]
            for i, sec in enumerate([0.25, 0.33, 0.41, 0.5, 0.62])]


@pytest.mark.parametrize("reservoir_on", [True, False])
def test_allocate_nf_row_equals_rows_alone(reservoir_on):
    cfg = CodecConfig(fs=44100, channels=1, bitrate=96000,
                      reservoir=reservoir_on)
    rng = np.random.default_rng(4)
    nf_row = [40, 25, 13, 1]
    pe = torch.from_numpy(rng.uniform(0, 3000, (4, 40)).astype(np.float32))
    got = reservoir.allocate(pe, cfg, nf_row=nf_row)
    for r, n in enumerate(nf_row):
        alone = reservoir.allocate(pe[r:r + 1, :n], cfg)
        assert torch.equal(got[r:r + 1, :n], alone), r
    full = torch.full((4,), 40)
    assert torch.equal(reservoir.allocate(pe, cfg, nf_row=full),
                       reservoir.allocate(pe, cfg))


def test_fused_mixed_lengths_equal_per_clip_and_spec(monkeypatch):
    clips = _mixed_lengths()
    calls = []
    rows = encoder.encode_rows
    monkeypatch.setattr(
        encoder, "encode_rows",
        lambda pcm, nf, *a: calls.append((pcm.clips.shape[0], nf))
        or rows(pcm, nf, *a))
    out = corpus.encode_batch(clips, CFG, device="cpu")
    assert len(calls) == 1 and calls[0][0] == 5      # one batch, 10 rows
    assert calls[0][1] == 32                         # one bucket
    monkeypatch.setattr(encoder, "encode_rows", rows)
    jcfg = JCfg(fs=44100, channels=2, bitrate=128000)
    for i, x in enumerate(clips):
        assert out[i] == codec.encode(x, CFG, device="cpu"), i
        assert out[i] == scodec.encode(x, jcfg), i


def test_fused_int16_matches_float():
    clips = corpus._synth_corpus(3, 0.4, seed=5)
    as_i16 = [np.clip(np.round(c * 32768.0), -32768, 32767).astype(np.int16)
              for c in clips]
    as_f32 = [i.astype(np.float32) / np.float32(32768.0) for i in as_i16]
    out_i = corpus.encode_batch(as_i16, CFG, device="cpu")
    assert out_i == corpus.encode_batch(as_f32, CFG, device="cpu")
    assert out_i == [codec.encode(x, CFG, device="cpu") for x in as_i16]


def test_mixed_channels_or_dtypes_encode_per_clip(monkeypatch):
    stereo = corpus._synth_corpus(2, 0.3, seed=1)
    mono = corpus._synth_corpus(1, 0.3, channels=1, seed=2)[0]
    monkeypatch.setattr(corpus, "_encode_batch_fused",
                        lambda *a: pytest.fail("a mixed batch was fused"))
    # per clip, so the mono clip meets the stereo config and is refused
    with pytest.raises(ValueError, match="channels"):
        corpus.encode_batch([stereo[0], mono], CFG, device="cpu")
    as_i16 = np.clip(np.round(stereo[1] * 32768.0), -32768, 32767
                     ).astype(np.int16)
    assert corpus.encode_batch([stereo[0], as_i16], CFG, device="cpu") == [
        codec.encode(stereo[0], CFG, device="cpu"),
        codec.encode(as_i16, CFG, device="cpu")]


def _write(tmpdir, clips, names, fs=44100):
    paths = []
    for x, name in zip(clips, names):
        p = os.path.join(str(tmpdir), name)
        audiofile.write_wav(p, x, fs)
        paths.append(p)
    return paths


def _read_back(path, bitrate):
    x, fs = audiofile.read_wav(path, raw_int16=True)
    return x, CodecConfig(fs=fs, channels=x.shape[1], bitrate=bitrate)


def test_run_corpus_mixed_lengths_one_bucket(tmp_path):
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    clips = _mixed_lengths()[::2]                    # 12, 19 and 28 frames
    paths = _write(indir, clips, [f"len{i}.wav" for i in range(len(clips))])
    stats = corpus.run_corpus(paths, str(outdir), {"bitrate": 128000},
                              device="cpu")
    assert stats["encoded"] == len(clips)
    assert stats["batches"] == 1, "mixed lengths should share one bucket"
    assert stats["devices_local"] == stats["devices_global"] == 1
    for i, p in enumerate(paths):
        x, cfg = _read_back(p, 128000)
        with open(outdir / f"len{i}.mrc", "rb") as f:
            assert f.read() == codec.encode(x, cfg, device="cpu"), i


def test_run_corpus_resume_and_mixed_shapes(tmp_path):
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    pa = _write(indir, corpus._synth_corpus(2, 0.3), ["s0.wav", "s1.wav"])
    pb = _write(indir, corpus._synth_corpus(2, 0.5, channels=1, seed=7),
                ["m0.wav", "m1.wav"])
    s1 = corpus.run_corpus(pa + pb, str(outdir), {"bitrate": 96000},
                           device="cpu")
    assert s1["encoded"] == 4 and s1["batches"] == 2
    for p in pa + pb:
        x, cfg = _read_back(p, 96000)
        base = os.path.splitext(os.path.basename(p))[0]
        with open(outdir / f"{base}.mrc", "rb") as f:
            assert f.read() == codec.encode(x, cfg, device="cpu"), p
    s2 = corpus.run_corpus(pa + pb, str(outdir), {"bitrate": 96000},
                           device="cpu")
    assert s2["encoded"] == 0 and s2["skipped"] == 4


def test_run_corpus_basename_collision(tmp_path):
    ina, inb, outdir = tmp_path / "a", tmp_path / "b", tmp_path / "out"
    ina.mkdir(), inb.mkdir()
    pa = _write(ina, corpus._synth_corpus(1, 0.3, seed=1), ["same.wav"])[0]
    pb = _write(inb, corpus._synth_corpus(1, 0.3, seed=2), ["same.wav"])[0]
    stats = corpus.run_corpus([pa, pb], str(outdir), {"bitrate": 96000},
                              device="cpu")
    assert stats["encoded"] == 2
    outs = sorted(os.path.basename(p) for p in glob.glob(str(outdir / "*.mrc")))
    assert outs == ["same.1.mrc", "same.mrc"]
    with open(outdir / "manifest.jsonl") as f:
        recs = [json.loads(line) for line in f]
    assert {r["src"] for r in recs} == {pa, pb}
    assert len({r["dst"] for r in recs}) == 2
    s2 = corpus.run_corpus([pa, pb], str(outdir), {"bitrate": 96000},
                           device="cpu")
    assert s2["encoded"] == 0 and s2["skipped"] == 2


def test_corpus_main_run(tmp_path, capsys):
    indir = tmp_path / "in"
    indir.mkdir()
    _write(indir, corpus._synth_corpus(2, 0.3), ["a.wav", "b.wav"])
    assert corpus.main(["run", str(indir), str(tmp_path / "out"),
                        "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["encoded"] == 2 and stats["batches"] == 1


def test_corpus_needs_a_card_without_device_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="--device cpu"):
        corpus.main(["run", str(tmp_path / "in"), str(tmp_path / "out")])
    with pytest.raises(RuntimeError, match="CUDA"):
        corpus.encode_batch(corpus._synth_corpus(2, 0.3), CFG)
