"""The stage-keyed work count against the codec package's per-launch one.

On a small analysis chunk and a small decode slab, run on the CPU through
the kernels' plain versions, each stage's ops equal the sum of
`profiling.kernel_bound` over the kernels the stage launches on the
card, and its bytes are its inputs and outputs, each once.
"""
import numpy as np
import pytest
import torch

from mrcbench import gen, work

SEED = 2**31 + 23


def _nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


@pytest.mark.parametrize("case", [
    (44100, "music", True, True, np.int16),
    (48000, "tones", False, True, np.float32),
    (32000, "music", True, False, np.int16),
])
def test_analysis_count_equals_the_kernels(case):
    from mrcaudiocodec_tpu_torch import profiling
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import encoder
    from mrcaudiocodec_tpu_torch.ops.kernels import (
        analysis_pre, fft_stages, mdct_post, psycho, transients)
    fs, generator, ws, full, dtype = case
    cfg = CodecConfig(fs=fs, channels=2, bitrate=128000,
                      window_switching=ws, full_psycho=full)
    x = gen.GENERATORS[generator](fs, 1.5, 2, SEED, 0)
    if dtype == np.int16:
        x = gen.to_i16(x)
    nf = C.frames_for_samples(len(x))
    P = encoder._padded_rows(x, nf)
    s = 40
    audio = encoder.upload_chunk(P, 10, s, "cpu")
    bt = transients.block_types(audio, ws)
    btf = bt.reshape(-1)
    pre = analysis_pre.analysis_pre(audio, bt, cfg.window)
    spec = [fft_stages.fft(pre[i], pre[i + 1]) for i in range(0, 8, 2)]
    coeffs = mdct_post.mdct_post(*spec[0], *spec[1], btf)
    launches = [(("transients",), (audio, ws)),
                (("analysis_pre",), (audio, bt, cfg.window, "all"))]
    launches += [(("fft_stages",), (pre[i],)) for i in range(0, 8, 2)]
    launches += [(("mdct_post",), (*spec[0], *spec[1], btf)),
                 (("psycho",), (*spec[2], *spec[3], coeffs, btf, fs, full))]
    kernel_ops = sum(profiling.kernel_bound(k, a)[1] for k, a in launches)
    out = encoder._analyze_chunk(audio, cfg)
    assert torch.equal(out[0], bt)
    if ws:
        assert 0 < int((bt == C.SHORT).sum()) < bt.numel()
    rec = work.Analysis.capture((audio, cfg), {}, out)
    nbytes, ops = work.Analysis.count(rec)
    assert ops == kernel_ops
    assert nbytes == _nbytes(audio, *out)


@pytest.mark.parametrize("pcm16", [True, False])
def test_synthesis_count_equals_the_kernels(pcm16):
    from mrcaudiocodec_tpu_torch import profiling
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec, decoder
    from mrcaudiocodec_tpu_torch.ops.kernels import fft_stages, synth_pre
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    x = gen.to_i16(gen.music(44100, 1.5, 2, SEED, 1))
    stream = codec.encode(x, cfg, device="cpu")
    q, e_band, bt = (torch.from_numpy(a)
                     for a in decoder.record_slabs(stream)[0])
    prev = torch.zeros(bt.shape[0], 1024)
    pre = synth_pre.synth_pre(q, e_band, bt, cfg.fs)
    long_, short = fft_stages.fft(*pre[:2]), fft_stages.fft(*pre[2:])
    launches = [(("synth_pre",), (q, e_band, bt, cfg.fs)),
                (("fft_stages",), (pre[0],)), (("fft_stages",), (pre[2],)),
                (("synth_post",), (*long_, *short, bt, cfg.window, pcm16,
                                   prev))]
    kernel_ops = sum(profiling.kernel_bound(k, a)[1] for k, a in launches)
    args = (q, e_band, bt, cfg.fs, cfg.window, pcm16, prev)
    out = decoder._synth_chunk(*args)
    rec = work.Synthesis.capture(args, {}, out)
    nbytes, ops = work.Synthesis.count(rec)
    assert ops == kernel_ops
    assert nbytes == _nbytes(q, e_band, bt, prev, *out)


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert work.least_seconds(0, 33.5e12) == pytest.approx(1.0)
    assert work.least_seconds(3.35e12, 67e12) == pytest.approx(2.0)
