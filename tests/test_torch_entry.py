"""The encode's entry on the CPU: each clip's PCM staged once into a reused
buffer and uploaded as it is (`encoder.upload_pcm`), and K11's plain
version (`ops/kernels/pad_rows.py`), which builds a chunk's padded rows
from it, against the host pad it replaced (`encoder._padded_rows` and
`encoder.upload_chunk`, kept as the oracle's), bit for bit.

The `cuda` case holds the K11 kernel to its plain version on the card.
"""
import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import corpus, trace
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import encoder
from mrcaudiocodec_tpu_torch.ops.kernels import pad_rows

FS = 44100
BUCKET = 16                     # frames a batch's rows are padded to


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")


def pcm(n, nch, dtype, seed):
    """[n, nch] samples of every kind the rows carry: full scale, and for
    float32 -0.0 and values beyond [-1, 1]."""
    rng = np.random.default_rng(seed)
    if dtype == np.int16:
        return rng.integers(-32768, 32768, (n, nch)).astype(np.int16)
    x = rng.standard_normal((n, nch)).astype(np.float32)
    x[::7] = -0.0
    return x


# (clip lengths in samples): one clip; a batch of mixed lengths in one
# FRAME_BUCKET, their offsets in the staged PCM not all 16-byte aligned;
# a clip shorter than one hop, alone and in a batch
CLIPS = {"one": [11025],
         "batch": [11025, 9001, 13313, 4097],
         "short": [300],
         "short_in_batch": [5000, 300, 7000]}


def rows_of(lens, nch, dtype):
    """The clips, the host pad's rows of all of them (`_padded_rows` at
    the batch's shared frame count, stacked as the batch stacks them) and
    that frame count."""
    arrs = [pcm(n, nch, dtype, i) for i, n in enumerate(lens)]
    nf = -(-max(C.frames_for_samples(n) for n in lens) // BUCKET) * BUCKET
    P = np.concatenate([encoder._padded_rows(a, nf) for a in arrs])
    return arrs, P, nf


def chunks(nf):
    """A first, a middle and a last chunk of nf frames, and one frame."""
    s = nf // 3
    return [(0, s), (s, s), (nf - s, s), (nf - 1, 1)]


def bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("clips", list(CLIPS))
@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_pad_rows_plain_equals_the_host_pad(clips, nch, dtype):
    arrs, P, nf = rows_of(CLIPS[clips], nch, dtype)
    staged = encoder.upload_pcm(arrs, "cpu")
    for f0, s in chunks(nf):
        want = encoder.upload_chunk(P, f0, s, "cpu")
        got = pad_rows.pad_rows(staged.data, staged.clips, f0, s)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(bits(got), bits(want.contiguous())), (f0, s)


@pytest.mark.parametrize("piece", [encoder.STAGE_PIECE_BYTES, 64])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_upload_pcm_gives_each_clip_once_back_to_back(dtype, piece,
                                                      monkeypatch):
    # piece 64: the rows cut into pieces that cross the clips' edges,
    # copied by the host threads side by side
    monkeypatch.setattr(encoder, "STAGE_PIECE_BYTES", piece)
    arrs = [pcm(n, 2, dtype, i) for i, n in enumerate([700, 5, 1300])]
    before = trace.counters()
    got = encoder.upload_pcm(arrs, "cpu")
    spent = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert torch.equal(bits(got.data), bits(torch.from_numpy(
        np.concatenate(arrs))))
    assert got.clips.tolist() == [[0, 700], [700, 5], [705, 1300]]
    nbytes = sum(a.nbytes for a in arrs)
    assert spent["staging.bytes_up"] == nbytes
    assert spent["bytes_up"] == nbytes + 16 * len(arrs)


def test_the_staging_buffer_grows_once_for_requests_alike(monkeypatch):
    monkeypatch.setattr(encoder, "_staging", {})
    cfg = CodecConfig(fs=FS, channels=2, bitrate=128000)
    x = pcm(6000, 2, np.int16, 3)
    before = trace.counters()
    first = encoder.encode(x, cfg, device="cpu")
    second = encoder.encode(x, cfg, device="cpu")
    spent = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert first == second
    assert spent["staging.grow"] == 1
    assert spent["staging.bytes_up"] == 2 * x.nbytes
    # a larger request grows it again, a smaller one does not
    encoder.encode(pcm(9000, 2, np.int16, 4), cfg, device="cpu")
    encoder.encode(pcm(500, 2, np.int16, 5), cfg, device="cpu")
    assert trace.counters()["staging.grow"] - before.get(
        "staging.grow", 0) == 2


@pytest.mark.parametrize("nch,dtype", [(2, np.int16), (1, np.float32),
                                       (2, np.float32), (1, np.int16)])
def test_encode_batch_equals_each_clip_alone(nch, dtype, monkeypatch):
    monkeypatch.setattr(corpus, "FRAME_BUCKET", BUCKET)
    cfg = CodecConfig(fs=FS, channels=nch, bitrate=64000 * nch)
    rng = np.random.default_rng(nch)
    clips = []
    for i, sec in enumerate([0.2, 0.13, 0.27]):
        t = np.arange(int(FS * sec)) / FS
        x = (0.4 * np.sin(2 * np.pi * (300 + 200 * i) * t)
             + 0.02 * rng.standard_normal(t.size))
        x = np.stack([x, np.roll(x, 5)][:nch], 1)
        clips.append((x * 32767).astype(np.int16) if dtype == np.int16
                     else x.astype(np.float32))
    got = corpus.encode_batch(clips, cfg, devices=["cpu"])
    for i, x in enumerate(clips):
        assert got[i] == encoder.encode(x, cfg, device="cpu"), i


@pytest.mark.cuda
@pytest.mark.parametrize("clips", list(CLIPS))
@pytest.mark.parametrize("nch", [1, 2])
@pytest.mark.parametrize("dtype", [np.int16, np.float32])
def test_pad_rows_kernel_equals_plain_on_card(clips, nch, dtype):
    _need_card()
    arrs, P, nf = rows_of(CLIPS[clips], nch, dtype)
    host = encoder.upload_pcm(arrs, "cpu")
    card = encoder.upload_pcm(arrs, "cuda")
    for f0, s in chunks(nf):
        before = pad_rows.launches
        got = pad_rows.pad_rows(card.data, card.clips, f0, s)
        assert pad_rows.launches == before + 1
        want = pad_rows.pad_rows_plain(host.data, host.clips, f0, s)
        torch.cuda.synchronize()
        assert torch.equal(bits(got.cpu()), bits(want)), (f0, s)
        assert torch.equal(bits(want), bits(
            encoder.upload_chunk(P, f0, s, "cpu").contiguous()))
