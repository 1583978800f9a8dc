"""Encoder pipeline: device stages, record bytes built on the device.

  host:   each clip's PCM as it is, copied once into a reused staging
          buffer (page-locked for a card, a host core a piece) and
          uploaded from it in one copy (`upload_pcm`)
  device: per chunk of frames, its padded rows, one per channel of every
          clip (K11, ops/kernels/pad_rows.py)
  device: per chunk of frames, all rows batched: int16 -> f32, framing
          with true neighbour transients across chunk edges, block types,
          MDCT, psycho (on the card the kernels K5-K8 around K1, which
          read the uploaded rows in place)
  device: the integer bit-reservoir budget scan over each whole row
  device: per chunk: RD loop (the quantization-cost kernel K2), the
          per-band codebook choice, then the record bytes (the record-pack
          kernel K3, ops/device_pack.py), laid back to back on the card
          in stream order: (frame, channel) within each clip, the corpus
          batch's pad frames left out
  host:   per chunk one download of that stream body and the records'
          lengths; each clip's stream is one join of its header and its
          slice of each chunk's body

Entry point: `encode(x, cfg, device="cuda")`. It runs on the card unless
the caller passes device="cpu"; without CUDA it raises, never falling
back to the CPU. `encode_arrays` + `models/packing.pack_stream` (the
decisions downloaded and packed on the host, the rows padded on the host
by `_padded_rows` and uploaded a chunk at a time by `upload_chunk`) are
kept as the oracle the tests compare against.

Each stage above is a span of `trace` (`mrc.pad`, `mrc.upload`,
`mrc.analyze`, ...), recorded only while tracing is on; `trace.counters()`
counts the bytes handed to the device and each blocking read.

A chunk holds at most ENC_ROW_FRAMES rows x frames, so that 128 rows run
about the memory of one stereo clip: a stereo clip runs chunks of 4096
frames, the 64-clip stereo batch (128 rows) chunks of 64. The chunk size
bounds device memory only: every float reduction is a pinned tree, so
the bytes do not depend on it.
"""
from __future__ import annotations

import concurrent.futures
import functools
import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from .. import config as C
from .. import trace
from ..bitstream import write_header
from ..config import CodecConfig
from ..ops import device_pack, dsp, entropy, psycho, rd, reservoir
from ..ops.kernels import pad_rows
from ..utils.bits import BitWriter

ENC_ROW_FRAMES = 8192               # rows x frames per device chunk
# bytes of PCM a host thread stages at least: below it the hand-off to a
# thread costs more than it saves (the 30 s stereo clip, 5.3 MB, stages in
# the calling thread; the 64-clip batch, 113 MB, on every core)
STAGE_PIECE_BYTES = 8 << 20


def device_for(device) -> torch.device:
    """The torch device to run on; raises if it is CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def _padded_rows(x: np.ndarray, nf: int) -> np.ndarray:
    """PCM [n, nch] -> padded signal rows [nch, plen]: [2*HOP zeros | x |
    zeros]; frame f spans P[:, (f+1)*HOP : (f+1)*HOP + LONG_SIZE], and
    frames -1 and nf (the outer neighbours) are all zeros."""
    n, nch = x.shape
    plen = 2 * C.HOP + nf * C.HOP + 2 * C.HOP + C.LONG_SIZE
    dtype = np.int16 if x.dtype == np.int16 else np.float32
    with trace.span("mrc.pad"):
        P = np.zeros((nch, plen), dtype)
        P[:, 2 * C.HOP:2 * C.HOP + n] = x.T
    return P


def _analyze_chunk(audio_ext, cfg: CodecConfig):
    """[R, (s+3)*HOP] audio covering frames [f0-1, f0+s+1) -> (bt [R, s],
    coeffs [R*s, 1024], allowed [R*s, NB], pe [R, s]).

    The two outer frames are the chunk's true neighbours (zeros outside
    the clip), so edge transients — and block types — equal the spec's.
    int16 input becomes f32 as x * 2^-15 (exact). On the card the chunk
    runs as kernels (`analyze_split`); on the CPU as the eager chain."""
    with trace.span("mrc.analyze"):
        if audio_ext.is_cuda:
            return analyze_split(audio_ext, cfg)
        a = audio_ext
        if a.dtype == torch.int16:
            a = a.to(torch.float32) * (1.0 / 32768.0)
        r = a.shape[0]
        s = a.shape[1] // C.HOP - 3
        hops = a.reshape(r, s + 3, C.HOP)
        frames_ext = torch.cat([hops[:, :-1], hops[:, 1:]],
                               dim=-1)                      # [R,s+2,2048]
        tr_ext = dsp.detect_transients(
            frames_ext.reshape(-1, C.LONG_SIZE)).reshape(r, s + 2)
        bt = dsp.block_types(tr_ext, cfg.window_switching)         # [R, s]
        frames = frames_ext[:, 1:-1].reshape(-1, C.LONG_SIZE)
        btf = bt.reshape(-1)
        coeffs = dsp.analyze(frames, btf, cfg.window)
        allowed, pe, _ = psycho.analyze(frames, coeffs, btf, cfg.fs,
                                        cfg.full_psycho)
        return bt, coeffs, allowed, pe.reshape(r, s)


def analyze_split(audio_ext, cfg: CodecConfig):
    """`_analyze_chunk` as its kernels, which read the hop rows in place:
    K5 the block types, K6 the four FFT inputs (long and short MDCT, long
    and short psycho spectrum), K1 their FFTs, K7 the MDCT coefficients,
    K8 the allowed noise and PE; 8 launches on the card. CPU tensors take
    each kernel's plain version, with the same values."""
    from ..ops.kernels import (analysis_pre, fft_stages, mdct_post,
                               psycho as kpsy, transients)
    r = audio_ext.shape[0]
    s = audio_ext.shape[1] // C.HOP - 3
    bt = transients.block_types(audio_ext, cfg.window_switching)   # [R, s]
    btf = bt.reshape(-1)
    pre = analysis_pre.analysis_pre(audio_ext, bt, cfg.window)
    spec = [fft_stages.fft(pre[i], pre[i + 1]) for i in range(0, 8, 2)]
    del pre
    coeffs = mdct_post.mdct_post(*spec[0], *spec[1], btf)
    allowed, pe, _ = kpsy.psycho(*spec[2], *spec[3], coeffs, btf, cfg.fs,
                                 cfg.full_psycho)
    return bt, coeffs, allowed, pe.reshape(r, s)


def chunk_spans(nf: int, rows: int = 1):
    """[(first frame, frame count)] of the device chunks of `rows` rows."""
    step = max(1, ENC_ROW_FRAMES // rows)
    return [(f0, min(step, nf - f0)) for f0 in range(0, nf, step)]


def upload_chunk(P: np.ndarray, f0: int, s: int, dev):
    """The padded rows covering frames [f0-1, f0+s+1), on `dev`."""
    return trace.upload(P[:, f0 * C.HOP:(f0 + s + 3) * C.HOP], dev)


class PCM(NamedTuple):
    """Clips' samples on a device, as `upload_pcm` leaves them."""
    data: torch.Tensor      # [sum n_j, nch] int16 or float32, back to back
    clips: torch.Tensor     # int64 [J, 2]: clip j's first sample, length


class _Staging:
    """A device's staging buffer: host memory (page-locked for a card)
    kept from request to request, the lock of the thread that fills it,
    and an event recorded after the last copy up out of it (None until a
    card's first)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.buf = None
        self.done = None


_staging: dict[tuple, _Staging] = {}
_staging_lock = threading.Lock()


def _staging_for(dev: torch.device) -> _Staging:
    """The staging buffer of `dev` ("cuda" is the current card)."""
    index = dev.index
    if dev.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    with _staging_lock:
        return _staging.setdefault((dev.type, index), _Staging())


def _copy_rows(dst: np.ndarray, arrs, at, lo: int, hi: int) -> None:
    """Rows [lo, hi) of the clips laid back to back (clip j's first row at
    at[j]) -> the same rows of dst."""
    for j, a in enumerate(arrs):
        a0, a1 = max(lo, at[j]), min(hi, at[j + 1])
        if a0 < a1:
            np.copyto(dst[a0:a1], a[a0 - at[j]:a1 - at[j]])


def stage_pcm(arrs: list[np.ndarray], out: torch.Tensor) -> torch.Tensor:
    """Clips [n_j, nch] -> copied back to back, as they are, into `out`
    [sum n_j, nch], a view of the staging buffer; returns `out`. Rows are
    cut into pieces of STAGE_PIECE_BYTES at least, at most one a host
    core, copied side by side (numpy lets go of the interpreter lock while
    it copies); a single piece is copied by the calling thread."""
    with trace.span("mrc.pad"):
        dst = out.numpy()
        at = np.concatenate([[0], np.cumsum([a.shape[0] for a in arrs])])
        total = int(at[-1])
        pool, threads = _copy_pool()
        row_bytes = max(dst.itemsize * dst.shape[1], 1)
        step = max(-(-total // threads), STAGE_PIECE_BYTES // row_bytes)
        if step >= total:
            _copy_rows(dst, arrs, at, 0, total)
        else:
            list(pool.map(
                lambda lo: _copy_rows(dst, arrs, at, lo, lo + step),
                range(0, total, step)))
        return out


@functools.lru_cache(maxsize=1)
def _copy_pool():
    """(the host threads that stage PCM, one a core this process may run
    on; their count)."""
    threads = len(os.sched_getaffinity(0))
    return concurrent.futures.ThreadPoolExecutor(threads), threads


# a forked child has none of its parent's threads: it makes its own pool
os.register_at_fork(after_in_child=_copy_pool.cache_clear)


def upload_pcm(arrs: list[np.ndarray], dev, stage=None) -> PCM:
    """Clips [n_j, nch] of one dtype, int16 or float32 -> their samples
    on `dev`, each copied once on the host and once up: staged by `stage`
    (default `stage_pcm`) into the device's staging buffer, then copied up
    from it without waiting. The buffer is allocated once a device
    (`staging.grow`) and grows only for a request larger than any before
    it; a thread waits for the last copy up out of it before it fills it
    again."""
    stage = stage or stage_pcm
    dev = torch.device(dev)
    nch = arrs[0].shape[1]
    dtype = torch.int16 if arrs[0].dtype == np.int16 else torch.float32
    lens = [a.shape[0] for a in arrs]
    need = sum(lens) * nch * dtype.itemsize
    st = _staging_for(dev)
    with st.lock:
        if st.done is not None:
            st.done.synchronize()
        if st.buf is None or st.buf.numel() < need:
            st.buf = None                   # the old one goes first
            st.buf = torch.empty(max(need, 1), dtype=torch.uint8,
                                 pin_memory=dev.type == "cuda")
            trace.count("staging.grow")
        view = st.buf[:need].view(dtype).view(-1, nch)
        data = trace.upload(stage(arrs, view), dev)
        if dev.type == "cuda":
            st.done = st.done or torch.cuda.Event()
            st.done.record(torch.cuda.current_stream(dev))
    at = np.concatenate([[0], np.cumsum(lens)[:-1]])
    clips = trace.upload(np.stack([at, lens], 1).astype(np.int64), dev)
    return PCM(data, clips)


def decide_chunk(chunk, budgets, cfg: CodecConfig):
    """One analysed chunk + its budgets [R, s] -> the compact decisions
    [q int16, amp int8, gain int16, bt int8, cb int8], each [R, s, ...],
    on the device: the RD loop, then the per-band codebook choice."""
    bt, coeffs, allowed, _ = chunk
    nch, s = bt.shape
    btf = bt.reshape(-1)
    with trace.span("mrc.decide"):
        q, amp, gain, _ = rd.rd_batch(coeffs, allowed, budgets.reshape(-1),
                                      btf, cfg.fs)
        cb, _ = entropy.payload_costs_and_choice(q, btf, cfg.fs)
        return [t.reshape((nch, s) + tuple(t.shape[1:])).to(dtype)
                for t, dtype in ((q, torch.int16), (amp, torch.int8),
                                 (gain, torch.int16), (btf, torch.int8),
                                 (cb, torch.int8))]


def _analyze_rows(P: np.ndarray, nf_row, cfg: CodecConfig, dev):
    """Padded rows (`_padded_rows` layout: nf + 6 hops) -> (spans,
    analysed chunks, budgets [R, nf]) on `dev`."""
    spans = chunk_spans(P.shape[1] // C.HOP - 6, P.shape[0])
    chunks = [_analyze_chunk(upload_chunk(P, f0, s, dev), cfg)
              for f0, s in spans]
    return spans, chunks, _budgets(chunks, cfg, nf_row)


def _budgets(chunks, cfg: CodecConfig, nf_row):
    """Analysed chunks -> each row's frame budgets [R, nf] (their PE
    joined, then `reservoir.allocate`)."""
    with trace.span("mrc.budget"):
        pe = torch.cat([ch[3] for ch in chunks], dim=1)           # [R, nf]
        return reservoir.allocate(pe, cfg, nf_row)


def download(decisions):
    """Per-chunk decisions -> {q, amp, gain, bt, cb} int32 host arrays
    [nch, nf, ...]."""
    host = [[t.cpu().numpy() for t in d] for d in decisions]
    return {key: np.concatenate([h[i] for h in host], axis=1).astype(np.int32)
            for i, key in enumerate(("q", "amp", "gain", "bt", "cb"))}


def encode_arrays(x: np.ndarray, cfg: CodecConfig, device="cuda"):
    """PCM [n, ch] (float32 or int16) -> ({q, amp, gain, bt, cb} int32
    arrays [nch, nf, ...], nf): the decisions, for the host packer."""
    dev = device_for(device)
    nf = C.frames_for_samples(x.shape[0])
    spans, chunks, budgets = _analyze_rows(_padded_rows(x, nf), None, cfg,
                                           dev)
    decisions = [decide_chunk(ch, budgets[:, f0:f0 + s], cfg)
                 for ch, (f0, s) in zip(chunks, spans)]
    return download(decisions), nf


def stream_order(nf_row, nch: int, f0: int, s: int, rows: int):
    """One chunk's records in stream order -> (order int32 [N], records of
    each clip in the chunk [clips]). Clip j holds rows j*nch .. j*nch +
    nch - 1 and its first nf_row[j*nch] frames (nf_row None: every frame);
    its records run frame by frame over [f0, min(f0 + s, nf)), channels
    within a frame, record (j*nch + c)*s + (f - f0) of the chunk's [R*s]
    decisions. Pad frames are left out."""
    clips = rows // nch
    nf = (np.full(clips, f0 + s) if nf_row is None
          else np.asarray(nf_row)[::nch])
    frame = np.arange(s)
    idx = ((np.arange(clips)[:, None, None] * nch
            + np.arange(nch)[None, None, :]) * s
           + frame[None, :, None])                       # [clip, frame, c]
    real = f0 + frame[None, :] < nf[:, None]              # [clip, frame]
    order = idx[np.broadcast_to(real[:, :, None], idx.shape)]
    return order.astype(np.int32), real.sum(1) * nch


def pack_chunk(decisions, order, cfg: CodecConfig, cap: int):
    """One chunk's decisions [R, s, ...] and its stream order [N] (on the
    device) -> (body, nbytes, status) of device_pack.pack_stream (K3 on the
    card)."""
    q, amp, gain, bt, cb = decisions
    r, s = bt.shape
    with trace.span("mrc.pack"):
        return device_pack.pack_stream(
            q.reshape(r * s, -1), amp.reshape(r * s, -1), gain.reshape(-1),
            bt.reshape(-1), cb.reshape(r * s, -1), order, cfg.fs, cap)


def download_body(packed):
    """A packed chunk -> host arrays: its stream body uint8 [total] and the
    records' nbytes int64 [N], in stream order."""
    body, nbytes, status = packed
    with trace.span("mrc.download"):
        trace.count("host_syncs.download", 2)
        return (body[:int(status[0])].cpu().numpy(),
                nbytes.cpu().numpy().astype(np.int64))


def clip_slices(body, nbytes, counts) -> list[memoryview]:
    """A chunk's host body -> each clip's slice of it (a view, no copy),
    from the records' lengths and the records of each clip
    (stream_order)."""
    with trace.span("mrc.assemble"):
        ends = np.concatenate([[0], np.cumsum(nbytes)])
        at = ends[np.concatenate([[0], np.cumsum(counts)])]
        view = memoryview(body)
        return [view[a:b] for a, b in zip(at[:-1], at[1:])]


def encode_chunks(audio, orders, spans, nf_row, cfg: CodecConfig, cap: int):
    """The device stages of an encode. audio: each chunk of `spans` on the
    device (K11's `pad_rows.pad_rows`, or `upload_chunk`), orders: each
    chunk's stream order on the device (`stream_order`), both iterables
    read in chunk order -> each chunk's packed (body, nbytes, status),
    yielded in turn: every chunk analysed, the budgets of each whole row
    (`reservoir.allocate`), then per chunk the RD loop and codebooks
    (`decide_chunk`, K2) and the record pack (`pack_chunk`, K3, which
    reads its 8-byte status)."""
    chunks = [_analyze_chunk(a, cfg) for a in audio]
    budgets = _budgets(chunks, cfg, nf_row)
    for ch, (f0, s), order in zip(chunks, spans, orders):
        yield pack_chunk(decide_chunk(ch, budgets[:, f0:f0 + s], cfg), order,
                         cfg, cap)


def encode_rows(pcm: PCM, nf: int, nf_row, cfg: CodecConfig,
                headers: list[bytes]) -> list[bytes]:
    """The clips' samples on a device (`upload_pcm`; int16 or float32),
    the frames of every row (nf, at least each clip's), each row's true
    frame count (None: all nf) and each clip's header -> each clip's
    stream, its body built on the samples' device. Clip j holds rows
    j*nch .. j*nch + nch - 1, nch = cfg.channels. Each chunk's padded rows
    are built on the device (K11) just before its analysis, and its body
    downloaded before the next chunk is packed; a clip's stream is one
    join of its header and its slices of the chunks' bodies."""
    nch = cfg.channels
    dev = pcm.data.device
    rows = pcm.clips.shape[0] * nch
    spans = chunk_spans(nf, rows)
    with trace.span("mrc.order"):
        orders = [stream_order(nf_row, nch, f0, s, rows) for f0, s in spans]
    nf_dev = None if nf_row is None else trace.upload(
        np.asarray(nf_row, np.int64), dev)
    packed = encode_chunks(
        (pad_rows.pad_rows(pcm.data, pcm.clips, f0, s) for f0, s in spans),
        (trace.upload(o, dev) for o, _ in orders),
        spans, nf_dev, cfg, device_pack.pack_cap_bytes(cfg))
    pieces = [[] for _ in range(rows // nch)]
    for p, (_, counts) in zip(packed, orders):
        for j, piece in enumerate(clip_slices(*download_body(p), counts)):
            pieces[j].append(piece)
    with trace.span("mrc.assemble"):
        return [b"".join([h, *p]) for h, p in zip(headers, pieces)]


def header(cfg: CodecConfig, nf: int, n_samples: int) -> bytes:
    """The MRC1 stream header of a clip of nf frames, n_samples samples."""
    w = BitWriter()
    write_header(w, cfg, nf, n_samples)
    return w.getvalue()


def encode(x: np.ndarray, cfg: CodecConfig, device="cuda") -> bytes:
    """PCM [n] or [n, channels], float32 in [-1, 1] or raw int16 -> MRC1
    bytes, byte-identical to the spec codec's."""
    trace.count("requests.encode")
    with trace.span("mrc.encode"):
        x = np.asarray(x)
        if x.dtype != np.int16:
            x = x.astype(np.float32)
        if x.ndim == 1:
            x = x[:, None]
        if x.shape[1] != cfg.channels:
            raise ValueError(
                f"config expects {cfg.channels} channels, got {x.shape[1]}")
        dev = device_for(device)
        nf = C.frames_for_samples(x.shape[0])
        with trace.span("mrc.assemble"):
            head = header(cfg, nf, x.shape[0])
        stream, = encode_rows(upload_pcm([x], dev), nf, None, cfg, [head])
        return stream

