"""Encoder pipeline: device stages, record bytes built on the device.

  host:   pad the PCM into one row per channel (numpy); the corpus path
          gives one row per channel of every clip
  device: per chunk of frames, all rows batched: int16 -> f32, framing
          with true neighbour transients across chunk edges, block types,
          MDCT, psycho
  device: the integer bit-reservoir budget scan over each whole row
  device: per chunk: RD loop (the quantization-cost kernel K2), the
          per-band codebook choice, then the record bytes (the record-pack
          kernel K3, ops/device_pack.py)
  host:   one download of the records [R, nf, cap] and their lengths, the
          (frame, channel) interleave and the concatenation of each
          record's bytes behind the header

Entry point: `encode(x, cfg, device="cuda")`. It runs on the card unless
the caller passes device="cpu"; without CUDA it raises, never falling
back to the CPU. `encode_arrays` + `models/packing.pack_stream` (the
decisions downloaded and packed on the host) are kept as the oracle the
tests compare against.

A chunk holds at most ENC_ROW_FRAMES rows x frames, so that 128 rows run
about the memory of one stereo clip: a stereo clip runs chunks of 4096
frames, the 64-clip stereo batch (128 rows) chunks of 64. The chunk size
bounds device memory only: every float reduction is a pinned tree, so
the bytes do not depend on it.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config as C
from .. import native
from ..bitstream import write_header
from ..config import CodecConfig
from ..ops import device_pack, dsp, entropy, psycho, rd, reservoir
from ..utils.bits import BitWriter

ENC_ROW_FRAMES = 8192               # rows x frames per device chunk


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
    P = np.zeros((nch, plen), dtype)
    P[:, 2 * C.HOP:2 * C.HOP + n] = x.T
    return P


def _analyze_chunk(audio_ext, cfg: CodecConfig):
    """[R, (s+3)*HOP] audio covering frames [f0-1, f0+s+1) -> (bt [R, s],
    coeffs [R*s, 1024], allowed [R*s, NB], pe [R, s]).

    The two outer frames are the chunk's true neighbours (zeros outside
    the clip), so edge transients — and block types — equal the spec's.
    int16 input becomes f32 as x * 2^-15 (exact)."""
    a = audio_ext
    if a.dtype == torch.int16:
        a = a.to(torch.float32) * (1.0 / 32768.0)
    r = a.shape[0]
    s = a.shape[1] // C.HOP - 3
    hops = a.reshape(r, s + 3, C.HOP)
    frames_ext = torch.cat([hops[:, :-1], hops[:, 1:]], dim=-1)  # [R,s+2,2048]
    tr_ext = dsp.detect_transients(
        frames_ext.reshape(-1, C.LONG_SIZE)).reshape(r, s + 2)
    bt = dsp.block_types(tr_ext, cfg.window_switching)             # [R, s]
    frames = frames_ext[:, 1:-1].reshape(-1, C.LONG_SIZE)
    btf = bt.reshape(-1)
    coeffs = dsp.analyze(frames, btf, cfg.window)
    allowed, pe, _ = psycho.analyze(frames, coeffs, btf, cfg.fs,
                                    cfg.full_psycho)
    return bt, coeffs, allowed, pe.reshape(r, s)


def chunk_spans(nf: int, rows: int = 1):
    """[(first frame, frame count)] of the device chunks of `rows` rows."""
    step = max(1, ENC_ROW_FRAMES // rows)
    return [(f0, min(step, nf - f0)) for f0 in range(0, nf, step)]


def upload_chunk(P: np.ndarray, f0: int, s: int, dev):
    """The padded rows covering frames [f0-1, f0+s+1), on `dev`."""
    return torch.from_numpy(np.ascontiguousarray(
        P[:, f0 * C.HOP:(f0 + s + 3) * C.HOP])).to(dev)


def decide_chunk(chunk, budgets, cfg: CodecConfig):
    """One analysed chunk + its budgets [R, s] -> the compact decisions
    [q int16, amp int8, gain int16, bt int8, cb int8], each [R, s, ...],
    on the device: the RD loop, then the per-band codebook choice."""
    bt, coeffs, allowed, _ = chunk
    nch, s = bt.shape
    btf = bt.reshape(-1)
    q, amp, gain, _ = rd.rd_batch(coeffs, allowed, budgets.reshape(-1), btf,
                                  cfg.fs)
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
    pe = torch.cat([ch[3] for ch in chunks], dim=1)               # [R, nf]
    return spans, chunks, reservoir.allocate(pe, cfg, nf_row)


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


def pack_chunk(decisions, cfg: CodecConfig, cap: int):
    """One chunk's decisions [R, s, ...] -> (rec [R, s, cap] uint8, nbytes
    [R, s] int32) on the device (K3 on the card)."""
    q, amp, gain, bt, cb = decisions
    r, s = bt.shape
    rec, nbytes = device_pack.pack_records(
        q.reshape(r * s, -1), amp.reshape(r * s, -1), gain.reshape(-1),
        bt.reshape(-1), cb.reshape(r * s, -1), cfg.fs, cap)
    return rec.reshape(r, s, cap), nbytes.reshape(r, s)


def download_records(packed):
    """Per-chunk (rec, nbytes) -> host arrays rec [R, nf, cap] uint8 and
    nbytes [R, nf] int64, one copy of each."""
    rec = torch.cat([p[0] for p in packed], dim=1).cpu().numpy()
    nbytes = torch.cat([p[1] for p in packed], dim=1).cpu().numpy()
    return rec, nbytes.astype(np.int64)


def encode_rows(P: np.ndarray, nf_row, cfg: CodecConfig, dev):
    """Padded rows [R, plen] (`_padded_rows` layout; int16 or float32) and
    each row's true frame count (None: all of them) -> host arrays rec
    [R, nf, cap] uint8 and nbytes [R, nf] int64: the records of every row,
    built on `dev`."""
    cap = device_pack.pack_cap_bytes(cfg)
    spans, chunks, budgets = _analyze_rows(P, nf_row, cfg, dev)
    packed = [pack_chunk(decide_chunk(ch, budgets[:, f0:f0 + s], cfg), cfg,
                         cap)
              for ch, (f0, s) in zip(chunks, spans)]
    return download_records(packed)


def assemble_stream(rec, nbytes, rows, nf: int, n_samples: int,
                    cfg: CodecConfig) -> bytes:
    """The MRC1 stream of one clip from host records: its rows (one per
    channel), frames [0, nf), in record order (frame, channel), each
    record's nbytes run concatenated behind the header."""
    _, f_all, cap = rec.shape
    at = (np.asarray(rows)[None, :] * f_all
          + np.arange(nf)[:, None]).reshape(-1)       # record -> [R, F] index
    runs = nbytes.reshape(-1)[at]
    idx = np.repeat(at * cap, runs) + native._ranges(runs)
    w = BitWriter()
    write_header(w, cfg, nf, n_samples)
    return w.getvalue() + rec.reshape(-1)[idx].tobytes()


def encode(x: np.ndarray, cfg: CodecConfig, device="cuda") -> bytes:
    """PCM [n] or [n, channels], float32 in [-1, 1] or raw int16 -> MRC1
    bytes, byte-identical to the spec codec's."""
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
    rec, nbytes = encode_rows(_padded_rows(x, nf), None, cfg, dev)
    return assemble_stream(rec, nbytes, range(cfg.channels), nf, x.shape[0],
                           cfg)

