"""The reference codec over many clips: the spec's stages on frame blocks,
spread over a pool of processes.

    encode_clips(clips, cfg, workers)      int16 [n, ch] clips -> streams
    decode_streams(streams, workers)       streams -> int16 [n, ch] PCM

Every stage of the spec encoder works on frames as rows, and each row's
values do not depend on the rows beside it (the spec's batched forms are
decision-identical to its per-frame ones), so frame blocks are run
apart and joined: the transients of each block, then the block types of
the whole channel, the analysis of each block, the reservoir's budgets of
the whole channel, then the RD search, the symbols and the record bytes
of each block. Every record starts on a byte boundary, so the records
joined behind the header are the spec's stream. The decoder locates
every record by its length prefix and decodes blocks of records apart;
the overlap-add runs over each whole channel.

`lower=True` is the control: the same codec with the analysis' MDCT
coefficients (encode) or the dequantized coefficients and the synthesis
frames (decode) rounded to bfloat16, the precision one step below the
float32 the format states.

Numpy and the standard library only.
"""
from __future__ import annotations

import concurrent.futures
import multiprocessing
import os

import numpy as np

from . import bitstream
from . import config as C
from .config import CodecConfig
from .spec import dsp, entropy, psycho, quantize, rd, reservoir
from .utils.bits import BitWriter

F32 = np.float32
BLOCKS_PER_WORKER = 4           # tasks a worker a phase, for balance
MIN_BLOCK = 16                  # frames


def bf16(a) -> np.ndarray:
    """float32 values rounded to bfloat16 (nearest, ties to even), kept as
    float32."""
    u = np.ascontiguousarray(a, F32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(F32)


def to_i16(y: np.ndarray) -> np.ndarray:
    """float32 PCM -> int16 as the codec's int16 output rounds it:
    clamp(round(y * 32767)), ties to even."""
    return np.clip(np.round(np.asarray(y, F32) * F32(32767.0)),
                   -32768, 32767).astype(np.int16)


def _blocks(n: int, size: int):
    return [(a, min(a + size, n)) for a in range(0, n, size)]


def _block_size(total: int, workers: int) -> int:
    return max(MIN_BLOCK, -(-total // (BLOCKS_PER_WORKER * workers)))


def _transients(frames):
    return dsp.detect_transients(frames)


def _analyse(frames, bt, cfg: CodecConfig, lower: bool):
    coeffs = dsp.analyze_frames(frames, bt, cfg.window)
    if lower:
        coeffs = bf16(coeffs)
    allowed, pe, _ = psycho.analyze_frames(frames, coeffs, bt, cfg.fs,
                                           cfg.full_psycho)
    return coeffs, allowed, pe


def _records(coeffs, allowed, budgets, bt, cfg: CodecConfig):
    """A block's RD decisions -> each frame's record bytes (length prefix,
    content, zero pad to a byte)."""
    q, amp, gain, _ = rd.rd_frames(coeffs, allowed, budgets, bt, cfg.fs)
    out = []
    for f in range(len(bt)):
        codes, lens = entropy.encode_frame_symbols(
            q[f], amp[f], int(gain[f]), int(bt[f]), cfg.fs)
        w = BitWriter()
        w.write(int(sum(lens)), C.FRAME_LEN_BITS)
        for c, ln in zip(codes, lens):
            w.write(c, ln)
        w.align()
        out.append(w.getvalue())
    return out


def _synth(data: bytes, offsets, fs: int, window: str, lower: bool):
    """Records at these byte offsets -> their synthesis frames [k, 2048]."""
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    out = np.zeros((len(offsets), C.LONG_SIZE), F32)
    for i, off in enumerate(offsets):
        cur = entropy._Bits(bits, int(off) * 8)
        content = cur.take(C.FRAME_LEN_BITS)
        start = cur.pos
        q, e_bin, block_type, _ = entropy.decode_frame_content(cur, fs)
        if cur.pos - start != content:
            raise ValueError(f"record at byte {off}: content length "
                             f"mismatch ({cur.pos - start} != {content})")
        xhat = quantize.dequantize(q, e_bin)
        if lower:
            xhat = bf16(xhat)
        frame = dsp.synthesize_frame(xhat, block_type, window)
        out[i] = bf16(frame) if lower else frame
    return out


def _pool(workers: int | None):
    """(a pool of `workers` spawned processes, default one a core, and
    their count). A worker that dies breaks the pool, which raises."""
    n = workers or os.cpu_count() or 1
    return concurrent.futures.ProcessPoolExecutor(
        n, mp_context=multiprocessing.get_context("spawn")), n


def _starmap(pool, fn, args):
    return list(pool.map(fn, *zip(*args))) if args else []


def encode_clips(clips, cfg: CodecConfig, workers: int | None = None,
                 lower: bool = False) -> list[bytes]:
    """int16 clips [n, cfg.channels] -> their MRC1 streams, equal to
    spec.codec.encode(clip / 32768, cfg) byte for byte (lower: the
    control's)."""
    xs = [np.asarray(c).astype(F32) / F32(32768.0) for c in clips]
    chans = [(k, ch) for k in range(len(xs)) for ch in range(cfg.channels)]
    frames = {kc: dsp.frame_signal(xs[kc[0]][:, kc[1]]) for kc in chans}
    pool, n = _pool(workers)
    with pool:
        size = _block_size(sum(len(f) for f in frames.values()), n)
        tasks = [(kc, a, b) for kc in chans
                 for a, b in _blocks(len(frames[kc]), size)]
        tr = _starmap(pool, _transients,
                      [(frames[kc][a:b],) for kc, a, b in tasks])
        bt = {}
        for kc in chans:
            bt[kc] = dsp.block_types(np.concatenate(
                [t for (kc2, _, _), t in zip(tasks, tr) if kc2 == kc]),
                cfg.window_switching)
        got = _starmap(pool, _analyse, [(frames[kc][a:b], bt[kc][a:b], cfg,
                                         lower) for kc, a, b in tasks])
        budgets = {kc: reservoir.allocate(np.concatenate(
            [g[2] for (kc2, _, _), g in zip(tasks, got) if kc2 == kc]), cfg)
            for kc in chans}
        recs = _starmap(pool, _records, [
            (g[0], g[1], budgets[kc][a:b], bt[kc][a:b], cfg)
            for (kc, a, b), g in zip(tasks, got)])
    per = {kc: [] for kc in chans}
    for (kc, _, _), r in zip(tasks, recs):
        per[kc].extend(r)
    out = []
    for k, x in enumerate(xs):
        nf = cfg.frames_for_samples(len(x))
        w = BitWriter()
        bitstream.write_header(w, cfg, nf, len(x))
        out.append(w.getvalue() + b"".join(
            per[(k, ch)][f] for f in range(nf)
            for ch in range(cfg.channels)))
    return out


def decode_streams(streams, workers: int | None = None,
                   lower: bool = False) -> list[np.ndarray]:
    """MRC1 streams -> their PCM [n, channels] int16, equal to
    spec.codec.decode's float32 PCM rounded as the codec's int16 output
    rounds it (lower: the control's)."""
    heads = []
    for data in streams:
        cfg, nf, n, hdr_bits = bitstream.read_header(data)
        offs, _ = bitstream.frame_byte_offsets(data, hdr_bits // 8,
                                               nf * cfg.channels)
        heads.append((cfg, nf, n, offs))
    pool, workers = _pool(workers)
    with pool:
        size = _block_size(sum(len(h[3]) for h in heads), workers)
        tasks = [(k, a, b) for k, h in enumerate(heads)
                 for a, b in _blocks(len(h[3]), size)]
        got = _starmap(pool, _synth, [
            (streams[k], heads[k][3][a:b], heads[k][0].fs, heads[k][0].window,
             lower) for k, a, b in tasks])
    out = []
    for k, (cfg, nf, n, _) in enumerate(heads):
        frames = np.concatenate([g for (k2, _, _), g in zip(tasks, got)
                                 if k2 == k])          # [nf * nch, 2048]
        frames = frames.reshape(nf, cfg.channels, C.LONG_SIZE)
        pcm = np.stack([dsp.overlap_add(frames[:, ch], n)
                        for ch in range(cfg.channels)], 1)
        out.append(to_i16(pcm))
    return out
