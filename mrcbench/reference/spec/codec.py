"""Normative codec: encode and decode (reference components R15/R16,
SURVEY.md §2).

The port's copy of the JAX package's `spec/codec.py`, on the port's
`bitstream.py`.

Pure NumPy, single threaded. This is the in-repo stand-in for the absent
reference tree (SURVEY.md §0): it DEFINES bit-exact behavior and is the
denominator of the ">=100x realtime factor" target (BASELINE.json:5).
"""
from __future__ import annotations

import numpy as np

from .. import config as C
from .. import tables as T
from ..config import CodecConfig
from ..utils.bits import BitReader, BitWriter
from .. import bitstream
from . import dsp, entropy, psycho, quantize, rd, reservoir

F32 = np.float32


def encode_channel(x: np.ndarray, cfg: CodecConfig):
    """One channel [n] float32 -> per-frame records (content codes/lens).

    Since rev 5 the per-frame stages run through the batched forms
    (dsp.analyze_frames / psycho.analyze_frames / rd.rd_frames) — same
    normative arithmetic, frames as rows — which keeps the spec codec
    around realtime so the >=100x engine target has an honest denominator
    (SURVEY.md §6). The per-frame functions remain the one-frame
    reference definitions; tests/test_spec_batching.py asserts the two
    forms are value-identical."""
    frames = dsp.frame_signal(x)
    nf = len(frames)
    tr = dsp.detect_transients(frames)
    bt = dsp.block_types(tr, cfg.window_switching)

    coeffs = dsp.analyze_frames(frames, bt, cfg.window)
    allowed, pe, _ = psycho.analyze_frames(frames, coeffs, bt, cfg.fs,
                                           cfg.full_psycho)
    budgets = reservoir.allocate(pe, cfg)
    q, amp, gain, _bits = rd.rd_frames(coeffs, allowed, budgets, bt, cfg.fs)

    records = []
    for f in range(nf):
        codes, lens = entropy.encode_frame_symbols(
            q[f], amp[f], int(gain[f]), int(bt[f]), cfg.fs)
        records.append((codes, lens))
    return records, bt, budgets


def encode(x: np.ndarray, cfg: CodecConfig) -> bytes:
    """PCM [n] or [n, channels] float32 in [-1, 1] -> MRC1 bytes."""
    x = np.asarray(x, dtype=F32)
    if x.ndim == 1:
        x = x[:, None]
    n, nch = x.shape
    if nch != cfg.channels:
        raise ValueError(f"config expects {cfg.channels} channels, got {nch}")
    nf = cfg.frames_for_samples(n)

    per_ch = [encode_channel(x[:, ch], cfg) for ch in range(nch)]

    w = BitWriter()
    bitstream.write_header(w, cfg, nf, n)
    for f in range(nf):
        for ch in range(nch):
            codes, lens = per_ch[ch][0][f]
            content = int(sum(lens))
            w.write(content, C.FRAME_LEN_BITS)
            for c, l in zip(codes, lens):
                w.write(c, l)
            w.align()
    return w.getvalue()


def decode(data: bytes):
    """MRC1 bytes -> (pcm [n, channels] float32, cfg)."""
    cfg, nf, n_samples, hdr_bits = bitstream.read_header(data)
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    pos = hdr_bits
    lay = T.unified_layout(cfg.fs)
    del lay
    out = np.zeros((n_samples, cfg.channels), dtype=F32)
    prev = [np.zeros((0,), dtype=F32)] * cfg.channels
    synth = [np.zeros((nf, C.LONG_SIZE), dtype=F32) for _ in range(cfg.channels)]
    for f in range(nf):
        for ch in range(cfg.channels):
            cur = entropy._Bits(bits, pos)
            content = cur.take(C.FRAME_LEN_BITS)
            body_start = cur.pos
            q, e_bin, block_type, gain = entropy.decode_frame_content(
                cur, cfg.fs)
            if cur.pos - body_start != content:
                raise ValueError(
                    f"frame {f} ch {ch}: content length mismatch "
                    f"({cur.pos - body_start} != {content})")
            pos = body_start + content
            pos += (-pos) % 8
            xhat = quantize.dequantize(q, e_bin)
            synth[ch][f] = dsp.synthesize_frame(xhat, block_type, cfg.window)
    for ch in range(cfg.channels):
        out[:, ch] = dsp.overlap_add(synth[ch], n_samples)
    del prev
    return out, cfg
