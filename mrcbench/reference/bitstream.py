"""MRC1 file/bitstream syntax: header write/read and record offsets.

A copy of the JAX package's `spec/bitstream.py` (the format definition).

File layout (all fields MSB-first):
  header (18 bytes):
    u32 magic "MRC1" | u8 version | u4 fs_code | u4 channels | u20 bitrate
    u8 flags (b0 window_switching, b1 full_psycho, b2 reservoir, b3 kbd)
    u32 n_frames | u32 n_samples | u4 pad
  frames, channel-interleaved (frame0 ch0, frame0 ch1, frame1 ch0, ...):
    u20 content_length_in_bits | content | zero pad to byte boundary

The per-frame length prefix plus byte alignment is a deliberate TPU-first
choice: the decoder can locate every frame with one vectorized scan and
then decode all frames in parallel (no sequential Huffman dependency across
frames) — see docs/FORMAT.md.
"""
from __future__ import annotations

import numpy as np

from . import config as C
from .config import CodecConfig
from .utils.bits import BitReader, BitWriter

VERSION = 1
HEADER_BYTES = 18


def write_header(w: BitWriter, cfg: CodecConfig, n_frames: int,
                 n_samples: int) -> None:
    w.write(C.MAGIC, 32)
    w.write(VERSION, 8)
    w.write(C.SUPPORTED_RATES.index(cfg.fs), 4)
    w.write(cfg.channels, 4)
    w.write(cfg.bitrate, 20)
    flags = (int(cfg.window_switching) | (int(cfg.full_psycho) << 1)
             | (int(cfg.reservoir) << 2) | (int(cfg.window == "kbd") << 3))
    w.write(flags, 8)
    w.write(n_frames, 32)
    w.write(n_samples, 32)
    w.align()


def read_header(data: bytes):
    if len(data) < HEADER_BYTES:
        raise ValueError(
            f"truncated stream: {len(data)} bytes < {HEADER_BYTES}-byte header")
    r = BitReader(data)
    if r.read(32) != C.MAGIC:
        raise ValueError("not an MRC1 stream")
    version = r.read(8)
    if version != VERSION:
        raise ValueError(f"unsupported version {version}")
    fs_code = r.read(4)
    if fs_code >= len(C.SUPPORTED_RATES):
        raise ValueError(f"invalid fs_code {fs_code}")
    fs = C.SUPPORTED_RATES[fs_code]
    channels = r.read(4)
    bitrate = r.read(20)
    flags = r.read(8)
    n_frames = r.read(32)
    n_samples = r.read(32)
    r.align()
    if n_samples > n_frames * C.HOP:
        raise ValueError(
            f"invalid header: {n_samples} samples cannot come from "
            f"{n_frames} frames")
    cfg = CodecConfig(
        fs=fs, channels=channels, bitrate=bitrate,
        window_switching=bool(flags & 1),
        full_psycho=bool(flags & 2),
        reservoir=bool(flags & 4),
        window="kbd" if flags & 8 else "sine",
    )
    return cfg, n_frames, n_samples, r.bitpos


def frame_byte_offsets(data: bytes, start_byte: int, n_records: int):
    """Vectorized scan of the frame records' byte offsets and bit lengths.

    Returns (offsets[n_records] int64 byte offset of each record,
             content_bits[n_records] int64).
    """
    buf = np.frombuffer(data, dtype=np.uint8)
    # every record costs >= 3 bytes (20-bit prefix + byte alignment), so a
    # header claiming more records than the payload could hold is corrupt;
    # the O(1) reject also stops absurd n_frames from driving this Python
    # scan for billions of iterations.
    if start_byte + 3 * n_records > len(buf):
        raise ValueError(
            f"truncated stream: {n_records} records need >= "
            f"{3 * n_records} payload bytes, only {len(buf) - start_byte} "
            "present")
    offsets = np.zeros(n_records, dtype=np.int64)
    lengths = np.zeros(n_records, dtype=np.int64)
    off = start_byte
    for i in range(n_records):
        if off + 3 > len(buf):
            raise ValueError(
                f"truncated stream: record {i}/{n_records} length prefix "
                f"at byte {off} beyond end of data ({len(buf)} bytes)")
        b0, b1, b2 = int(buf[off]), int(buf[off + 1]), int(buf[off + 2])
        content = (b0 << 12) | (b1 << 4) | (b2 >> 4)
        offsets[i] = off
        lengths[i] = content
        off += (C.FRAME_LEN_BITS + content + 7) // 8
    if off > len(buf):
        raise ValueError(
            f"truncated stream: last record ends at byte {off} beyond "
            f"end of data ({len(buf)} bytes)")
    return offsets, lengths
