"""Decoder pipeline: native host parse + device synthesis/overlap-add.

The MRC1 per-frame length prefixes let the C++ runtime parse all frame
records in parallel; the card then synthesizes chunks of frames in four
launches: K9 (dequantize, the IMDCT's pre-twiddles), K1 twice (the long
and the short FFTs) and K10 (post-twiddles, unfold, window, overlap-add,
int16). Chunks carry nothing across: each returns its first hop without
the previous chunk's flush half, and the host rebuilds each seam hop with
one f32 add, bitwise equal to a carry chain.

Entry point: `decode(data, device="cuda", pcm_dtype="float32")`. It runs
on the card unless the caller passes device="cpu"; without CUDA it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config as C
from .. import native
from ..bitstream import frame_byte_offsets, read_header
from ..ops.kernels import fft_stages, synth_post, synth_pre
from .encoder import device_for

DEC_CHUNK = 1024                    # frames per device chunk


def parse_records(data: bytes):
    """Parse every channel-frame record on the host (native, parallel).

    Returns (q [nf*nch, 1024] i32, e_band [nf*nch, NB] i32, bt [nf*nch]
    i32) in record (frame, channel) order."""
    cfg, nf, _, hdr_bits = read_header(data)
    offs, _ = frame_byte_offsets(data, hdr_bits // 8, nf * cfg.channels)
    q, e_band, bt, _ = native.decode_records(
        data, offs * 8 + C.FRAME_LEN_BITS, cfg.fs)
    return q, e_band, bt


def _synth_chunk(q, e_band, bt, fs: int, window: str, pcm16: bool):
    """[R, s, 1024] int16 q + [R, s, NB] int16 exponents + [R, s] int8
    types -> (pcm [R, s*HOP], first [R, HOP] f32, tail [R, HOP] f32): K9
    (dequantize, the DCT-IV pre-twiddles), K1 on the long and the short
    layout, K10 (post-twiddles, unfold, window, short overlap, select,
    overlap-add, int16) on the card; each kernel's plain version for CPU
    tensors. pcm's first hop has +0 for the previous chunk's second half;
    `first` is frame 0's first half as it is, `tail` the last frame's
    second half."""
    pre = synth_pre.synth_pre(q, e_band, bt, fs)
    return synth_post.synth_post(*fft_stages.fft(*pre[:2]),
                                 *fft_stages.fft(*pre[2:]), bt, window,
                                 pcm16)


def record_slabs(data: bytes):
    """Parse every record (parse_records) -> the host slabs of DEC_CHUNK
    frames that _synth_chunk takes: [(q int16 [nch, s, 1024], e_band
    int16 [nch, s, NB], bt int8 [nch, s])], contiguous, in frame order."""
    cfg, nf, _, _ = read_header(data)
    nch = cfg.channels
    q, e_band, bt = parse_records(data)
    # [nf*nch, ...] record order -> [nch, nf, ...], compact dtypes
    qc = np.swapaxes(q.reshape(nf, nch, -1), 0, 1).astype(np.int16)
    ec = np.swapaxes(e_band.reshape(nf, nch, -1), 0, 1).astype(np.int16)
    bc = bt.reshape(nf, nch).T.astype(np.int8)
    return [tuple(np.ascontiguousarray(a[:, f0:f0 + DEC_CHUNK])
                  for a in (qc, ec, bc)) for f0 in range(0, nf, DEC_CHUNK)]


def join_chunks(outs, n_samples: int, pcm16: bool):
    """The chunks' downloaded (pcm, first, tail) numpy arrays -> the clip's
    PCM [n_samples, channels]: each seam hop is the chunk's first plus the
    chunk before's tail (one f32 add, then the int16 rounding for pcm16),
    the priming hop dropped."""
    pcms = [o[0] for o in outs]
    for c in range(1, len(outs)):
        seam = outs[c][1] + outs[c - 1][2]     # single f32 add (exact seam)
        if pcm16:
            pcms[c][:, :C.HOP] = np.clip(np.round(seam * 32767.0),
                                         -32768, 32767).astype(np.int16)
        else:
            pcms[c][:, :C.HOP] = seam
    flat = np.concatenate(pcms, axis=1)
    return np.ascontiguousarray(flat[:, C.HOP:C.HOP + n_samples].T)


def decode(data: bytes, device="cuda", pcm_dtype="float32"):
    """MRC1 bytes -> (pcm [n, channels] float32 or int16, cfg)."""
    if pcm_dtype not in ("float32", "int16"):
        raise ValueError(f"pcm_dtype must be 'float32' or 'int16', not "
                         f"{pcm_dtype!r}")
    pcm16 = pcm_dtype == "int16"
    dev = device_for(device)
    cfg, _, n_samples, _ = read_header(data)
    outs = [_synth_chunk(*(torch.from_numpy(a).to(dev) for a in slab),
                         cfg.fs, cfg.window, pcm16)
            for slab in record_slabs(data)]
    return join_chunks([[t.cpu().numpy() for t in o] for o in outs],
                       n_samples, pcm16), cfg
