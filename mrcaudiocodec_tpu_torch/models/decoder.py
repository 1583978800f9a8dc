"""Decoder pipeline: native host parse + device synthesis/overlap-add.

The MRC1 per-frame length prefixes let the C++ runtime parse all frame
records in parallel; the card then synthesizes chunks of frames in four
launches: K9 (dequantize, the IMDCT's pre-twiddles), K1 twice (the long
and the short FFTs) and K10 (post-twiddles, unfold, window, overlap-add,
the seam, int16). The chunks run in order on one stream, and each carries
its tail (the last frame's second half) to the next, whose K10 adds it to
its first hop (one f32 add, bitwise equal to a carry chain). K10 writes
each chunk's PCM time-major into its slice of one clip buffer on the
card, which the host downloads once, already [n, channels].

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


def _synth_chunk(q, e_band, bt, fs: int, window: str, pcm16: bool,
                 prev=None, out=None):
    """[R, s, 1024] int16 q + [R, s, NB] int16 exponents + [R, s] int8
    types -> (pcm [s*HOP, R], first [R, HOP] f32, tail [R, HOP] f32): K9
    (dequantize, the DCT-IV pre-twiddles), K1 on the long and the short
    layout, K10 (post-twiddles, unfold, window, short overlap, select,
    overlap-add, the seam, int16) on the card; each kernel's plain version
    for CPU tensors. pcm is time-major; its first hop adds `prev`, the
    previous chunk's tail [R, HOP] f32 (+0 where None); `first` is frame
    0's first half as it is, `tail` the last frame's second half. `out`:
    the [s*HOP, R] tensor pcm is written into, or None."""
    pre = synth_pre.synth_pre(q, e_band, bt, fs)
    return synth_post.synth_post(*fft_stages.fft(*pre[:2]),
                                 *fft_stages.fft(*pre[2:]), bt, window,
                                 pcm16, prev, out)


def record_slabs(data: bytes):
    """Parse every record (parse_records) -> the host slabs of DEC_CHUNK
    frames that _synth_chunk takes (slabs)."""
    return slabs(*parse_records(data), read_header(data)[0].channels)


def slabs(q, e_band, bt, nch: int):
    """parse_records' arrays -> [(q int16 [nch, s, 1024], e_band int16
    [nch, s, NB], bt int8 [nch, s])] of DEC_CHUNK frames, contiguous, in
    frame order."""
    nf = bt.shape[0] // nch
    # [nf*nch, ...] record order -> [nch, nf, ...], compact dtypes
    qc = np.swapaxes(q.reshape(nf, nch, -1), 0, 1).astype(np.int16)
    ec = np.swapaxes(e_band.reshape(nf, nch, -1), 0, 1).astype(np.int16)
    bc = bt.reshape(nf, nch).T.astype(np.int8)
    return [tuple(np.ascontiguousarray(a[:, f0:f0 + DEC_CHUNK])
                  for a in (qc, ec, bc)) for f0 in range(0, nf, DEC_CHUNK)]


def decode(data: bytes, device="cuda", pcm_dtype="float32"):
    """MRC1 bytes -> (pcm [n, channels] float32 or int16, cfg)."""
    if pcm_dtype not in ("float32", "int16"):
        raise ValueError(f"pcm_dtype must be 'float32' or 'int16', not "
                         f"{pcm_dtype!r}")
    pcm16 = pcm_dtype == "int16"
    dev = device_for(device)
    cfg, nf, n_samples, _ = read_header(data)
    clip = torch.empty((nf * C.HOP, cfg.channels), device=dev,
                       dtype=torch.int16 if pcm16 else torch.float32)
    tail, f0 = None, 0
    for slab in record_slabs(data):
        s = slab[2].shape[1]
        _, _, tail = _synth_chunk(
            *(torch.from_numpy(a).to(dev) for a in slab), cfg.fs, cfg.window,
            pcm16, tail, clip[f0 * C.HOP:(f0 + s) * C.HOP])
        f0 += s
    # the priming hop dropped, one download
    return clip[C.HOP:C.HOP + n_samples].cpu().numpy(), cfg
