"""Decoder pipeline: native host parse + device synthesis/overlap-add.

The MRC1 per-frame length prefixes let the C++ runtime parse all frame
records in parallel; the device then dequantizes, runs the IMDCT (FFT
stages in the CUDA kernel K1) and overlap-adds chunks of frames. Chunks
carry nothing across: each returns its first hop without the previous
chunk's flush half, and the host rebuilds each seam hop with one f32 add,
bitwise equal to a carry chain.

Entry point: `decode(data, device="cuda", pcm_dtype="float32")`. It runs
on the card unless the caller passes device="cpu"; without CUDA it raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import config as C
from .. import native
from ..bitstream import frame_byte_offsets, read_header
from ..ops import dsp, entropy, quantize
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


def synth_frames(q, e_band, bt, fs: int, window: str):
    """[R, s, 1024] q + [R, s, NB] exponents + [R, s] types (device) ->
    (first [R, s, HOP], second [R, s, HOP]) f32: each frame's synthesis,
    split into the halves that overlap the previous and the next frame."""
    r, f = bt.shape
    btf = bt.reshape(-1).to(torch.int32)
    tb = entropy.dev_tables(fs, str(q.device))
    ef = e_band.reshape(r * f, -1).to(torch.int32)
    # band -> bin exponent: an integer gather of each bin's band
    e_bin = torch.gather(ef, 1, tb["bin_band"][btf.long()].long())
    xhat = quantize.dequantize(q.reshape(r * f, -1).to(torch.int32), e_bin)
    frames = dsp.synthesize(xhat, btf, window).reshape(r, f, C.LONG_SIZE)
    return frames[:, :, :C.HOP], frames[:, :, C.HOP:]


def overlap_add(first, second, prev):
    """Each hop = its frame's first half + the previous frame's second
    half (one f32 add); `prev` [R, HOP] is the second half before frame 0
    (zeros at a clip's start) -> pcm [R, s*HOP] f32."""
    r, f, _ = first.shape
    prev = torch.cat([prev[:, None], second[:, :-1]], dim=1)
    return (first + prev).reshape(r, f * C.HOP)


def _synth_chunk(q, e_band, bt, fs: int, window: str, pcm16: bool):
    """[R, s, 1024] q + [R, s, NB] exponents + [R, s] types (device) ->
    (pcm [R, s*HOP], first [R, HOP] f32, tail [R, HOP] f32)."""
    first, second = synth_frames(q, e_band, bt, fs, window)
    pcm = overlap_add(first, second, torch.zeros_like(second[:, 0]))
    if pcm16:
        pcm = torch.clamp(torch.round(pcm * 32767.0), -32768, 32767).to(
            torch.int16)
    return pcm, first[:, 0], second[:, -1]


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
    pcms = [o[0].cpu().numpy() for o in outs]
    firsts = [o[1].cpu().numpy() for o in outs]
    tails = [o[2].cpu().numpy() for o in outs]
    for c in range(1, len(pcms)):
        seam = firsts[c] + tails[c - 1]        # single f32 add (exact seam)
        if pcm16:
            pcms[c][:, :C.HOP] = np.clip(np.round(seam * 32767.0),
                                         -32768, 32767).astype(np.int16)
        else:
            pcms[c][:, :C.HOP] = seam
    flat = np.concatenate(pcms, axis=1)
    return np.ascontiguousarray(flat[:, C.HOP:C.HOP + n_samples].T), cfg
