"""K11: one encode chunk's padded rows, built on the card from the clips'
PCM as it was uploaded, as a hand-written CUDA kernel.

Replaces no TPU kernel: the JAX package pads on the host and hands XLA
the rows, as `encoder._padded_rows` and `encoder.upload_chunk` still do
for the host-packer oracle. Source: csrc/pad_rows.cu (design and bound
noted there).

`pad_rows(pcm, clips, f0, s)`: pcm [sum n_j, nch] (int16 or float32, the
clips back to back, `encoder.upload_pcm`), clips [J, 2] int64 (each
clip's first sample in pcm and its length) -> the rows covering frames
[f0 - 1, f0 + s + 1) of every clip, [J * nch, (s + 3) * HOP] of pcm's
dtype: row j * nch + c is clip j's channel c from column 2 * HOP - f0 *
HOP on, zeros elsewhere, exactly `upload_chunk(_padded_rows(...), f0, s)`
(and its batch form, the clips' rows stacked). For a CUDA tensor it
launches the kernel (or raises); for a CPU tensor it takes the plain
version `pad_rows_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config as C

launches = 0            # kernel launches since the last reset


def _lo_width(f0: int, s: int) -> tuple[int, int]:
    """The chunk's first sample (column 0) and its width in samples."""
    return (f0 - 2) * C.HOP, (s + 3) * C.HOP


def pad_rows_plain(pcm, clips, f0: int, s: int):
    """Plain PyTorch version (same contract as the kernel)."""
    nch = pcm.shape[1]
    lo, width = _lo_width(f0, s)
    out = pcm.new_zeros((clips.shape[0] * nch, width))
    for j, (off, n) in enumerate(clips.tolist()):
        a, b = max(lo, 0), min(lo + width, n)
        if a < b:
            out[j * nch:(j + 1) * nch, a - lo:b - lo] = \
                pcm[off + a:off + b].T
    return out


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("pad_rows").mrc_pad_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pad_rows_kernel(pcm, clips, f0: int, s: int):
    """Launch K11 on CUDA tensors; same contract as pad_rows_plain."""
    global launches
    if (pcm.dtype not in (torch.int16, torch.float32) or pcm.dim() != 2
            or pcm.shape[1] not in (1, 2) or not pcm.is_cuda
            or not pcm.is_contiguous()):
        raise ValueError(
            f"pad_rows_kernel: want contiguous int16 or float32 [n, 1 or 2] "
            f"on a card, got {pcm.dtype} {tuple(pcm.shape)} on {pcm.device}")
    if (clips.dtype != torch.int64 or clips.dim() != 2
            or clips.shape[1] != 2 or not 1 <= clips.shape[0] <= 65535
            or clips.device != pcm.device or not clips.is_contiguous()):
        raise ValueError(
            f"pad_rows_kernel: want contiguous int64 clips [1..65535, 2] on "
            f"{pcm.device}, got {clips.dtype} {tuple(clips.shape)} on "
            f"{clips.device}")
    if s < 1:
        raise ValueError(f"pad_rows_kernel: a chunk of {s} frames")
    nch = pcm.shape[1]
    lo, width = _lo_width(f0, s)
    out = torch.empty((clips.shape[0] * nch, width), dtype=pcm.dtype,
                      device=pcm.device)
    with torch.cuda.device(pcm.device):    # the tensors' card is current
        rc = _fn()(pcm.data_ptr(), clips.data_ptr(), out.data_ptr(),
                   clips.shape[0], nch, pcm.element_size(), lo, width,
                   torch.cuda.current_stream(pcm.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pad_rows launch failed: cudaError {rc}")
    launches += 1
    return out


def pad_rows(pcm, clips, f0: int, s: int):
    """A chunk's padded rows: K11 on the card, the plain version for CPU
    tensors, an error for anything else."""
    if pcm.is_cuda:
        return pad_rows_kernel(pcm, clips, f0, s)
    if pcm.device.type == "cpu":
        return pad_rows_plain(pcm, clips, f0, s)
    raise ValueError(f"no padded rows for device {pcm.device}")
