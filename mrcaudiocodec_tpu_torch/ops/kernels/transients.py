"""K5: transient detection and block types as a hand-written CUDA kernel.

Replaces the framing, `dsp.detect_transients` and `_block_types_dev` of
the JAX encoder's analysis program, jit A
(mrcaudiocodec_tpu/models/encoder.py:65-120), which the JAX package
leaves to XLA; no Pallas counterpart. Source: csrc/transients.cu (design
and bound noted there).

`block_types(audio, window_switching)`: a chunk's hop rows [R, (s+3)*HOP]
(int16 or float32, covering frames f0-1 .. f0+s+1) -> bt int32 [R, s]. For
a CUDA tensor it launches the kernel (or raises); for a CPU tensor it
takes the plain version `transients_plain`, the eager framing,
`dsp.detect_transients` and `dsp.block_types`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config as C
from ... import xpsy

launches = 0            # kernel launches since the last reset
MAX_TILE = 14           # block types a block writes, at most (16 warps)


def hop_frames(audio, s: int, first: int, count: int):
    """Frames [R * count, 2048] f32 of the hop rows: frame j of row r is
    hops first + j and first + j + 1 (int16 scaled by 2^-15, exactly)."""
    a = audio
    if a.dtype == torch.int16:
        a = a.to(torch.float32) * (1.0 / 32768.0)
    else:
        a = a.to(torch.float32)
    hops = a.reshape(a.shape[0], s + 3, C.HOP)
    return torch.cat([hops[:, first:first + count],
                      hops[:, first + 1:first + count + 1]],
                     dim=-1).reshape(-1, C.LONG_SIZE)


def _s_of(audio) -> int:
    s = audio.shape[-1] // C.HOP - 3
    if audio.dim() != 2 or s < 1 or audio.shape[-1] != (s + 3) * C.HOP:
        raise ValueError(f"hop rows [R, (s + 3) * {C.HOP}] wanted, got "
                         f"{tuple(audio.shape)}")
    return s


def transients_plain(audio, window_switching: bool):
    """Plain PyTorch version: the s + 2 extended frames of every row,
    their transient flags (dsp.detect_transients), then dsp.block_types
    with the true neighbours."""
    from .. import dsp
    s = _s_of(audio)
    tr = dsp.detect_transients(hop_frames(audio, s, 0, s + 2))
    return dsp.block_types(tr.reshape(audio.shape[0], s + 2),
                           window_switching)


def tile_outputs(rows: int, s: int, sms: int) -> int:
    """The block types T each block of K5 writes for R rows of s frames
    on a card of `sms` SMs: a row splits into ceil(s / T) tiles, each of
    T + 2 warps (one an extended frame, the 2 at its edges shared with the
    neighbouring tiles). As few tiles a row as T <= MAX_TILE allows, but
    about 2 * sms blocks over all rows (where a row has frames enough),
    and T as even over a row's tiles as it goes: 2 x 1293 frames on 132
    SMs take 2 x 130 tiles of 10, 128 x 64 tiles of 13 (the last 12)."""
    tiles = max(-(-s // MAX_TILE), -(-2 * sms // rows))
    tiles = min(tiles, s)
    return -(-s // tiles)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("transients").mrc_transients
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_rows(name, audio):
    """Raise unless audio is int16 or float32 rows on the card, each row
    contiguous."""
    if audio.dtype not in (torch.int16, torch.float32) or not audio.is_cuda:
        raise ValueError(f"{name}: want int16 or float32 CUDA rows, got "
                         f"{audio.dtype} on {audio.device}")
    if audio.dim() != 2 or (audio.shape[1] > 1 and audio.stride(1) != 1):
        raise ValueError(f"{name}: rows must be contiguous within a row")


def transients_kernel(audio, window_switching: bool):
    """Launch K5 on CUDA hop rows; same contract as transients_plain."""
    global launches
    check_rows("transients_kernel", audio)
    s = _s_of(audio)
    r = audio.shape[0]
    bt = torch.empty((r, s), dtype=torch.int32, device=audio.device)
    if r == 0:
        return bt
    tile = tile_outputs(r, s, _sms(audio.device.index or 0))
    consts = xpsy.kernel_consts()           # alive through the call
    with torch.cuda.device(audio.device):   # the tensors' card is current
        rc = _fn()(audio.data_ptr(), int(audio.dtype == torch.int16),
                   audio.stride(0), r, s, tile, int(bool(window_switching)),
                   consts.ctypes.data, bt.data_ptr(),
                   torch.cuda.current_stream(audio.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"transients launch failed: cudaError {rc}")
    launches += 1
    return bt


def block_types(audio, window_switching: bool):
    """Block types of a chunk's hop rows: K5 on the card, the plain
    version for CPU tensors, an error for anything else."""
    if audio.is_cuda:
        return transients_kernel(audio, window_switching)
    if audio.device.type == "cpu":
        return transients_plain(audio, window_switching)
    raise ValueError(f"no block types for device {audio.device}")
