"""K10: the decoder's synthesis after its FFTs as a hand-written CUDA
kernel.

Replaces the back half of the JAX package's decoder jit
(mrcaudiocodec_tpu/models/decoder.py:64-102, :91-101: dsp.synthesize,
mrcaudiocodec_tpu/ops/dsp.py:274-291, whose IMDCT the CPU runs as
native/xmath_ffi.cpp mode 2 after its FFT, then the overlap-add and the
int16 conversion) and the decode's seam add; no Pallas counterpart.
Source: csrc/synth_post.cu (design and bound noted there).

`synth_post(l_re, l_im, s_re, s_im, bt, window, pcm16, prev=None,
out=None)`: K1's outputs of the long IMDCT [F, 512] and the short [F, 8,
64], bt int8 [R, s] (F = R * s), and prev, the previous chunk's tail [R,
HOP] f32 or None -> (pcm [s * HOP, R] float32, or int16 if pcm16, first
[R, HOP] f32, tail [R, HOP] f32). pcm is time-major, the layout of the
decode's [n, channels]: hop f is frame f's first half plus frame f-1's
second half, and hop 0 is frame 0's first half plus prev (+0 where prev is
None: the seam of a chunked decode is the one f32 add); `first` is frame
0's first half as it is and `tail` frame s-1's second half. `out`, if
given, is the [s * HOP, R] tensor pcm is written into (a slice of a
clip's buffer). For a CUDA tensor it launches the kernel (or raises); for
a CPU tensor it takes the plain version `synth_post_plain`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import config as C
from ... import xmath

launches = 0            # kernel launches since the last reset


def _check(l_re, l_im, s_re, s_im, bt, prev, out, pcm16: bool, cuda: bool):
    nf = bt.numel()
    r, s = bt.shape if bt.dim() == 2 else (-1, -1)
    want = [(l_re, torch.float32, (nf, C.LONG_COEFFS // 2)),
            (l_im, torch.float32, (nf, C.LONG_COEFFS // 2)),
            (s_re, torch.float32, (nf, C.N_SHORT, C.SHORT_COEFFS // 2)),
            (s_im, torch.float32, (nf, C.N_SHORT, C.SHORT_COEFFS // 2)),
            (bt, torch.int8, (r, s))]
    if prev is not None:
        want.append((prev, torch.float32, (r, C.HOP)))
    if out is not None:
        want.append((out, torch.int16 if pcm16 else torch.float32,
                     (s * C.HOP, r)))
    for t, dtype, shape in want:
        if (t.dtype != dtype or tuple(t.shape) != shape or bt.dim() != 2
                or t.device != bt.device or t.is_cuda != cuda
                or not t.is_contiguous()):
            raise ValueError(
                f"synth_post: want contiguous {dtype} {shape} on the device "
                f"of bt [R, s]{' (a card)' if cuda else ''}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
    for t in (prev, out):
        if t is not None and t.data_ptr() % 16:
            raise ValueError("synth_post: `prev` and `out` must be 16-byte "
                             "aligned")


def synth_post_plain(l_re, l_im, s_re, s_im, bt, window: str,
                     pcm16: bool, prev=None, out=None):
    """Plain PyTorch version (same contract as the kernel): dsp's
    synth_windowed (the IMDCT's post-twiddle, unfold and window of both
    families, the sub-blocks added onto zeros, the select by bt), the
    overlap-add onto +0 before frame 0, hop 0 = first + prev where prev is
    given, then int16 and the transpose to time-major."""
    from ..dsp import synth_windowed
    _check(l_re, l_im, s_re, s_im, bt, prev, out, pcm16, bt.is_cuda)
    r, s = bt.shape
    frames = synth_windowed(l_re, l_im, s_re, s_im, bt.reshape(-1),
                            window).reshape(r, s, C.LONG_SIZE)
    first, second = frames[:, :, :C.HOP], frames[:, :, C.HOP:]
    before = torch.cat([torch.zeros_like(second[:, :1]), second[:, :-1]], 1)
    hops = first + before
    if prev is not None:
        hops[:, 0] = first[:, 0] + prev
    pcm = hops.reshape(r, s * C.HOP)
    if pcm16:
        pcm = torch.clamp(torch.round(pcm * 32767.0), -32768, 32767).to(
            torch.int16)
    pcm = pcm.T.contiguous()
    if out is not None:
        pcm = out.copy_(pcm)
    return pcm, first[:, 0].contiguous(), second[:, -1].contiguous()


@functools.lru_cache(maxsize=1)
def _fn():
    from .build import lib
    fn = lib("synth_post").mrc_synth_post
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    return fn


def synth_post_kernel(l_re, l_im, s_re, s_im, bt, window: str,
                      pcm16: bool, prev=None, out=None):
    """Launch K10 on CUDA tensors; same contract as synth_post_plain."""
    global launches
    from ..dsp import _windows
    _check(l_re, l_im, s_re, s_im, bt, prev, out, pcm16, True)
    dev = bt.device
    r, s = bt.shape
    pcm = out if out is not None else torch.empty(
        (s * C.HOP, r), device=dev,
        dtype=torch.int16 if pcm16 else torch.float32)
    first, tail = (torch.empty((r, C.HOP), dtype=torch.float32, device=dev)
                   for _ in range(2))
    if r * s == 0:
        return pcm, first, tail
    lw, sw = _windows(window, str(dev))
    dl, ds = (xmath.dev_dct4_blob(m, str(dev))
              for m in (C.LONG_COEFFS, C.SHORT_COEFFS))
    with torch.cuda.device(dev):           # the tensors' card is current
        rc = _fn()(l_re.data_ptr(), l_im.data_ptr(), s_re.data_ptr(),
                   s_im.data_ptr(), bt.data_ptr(), lw.data_ptr(),
                   sw.data_ptr(), dl.data_ptr(), ds.data_ptr(),
                   0 if prev is None else prev.data_ptr(), r, s,
                   int(bool(pcm16)), pcm.data_ptr(),
                   first.data_ptr(), tail.data_ptr(),
                   torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"synth_post launch failed: cudaError {rc}")
    launches += 1
    return pcm, first, tail


def synth_post(l_re, l_im, s_re, s_im, bt, window: str, pcm16: bool,
               prev=None, out=None):
    """A chunk's PCM from K1's outputs: K10 on the card, the plain version
    for CPU tensors, an error for anything else."""
    if bt.is_cuda:
        return synth_post_kernel(l_re, l_im, s_re, s_im, bt, window, pcm16,
                                 prev, out)
    if bt.device.type == "cpu":
        return synth_post_plain(l_re, l_im, s_re, s_im, bt, window, pcm16,
                                prev, out)
    raise ValueError(f"no synthesis for device {bt.device}")
