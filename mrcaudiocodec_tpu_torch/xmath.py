"""Bit-exact MDCT arithmetic in PyTorch (the codec's determinism core).

The MDCT's DCT-IV is a FIXED SEQUENCE of single IEEE-754 float32
elementwise operations,

    pre-twiddle -> radix-2 DIF FFT (log2(M/2) stages) -> post-twiddle,

with every multiply/add/subtract a separate correctly-rounded f32 op and
every constant rounded once from float64. This module is the PyTorch form
of the JAX package's `xmath.py` (its "roll form" of the same butterfly
graph): the same ops on the same operands, so the values are bitwise equal
to the NumPy spec codec (tests/test_torch_primitives.py).

PyTorch eager runs one op per kernel, so no multiply is ever contracted
with an add into an FMA. Traps this module avoids: torch has no
negative-step slices (`torch.flip` takes their place), and every Python
float constant is the float32 value itself, so the f32 op sees exactly
the constant the spec uses.

The numpy table builders (`_fft_stages`, `_dct4_tables`, `_dif_tables`)
are verbatim copies. (The JAX package's `_dif_tables_grouped` is not
needed: the plain FFT runs each short-block FFT on its own last axis, and
the CUDA kernel indexes the group-local table.) On the card, the FFT
stages run in the hand-written CUDA kernel of
ops/kernels/fft_stages.py; `fft_dif` below is its plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

F32 = np.float32


@functools.lru_cache(maxsize=None)
def _fft_stages(n: int):
    """Twiddle tables for the radix-2 FFT of size n.

    Stage with sub-transform length m uses w[j] = exp(-2*pi*i*j/m),
    j = 0..m/2-1, rounded to f32 from f64. Returns a tuple of
    (w_re[m/2], w_im[m/2]) pairs for m = n, n/2, ..., 2.
    """
    assert n >= 2 and (n & (n - 1)) == 0, f"size {n} not a power of two"
    stages = []
    m = n
    while m > 1:
        j = np.arange(m // 2, dtype=np.float64)
        ang = -2.0 * np.pi * j / m
        stages.append((np.cos(ang).astype(F32), np.sin(ang).astype(F32)))
        m //= 2
    return tuple(stages)


@functools.lru_cache(maxsize=None)
def _dct4_tables(m_size: int):
    """Pre/post twiddles + scale for the size-m DCT-IV (f32 from f64)."""
    h = m_size // 2
    mm = np.arange(h, dtype=np.float64)
    pre = -np.pi * (mm + 0.25) / m_size
    post = -np.pi * mm / m_size
    return {
        "pre_re": np.cos(pre).astype(F32),
        "pre_im": np.sin(pre).astype(F32),
        "post_re": np.cos(post).astype(F32),
        "post_im": np.sin(post).astype(F32),
        "scale": F32(np.sqrt(2.0 / m_size)),
    }


@functools.lru_cache(maxsize=None)
def _dif_tables(n: int):
    """Per-stage (mask, tw_re, tw_im, half) for the roll-form DIF FFT.

    Stage with block size m (m = n, n/2, ..., 2): position p belongs to
    block-local index l = p % m; l < m/2 computes a sum, l >= m/2 a
    twiddled difference with w[l - m/2] — the SAME f32 twiddle values as
    _fft_stages (top positions get 1+0i, discarded by the mask select).
    """
    out = []
    m = n
    for w_re, w_im in _fft_stages(n):
        half = m // 2
        reps = n // m
        mask = (np.arange(n) % m) < half
        twr = np.tile(np.concatenate([np.ones(half, F32), w_re]), reps)
        twi = np.tile(np.concatenate([np.zeros(half, F32), w_im]), reps)
        out.append((mask, twr.astype(F32), twi.astype(F32), half))
        m //= 2
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _dev_dif_tables(n: int, device: str):
    """_dif_tables(n) as tensors on `device`: (mask, tw_re, tw_im, half)."""
    return tuple((torch.from_numpy(mask).to(device),
                  torch.from_numpy(twr).to(device),
                  torch.from_numpy(twi).to(device), half)
                 for mask, twr, twi, half in _dif_tables(n))


@functools.lru_cache(maxsize=None)
def dct4_blob(m_size: int) -> np.ndarray:
    """The size-m DCT-IV's constants for the analysis kernels, in
    `ffi_table`'s order (the JAX package's xmath) without its FFT stage
    twiddles, which K1 holds: [pre_re, pre_im, post_re, post_im, scale],
    f32 [4 * (m/2) + 1]."""
    cst = _dct4_tables(m_size)
    return np.concatenate([cst["pre_re"], cst["pre_im"], cst["post_re"],
                           cst["post_im"], [cst["scale"]]]).astype(F32)


@functools.lru_cache(maxsize=None)
def dev_dct4_blob(m_size: int, device: str):
    """dct4_blob(m_size) as a tensor on `device`."""
    return torch.from_numpy(dct4_blob(m_size)).to(device)


@functools.lru_cache(maxsize=None)
def _dev_dct4(m_size: int, device: str):
    cst = _dct4_tables(m_size)
    out = {k: torch.from_numpy(cst[k]).to(device)
           for k in ("pre_re", "pre_im", "post_re", "post_im")}
    out["scale"] = float(cst["scale"])
    return out


def _cmul(ar, ai, br, bi):
    """(ar+i*ai)*(br+i*bi) as four multiplies, one subtract, one add —
    each a single correctly-rounded op (separate torch kernels)."""
    return ar * br - ai * bi, ar * bi + ai * br


def fft_dif_stages(re, im):
    """The classic-DIF butterfly stages WITHOUT the final bit-reversal:
    output position p holds the natural-order FFT value at bitrev(p).

    re/im: [..., n] float32. Rolls are circular; wrapped lanes land only
    where the mask discards them (the JAX package's roll form, verbatim).
    """
    n = re.shape[-1]
    for mask, twr, twi, half in _dev_dif_tables(n, str(re.device)):
        rm_re = torch.roll(re, -half, -1)
        rm_im = torch.roll(im, -half, -1)
        rp_re = torch.roll(re, half, -1)
        rp_im = torch.roll(im, half, -1)
        top_re = re + rm_re
        top_im = im + rm_im
        d_re = rp_re - re
        d_im = rp_im - im
        bot_re, bot_im = _cmul(d_re, d_im, twr, twi)
        re = torch.where(mask, top_re, bot_re)
        im = torch.where(mask, top_im, bot_im)
    return re, im


def _bitrev(x):
    """Bit-reversal permutation along the last axis (size 2^k) as a
    reshape/permute — exact data movement."""
    n = x.shape[-1]
    lg = n.bit_length() - 1
    lead = tuple(x.shape[:-1])
    nl = len(lead)
    y = x.reshape(lead + (2,) * lg)
    axes = tuple(range(nl)) + tuple(range(nl + lg - 1, nl - 1, -1))
    return y.permute(axes).reshape(lead + (n,))


def fft_dif(re, im):
    """Natural-order FFT along the last axis: DIF stages + bit reversal."""
    re, im = fft_dif_stages(re, im)
    return _bitrev(re), _bitrev(im)


def fold(v):
    """TDAC fold [..., 2M] -> [..., M] (negation/subtraction are single
    IEEE ops)."""
    m = v.shape[-1] // 2
    h = m // 2
    a = -torch.flip(v[..., 2 * h:3 * h], [-1]) - v[..., 3 * h:]
    b = v[..., :h] - torch.flip(v[..., h:2 * h], [-1])
    return torch.cat([a, b], dim=-1)


def unfold(u):
    """Transpose of fold: [..., M] -> [..., 2M]."""
    m = u.shape[-1]
    h = m // 2
    return torch.cat([
        u[..., h:],
        -torch.flip(u[..., h:m], [-1]),
        -torch.flip(u[..., :h], [-1]),
        -u[..., :h],
    ], dim=-1)


def dct_iv_pre(u):
    """The DCT-IV's ops before its FFT: the even / flipped-odd split and
    the pre-twiddle. u [..., M] -> (z_re, z_im) [..., M/2]."""
    cst = _dev_dct4(u.shape[-1], str(u.device))
    ue = u[..., 0::2]
    uo = torch.flip(u, [-1])[..., 0::2]                 # u[M-1-2m]
    return _cmul(ue, uo, cst["pre_re"], cst["pre_im"])


def dct_iv_post(a_re, a_im):
    """The DCT-IV's ops after its FFT: the post-twiddle, the flip(-b_im)
    interleave and the scale. (a_re, a_im) [..., M/2] -> [..., M]."""
    h = a_re.shape[-1]
    cst = _dev_dct4(2 * h, str(a_re.device))
    b_re, b_im = _cmul(a_re, a_im, cst["post_re"], cst["post_im"])
    neg_rev = torch.flip(-b_im, [-1])
    out = torch.stack([b_re, neg_rev], dim=-1).reshape(
        a_re.shape[:-1] + (2 * h,))
    return out * cst["scale"]


def dct_iv_fast(u):
    """Orthonormal DCT-IV along the last axis (size 2^k).

    The FFT stages are `fft_stages.fft`: the CUDA kernel K1 for a CUDA
    tensor, the plain `fft_dif` for a CPU tensor."""
    from .ops.kernels import fft_stages      # it imports this module
    return dct_iv_post(*fft_stages.fft(*dct_iv_pre(u)))


def mdct_windowed_fast(fr, w):
    """Window multiply -> TDAC fold -> DCT-IV. fr: [..., 2M] -> [..., M]."""
    return dct_iv_fast(fold(fr * w))


def imdct_windowed_fast(x, w):
    """DCT-IV -> unfold -> window multiply. [..., M] -> [..., 2M]."""
    return unfold(dct_iv_fast(x)) * w
