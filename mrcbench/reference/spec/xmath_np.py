"""The NumPy half of the codec's bit-exact transforms (the determinism core).

The port's own copy of the functions of the JAX package's `xmath.py` that
the normative spec codec reaches: the DCT-IV of the MDCT (`dct_iv`: pre-
twiddle, radix-2 Stockham FFT, post-twiddle) and the classic-DIF FFT that
the psycho model's real FFT runs (`fft_dif`). NumPy only: the spec is the
yardstick the port is held to, so it shares no arithmetic code with the
port's torch `xmath.py`.

Every multiply/add/subtract is a separate correctly-rounded f32 op and
every constant is rounded once from float64; the op order is pinned by the
dataflow, so the values are the format's, bit for bit. The functions keep
the array-namespace argument `xp` of the JAX package's versions (here it
is always numpy), so the spec modules read as they do there.

Derivation of the O(M log M) DCT-IV (orthonormal), with H = M/2,
W = exp(-i*pi/M):

    z[m] = (u[2m] + i*u[M-1-2m]) * W^(m + 1/4)        m = 0..H-1
    A    = FFT_H(z)
    B[r] = A[r] * W^r
    X[2r] = Re B[r],   X[M-1-2r] = -Im B[r]

then X * sqrt(2/M).
"""
from __future__ import annotations

import functools

import numpy as np

F32 = np.float32


@functools.lru_cache(maxsize=None)
def _fft_stages(n: int):
    """Twiddle tables for the radix-2 Stockham FFT of size n.

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


def _cmul(ar, ai, br, bi, xp):
    """(ar+i*ai)*(br+i*bi) as four multiplies, one subtract, one add —
    each a single correctly-rounded IEEE op (NumPy materializes every
    product, so nothing is contracted)."""
    return ar * br - ai * bi, ar * bi + ai * br


def fft_stockham(re, im, xp):
    """Complex FFT along the last axis (size = power of two), as a fixed
    sequence of f32 butterflies. Self-sorting (no bit-reversal): at each
    stage the [..., l, m] view splits m in half, and groups double.

    re/im: [..., n] float32. Returns (re, im) of the same shape, equal to
    FFT(re + i*im) with the e^{-2*pi*i*nk/n} sign convention.
    """
    n = re.shape[-1]
    lead = re.shape[:-1]
    re = re.reshape(lead + (1, n))
    im = im.reshape(lead + (1, n))
    for w_re, w_im in _fft_stages(n):
        half = re.shape[-1] // 2
        a_re, b_re = re[..., :half], re[..., half:]
        a_im, b_im = im[..., :half], im[..., half:]
        top_re = a_re + b_re
        top_im = a_im + b_im
        d_re = a_re - b_re
        d_im = a_im - b_im
        wr = xp.asarray(w_re)[None, :]
        wi = xp.asarray(w_im)[None, :]
        bot_re, bot_im = _cmul(d_re, d_im, wr, wi, xp)
        re = xp.concatenate([top_re, bot_re], axis=-2)
        im = xp.concatenate([top_im, bot_im], axis=-2)
    return re.reshape(lead + (n,)), im.reshape(lead + (n,))


def dct_iv(u, xp):
    """Orthonormal DCT-IV along the last axis (size 2^k), the normative
    sequence. u: [..., M] float32 -> [..., M] float32."""
    m_size = u.shape[-1]
    cst = _dct4_tables(m_size)
    ue = u[..., 0::2]
    uo = u[..., ::-1][..., 0::2]                    # u[M-1-2m]
    pre_re = xp.asarray(cst["pre_re"])
    pre_im = xp.asarray(cst["pre_im"])
    z_re, z_im = _cmul(ue, uo, pre_re, pre_im, xp)
    a_re, a_im = fft_stockham(z_re, z_im, xp)
    post_re = xp.asarray(cst["post_re"])
    post_im = xp.asarray(cst["post_im"])
    b_re, b_im = _cmul(a_re, a_im, post_re, post_im, xp)
    neg_rev = (-b_im)[..., ::-1]
    out = xp.stack([b_re, neg_rev], axis=-1).reshape(u.shape)
    return out * cst["scale"]


# ---------------------------------------------------------------------------
# The classic in-place radix-2 DIF FFT: exactly the butterflies of
# fft_stockham ((a+b) and (a-b)*w with the same operand values and the
# same stage twiddle tables), on a constant-shape [..., n] array; only
# where intermediates are stored differs. Its bit-reversed output order is
# undone by a reshape/transpose (pure data movement).
# ---------------------------------------------------------------------------


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


def _bitrev(x, xp):
    """Bit-reversal permutation along the last axis (size 2^k) as a
    reshape/transpose — exact data movement, no gather."""
    n = x.shape[-1]
    lg = n.bit_length() - 1
    lead = x.shape[:-1]
    nl = len(lead)
    y = x.reshape(lead + (2,) * lg)
    axes = tuple(range(nl)) + tuple(range(nl + lg - 1, nl - 1, -1))
    return xp.transpose(y, axes).reshape(lead + (n,))


def fft_dif_stages(re, im, xp):
    """The classic-DIF butterfly stages WITHOUT the final bit-reversal:
    output position p holds the natural-order FFT value at bitrev(p).

    Values are bit-identical to fft_stockham (same ops on the same
    operands); the array keeps its [..., n] shape at every stage. Rolls
    are circular; wrapped lanes land only where the mask discards them.
    """
    n = re.shape[-1]
    roll = lambda v, s: xp.roll(v, s, axis=-1)
    for mask, twr, twi, half in _dif_tables(n):
        mask_b = xp.asarray(mask)
        rm_re, rm_im = roll(re, -half), roll(im, -half)
        rp_re, rp_im = roll(re, half), roll(im, half)
        top_re = re + rm_re
        top_im = im + rm_im
        d_re = rp_re - re
        d_im = rp_im - im
        bot_re, bot_im = _cmul(d_re, d_im, xp.asarray(twr), xp.asarray(twi),
                               xp)
        re = xp.where(mask_b, top_re, bot_re)
        im = xp.where(mask_b, top_im, bot_im)
    return re, im


def fft_dif(re, im, xp):
    """Classic-DIF instantiation of fft_stockham's butterfly graph,
    natural output order (bit-reversal undone by pure data movement)."""
    re, im = fft_dif_stages(re, im, xp)
    return _bitrev(re, xp), _bitrev(im, xp)
