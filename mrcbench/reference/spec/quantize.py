"""Normative nonlinear quantizer (reference component R8, SURVEY.md §2).

The port's copy of the JAX package's `spec/quantize.py`, on the
port's NumPy-only `spec/xpsy_np.py`.

AAC-style power-law quantizer with per-band scale-factor exponents:
    step_b   = 2 ** ((e_b - GAIN_BIAS) / 4)
    q        = sign(x) * min(floor((|x|/step_b)^0.75 + QUANT_MAGIC), QMAX)
    x_hat    = sign(q) * |q|^(4/3) * step_b

All arithmetic float32 in a NORMATIVE fixed op order (rev 4,
docs/FORMAT.md) built ONLY from operations that are correctly rounded on
every backend — multiplies, adds, compares, integer bit ops. Hardware
f32 divide and sqrt are NOT correctly rounded on TPU (2-ulp deltas,
scripts/tpu_div_probe.py), so rev 4 removes them:

    inv_step = inv_frac[(e-BIAS) & 3] * 2^(-((e-BIAS) >> 2))
               # inv_frac rounded once from float64; 2^-k scaling exact,
               # so inv_step carries exactly ONE rounding
    a        = |x| * inv_step                 # one more rounding
    a^0.75   = xsqrt(a * xsqrt(a))            # pinned Newton sqrt (xpsy)
    |q|^(4/3)= exp2(4/3 * log2(|q|))          # pinned xexp2/xlog2 (xpsy)

Mirrored bit-exactly by mrcaudiocodec_tpu/ops/quantize.py (jnp on TPU,
native FFI on XLA:CPU whose LLVM backend would FMA-contract the pinned
chains) and ops/pallas/quant_kernel.py.
"""
from __future__ import annotations

import numpy as np

from .. import config as C
from . import xpsy_np as xpsy

F32 = np.float32

# exact f32 roundings of 2^(r/4) and (from float64) of 2^(-r/4)
STEP_FRAC = np.array([2.0 ** 0.0, 2.0 ** 0.25, 2.0 ** 0.5, 2.0 ** 0.75],
                     dtype=F32)
INV_STEP_FRAC = np.array([2.0 ** 0.0, 2.0 ** -0.25, 2.0 ** -0.5,
                          2.0 ** -0.75], dtype=F32)
C43 = F32(4.0 / 3.0)


def band_steps(e: np.ndarray) -> np.ndarray:
    """Per-band exponent -> per-band step size (float32, exact dyadic)."""
    d = np.asarray(e, dtype=np.int32) - np.int32(C.GAIN_BIAS)
    return np.ldexp(STEP_FRAC[d & 3], d >> 2)   # frac * 2^k, both exact


import functools


@functools.lru_cache(maxsize=1)
def _inv_step_table() -> np.ndarray:
    """[256] f32: inv_band_steps(e) precomputed for every legal exponent
    (identical formula; the per-element ldexp was a spec hotspot)."""
    d = np.arange(256, dtype=np.int32) - np.int32(C.GAIN_BIAS)
    return np.ldexp(INV_STEP_FRAC[d & 3], -(d >> 2)).astype(F32)


def inv_band_steps(e: np.ndarray) -> np.ndarray:
    """Per-band exponent -> 1/step as inv_frac * 2^-k (one rounded factor,
    one exact power of two)."""
    return np.take(_inv_step_table(), np.asarray(e, dtype=np.int32),
                   mode="clip")


def quantize(x: np.ndarray, e_bin: np.ndarray) -> np.ndarray:
    """Coefficients [..., 1024] + per-bin exponent -> int32 q values.

    In-place buffer reuse only — every rounded operation is the same
    single IEEE op as the formula in the module docstring."""
    x = np.asarray(x, dtype=F32)
    a = np.abs(x) * inv_band_steps(e_bin)       # broadcasts x over gains
    s = xpsy.xsqrt(a, np)
    s *= a                                      # a * sqrt(a), in place
    p = xpsy.xsqrt(s, np)                       # a^0.75, pinned
    p += F32(C.QUANT_MAGIC)
    np.floor(p, out=p)
    np.minimum(p, F32(C.QMAX), out=p)
    mag = p.astype(np.int32)
    np.negative(mag, out=mag, where=(x < 0))    # sign apply, in place
    return mag


def dequantize(q: np.ndarray, e_bin: np.ndarray) -> np.ndarray:
    """int32 q values + per-bin exponent -> float32 reconstruction."""
    q = np.asarray(q)
    mag = np.abs(q).astype(F32)
    p43 = xpsy.xexp2(C43 * xpsy.xlog2(np.maximum(mag, F32(1.0)), np), np)
    p43 = np.where(mag == 0, F32(0.0), p43)
    val = p43 * band_steps(e_bin)
    return np.where(q < 0, -val, val).astype(F32)
