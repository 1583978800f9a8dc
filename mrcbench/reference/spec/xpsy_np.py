"""The NumPy half of the codec's bit-exact psychoacoustics (rev 4).

The port's own copy of the functions and constants of the JAX package's
`xpsy.py` that the normative spec codec reaches, with their NumPy paths
only. NumPy only: the spec is the yardstick the port is held to, so it
shares no arithmetic code with the port's torch `xpsy.py`.

Every value is a fixed sequence of single-rounded IEEE-754 f32 ops:

  * FFT: the fixed-sequence radix-2 FFT of `xmath_np` (real input via the
    half-size complex transform + fixed-op untwist).
  * Segment sums (bins -> partitions/bands): a Hillis-Steele segmented
    prefix scan — log2(n) shifted adds with STATIC masks — followed by a
    rounding-free selection of each segment's last element.
  * Spreading: an unrolled fixed-order sum over masker partitions, one
    mul + one add per term.
  * Transcendentals: xlog2/xexp2/xsqrt as fixed sequences of single IEEE
    ops (exponent/mantissa split via integer bitcast, polynomials with
    coefficients rounded once from float64), evaluated with in-place
    buffers: the same op sequence, value for value.

The functions keep the array-namespace argument `xp` of the JAX package's
versions (here it is always numpy), so the spec modules read as they do
there.
"""
from __future__ import annotations

import functools

import numpy as np

from .. import config as C
from .. import tables as T
from . import xmath_np

F32 = np.float32
TINY = F32(1e-20)

# f32 roundings (from float64) of the derivation constants
LN2 = F32(0.6931471805599453)
SQRT2 = F32(1.4142135623730951)
# exp(c) Taylor 1/k! k=0..7 (c = f*ln2, |c| <= 0.347)
_EXP_K = tuple(F32(1.0 / v) for v in (5040.0, 720.0, 120.0, 24.0, 6.0,
                                      2.0, 1.0, 1.0))

# log2(1+t) on t in [sqrt2/2 - 1, sqrt2 - 1]: Chebyshev-LSQ fit, deg 12,
# f64 truncation 3.7e-11 — far below the f32 Horner's own rounding. The
# chain uses NO divide (f32 divide is not correctly rounded on every
# backend, so the normative sequences avoid it entirely).
_LOG2_P = tuple(F32(v) for v in (
    0.0,
    1.4426950216293335, -0.7213475704193115, 0.48089826107025146,
    -0.36067137122154236, 0.28854310512542725, -0.24054786562919617,
    0.2060815393924713, -0.17848600447177887, 0.15869304537773132,
    -0.15966284275054932, 0.15780037641525269, -0.08521182835102081))
# 1/sqrt(m) on m in [1, 4): deg-5 Chebyshev-LSQ start (1.1e-3 rel), then
# two mul/add-only Newton steps r' = r*(1.5 - 0.5*m*r*r) -> ~1e-12 rel
_RSQRT_P = tuple(F32(v) for v in (
    1.9494401216506958, -1.6151533126831055, 0.911236047744751,
    -0.2903306782245636, 0.04800727963447571, -0.003200492588803172))
_MIN_NORMAL = F32(2.0 ** -126)


def xlog2(x, xp):
    """Normative log2 for positive finite normal f32 inputs.

    Exponent via integer bitcast (exact); mantissa m scaled into
    [sqrt2/2, sqrt2); log2(m) by a divide-free degree-12 Horner in
    t = m - 1 — every op a single correctly-rounded f32 mul/add.
    """
    return _xlog2_np(x)


def _xlog2_np(x):
    """xlog2's op sequence, evaluated with in-place buffers (the spec
    codec is memory-traffic-bound in these Horner chains)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    bits = x.view(np.int32)
    e = bits >> 23
    e -= 127
    mb = bits & np.int32(0x007FFFFF)
    mb |= np.int32(0x3F800000)
    m = mb.view(np.float32)
    big = m >= SQRT2
    np.multiply(m, F32(0.5), out=m, where=big)     # m*0.5 where big
    np.add(e, big, out=e, casting="unsafe")        # e + 1 where big (0/1)
    m -= F32(1.0)                                  # t = m - 1
    p = m * _LOG2_P[-1]
    p += _LOG2_P[-2]                               # Horner head
    for c in _LOG2_P[-3::-1]:
        p *= m
        p += c
    p += e.astype(np.float32)
    return p


def xsqrt(x, xp):
    """Normative sqrt for non-negative f32 inputs: even/odd exponent
    split (integer ops, exact), polynomial 1/sqrt start on m in [1, 4),
    two Newton steps, s = m * r — multiplies and adds only, each a
    single correctly-rounded op. Subnormal or zero inputs -> 0 (they
    floor to q == 0 downstream).
    """
    return _xsqrt_np(x)


def _xsqrt_np(x):
    """xsqrt's op sequence with in-place buffers ((-0.5)*h + 1.5 is the
    exact IEEE equal of 1.5 - 0.5*h: negation is a sign-bit flip and
    a + (-b) == a - b)."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    bits = x.view(np.int32)
    eb = bits >> 23
    eb -= 127
    odd = eb & np.int32(1)
    mb = bits & np.int32(0x007FFFFF)
    mb |= np.int32(0x3F800000)
    m = mb.view(np.float32)                                  # [1, 2)
    np.multiply(m, F32(2.0), out=m, where=(odd == 1))        # [1, 4) exact
    eb -= odd
    eb >>= 1                                                 # e2
    r = m * _RSQRT_P[-1]
    r += _RSQRT_P[-2]                                        # Horner head
    for c in _RSQRT_P[-3::-1]:
        r *= m
        r += c
    h = np.empty_like(r)
    for _ in range(2):
        np.multiply(m, r, out=h)
        h *= r
        h *= F32(-0.5)
        h += F32(1.5)                                        # w
        r *= h
    m *= r                                                   # s = m * r
    eb += 127
    eb <<= 23
    m *= eb.view(np.float32)                                 # s * 2^(e/2)
    np.copyto(m, F32(0.0), where=(x < _MIN_NORMAL))
    return m


def xexp2(x, xp):
    """Normative 2^x for f32 inputs in the psycho range (|x| < 126).

    k = roundToNearestEven(x) (np.rint), an exactly-defined integral-
    valued op; f = x - k is exact; 2^f = exp(f*ln2) by Taylor-Horner
    (7 terms, truncation < 6e-9); scale by 2^k via integer bitcast.
    """
    return _xexp2_np(x)


def _xexp2_np(x):
    """xexp2's op sequence, in place."""
    x = np.asarray(x, dtype=np.float32)
    k = np.rint(x).astype(np.int32)
    np.clip(k, -126, 126, out=k)
    f = x - k.astype(np.float32)
    f *= LN2                                                 # c = f*ln2
    p = f * _EXP_K[0]
    p += _EXP_K[1]                                           # Horner head
    for kk in _EXP_K[2:]:
        p *= f
        p += kk
    k += 127
    k <<= 23
    p *= k.view(np.float32)
    return p


# ---------------------------------------------------------------------------
# Segmented sums: Hillis-Steele scan with static masks + end selection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _seg_tables_from_edges(edges: tuple):
    """Static scan tables for contiguous segments given edges (len S+1,
    covering [0, n)). Returns (stages, ends) with stages a tuple of
    (shift d, include-mask[n]) for d = 1, 2, 4, ... < max segment width,
    and ends[s] = last bin of segment s (int array)."""
    e = np.asarray(edges, np.int64)
    n = int(e[-1])
    seg_start = np.zeros(n, np.int64)
    for s in range(len(e) - 1):
        seg_start[e[s]:e[s + 1]] = e[s]
    widths = e[1:] - e[:-1]
    maxw = int(widths.max()) if len(widths) else 1
    stages = []
    d = 1
    idx = np.arange(n)
    while d < maxw:
        stages.append((d, (idx - d) >= seg_start))
        d *= 2
    ends = (e[1:] - 1).astype(np.int64)
    return tuple(stages), ends


def seg_scan(p, stages, xp):
    """Segmented inclusive prefix sum along the last axis: after the scan,
    position i holds sum(p[seg_start(i) : i+1]) — a fixed balanced-tree
    op DAG (log2(max_width) stages of shifted adds)."""
    for d, mask in stages:
        sh = xp.concatenate([xp.zeros(p.shape[:-1] + (d,), p.dtype),
                             p[..., :-d]], axis=-1)
        p = xp.where(xp.asarray(mask), p + sh, p)
    return p


def seg_sums(p, edges: tuple, xp):
    """[..., n] -> [..., S] per-segment sums (fixed-tree arithmetic): the
    scan, then each segment's last element by a static index."""
    stages, ends = _seg_tables_from_edges(edges)
    s = seg_scan(p, stages, xp)
    return s[..., ends]


def seg_sums_clamped(p, edges: tuple, xp, select=None):
    """seg_sums for edge lists that may contain ZERO-WIDTH segments
    (unified band layouts): their end index is clamped into range and the
    caller masks the (meaningless) selected value to 0.

    `select(scanned, ends) -> [..., S]` may replace the static index
    (pure data movement, no rounding)."""
    stages, ends = _seg_tables_from_edges(edges)
    s = seg_scan(p, stages, xp)
    ends = np.maximum(ends, 0)
    if select is not None:
        return select(s, ends)
    return s[..., ends]


def groups_pe(band_e, band_t, width, xp):
    """Perceptual entropy of an EIGHT_SHORT frame: per-group fixed-tree
    totals folded left-to-right over the 8 groups (one add per group, in
    group order — the sequence the spec's per-group loop performs).
    band_e/band_t: [..., 8, nbs]."""
    g = band_pe(band_e, band_t, width, xp)      # [..., 8]
    pe = g[..., 0]
    for i in range(1, g.shape[-1]):
        pe = pe + g[..., i]
    return pe


def tree_sum(v, xp):
    """Fixed pairwise-tree sum along the last axis (padded to a power of
    two with exact zeros): deterministic reduction for pe totals."""
    n = v.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        v = xp.concatenate(
            [v, xp.zeros(v.shape[:-1] + (m - n,), v.dtype)], axis=-1)
    while m > 1:
        h = m // 2
        v = v[..., :h] + v[..., h:m]
        m = h
    return v[..., 0]


# ---------------------------------------------------------------------------
# Real FFT via the half-size complex transform (fixed sequence)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _rfft_tables(n: int):
    """Untwist twiddles for the n-point real FFT (n even): W_k =
    e^{-i pi k / (n/2)}, k = 0..n/2-1, f32 from f64."""
    h = n // 2
    k = np.arange(h, dtype=np.float64)
    ang = -np.pi * k / h
    return np.cos(ang).astype(F32), np.sin(ang).astype(F32)


def rfft_power(w, xp):
    """[..., n] real f32 -> [..., n/2] power spectrum bins 0..n/2-1.

    z[m] = w[2m] + i*w[2m+1]; Z = FFT_{n/2}(z); bins via the standard
    untwist X[k] = A[k] + W_k * B[k] with A = (Z[k]+conj(Z[-k]))/2,
    B = -i (Z[k]-conj(Z[-k]))/2 — every multiply/add a pinned single op.
    Returns |X[k]|^2 (two multiplies + one add per bin).
    """
    h = w.shape[-1] // 2
    zr = w[..., 0::2]
    zi = w[..., 1::2]
    ar, ai = xmath_np.fft_dif(zr, zi, xp)
    # Z[-k]: index (h - k) mod h = [0, h-1, h-2, ..., 1]
    br = xp.concatenate([ar[..., :1], ar[..., :0:-1]], axis=-1)
    bi = xp.concatenate([ai[..., :1], ai[..., :0:-1]], axis=-1)
    # A = (Z + conj(Zr))/2 ; B = -i(Z - conj(Zr))/2
    a_re = (ar + br) * F32(0.5)
    a_im = (ai - bi) * F32(0.5)
    b_re = (ai + bi) * F32(0.5)
    b_im = (br - ar) * F32(0.5)
    cr, ci = _rfft_tables(2 * h)
    x_re = a_re + (b_re * xp.asarray(cr) - b_im * xp.asarray(ci))
    x_im = a_im + (b_re * xp.asarray(ci) + b_im * xp.asarray(cr))
    return x_re * x_re + x_im * x_im


# ---------------------------------------------------------------------------
# Static tables for the psycho chain
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def hann(n: int) -> np.ndarray:
    """Analysis window constants (f32 roundings of the f64 values)."""
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(F32)


@functools.lru_cache(maxsize=None)
def psy_tables(fs: int, long_block: bool):
    """All constants of the normative psycho chain for one block family.

    Partitions and scale-factor bands are CONTIGUOUS bin ranges (bark is
    monotone in frequency), so both reductions are segmented sums."""
    n_bins = C.LONG_COEFFS if long_block else C.SHORT_COEFFS
    pt = T.psy_tables(fs, n_bins)
    part_of_bin = np.argmax(pt["part_mat"], axis=1)
    assert (np.diff(part_of_bin) >= 0).all(), "partitions not contiguous"
    npart = pt["npart"]
    part_edges = tuple(
        int(v) for v in np.concatenate(
            [[0], np.searchsorted(part_of_bin, np.arange(npart), "right")]))
    edges = T.sfb_long(fs) if long_block else T.sfb_short(fs)
    band_edges = tuple(int(v) for v in edges)
    counts = pt["part_mat"].sum(axis=0)
    pb = T.part_to_band_min_mat(fs, long_block)
    fs_sine_p = (n_bins * 0.5) ** 2
    return {
        "hann": hann(2 * n_bins),
        "part_edges": part_edges,
        "band_edges": band_edges,
        "spread_rows": pt["spread"].astype(F32),         # [NP, NP]
        "inv_counts": (1.0 / counts).astype(F32),        # [NP], f64->f32
        "ath_part": (pt["ath_energy"] * fs_sine_p).astype(F32),
        "pb_mask": (pb > 0),                             # [NP, nb]
        "width": (edges[1:] - edges[:-1]).astype(F32),   # [nb]
        "nb": len(edges) - 1,
        "npart": int(npart),
    }


SFM_FLOOR_REL = F32(1e-12)
TMN_DB = F32(18.0)
NMT_DB = F32(6.0)
_SIMPLE_FACTOR = F32(10.0 ** (-12.0 / 10.0))
# divide-free chain constants (f32 roundings of the f64 values)
_TEN_LOG10_2 = F32(10.0 * 0.3010299956639812)   # sfm_db per log2 unit
_INV_NEG60 = F32(-1.0 / 60.0)
_NEG_L210_10 = F32(-3.321928094887362 / 10.0)   # exp2 arg per offset dB
_HALF = F32(0.5)


def spread_apply(e_part, rows: np.ndarray, xp):
    """Spreading convolution as a fixed-order sum over masker partitions:
    out = sum_i e[..., i] * rows[i, :], evaluated i = 0..NP-1 with one
    multiply and one add per term (no matmul, no reduction-order freedom).
    """
    npart = rows.shape[0]
    out = e_part[..., 0:1] * xp.asarray(rows[0])
    for i in range(1, npart):
        out = out + e_part[..., i:i + 1] * xp.asarray(rows[i])
    return out


def block_thresholds(p, cst, full_psycho: bool, xp):
    """Power spectrum [..., bins] -> (band_threshold[..., nb],
    band_energy[..., nb]). The normative rev-4 chain.

    DIVIDE-FREE: every division of the classic formulation is either a
    multiply by a once-rounded constant reciprocal (counts are static
    tables) or moved to the log2 domain (the tonality ratio)."""
    p = xp.maximum(p, SFM_FLOOR_REL * xp.max(p, axis=-1, keepdims=True))
    e_part = seg_sums(p, cst["part_edges"], xp)
    inv_counts = xp.asarray(cst["inv_counts"])
    if full_psycho:
        spread_e = spread_apply(e_part, cst["spread_rows"], xp)
        # spectral flatness in the log2 domain: log2(geo) - log2(arith)
        lg_geo = seg_sums(xlog2(p + TINY, xp), cst["part_edges"],
                          xp) * inv_counts
        lg_arith = xlog2(e_part * inv_counts + TINY, xp)
        sfm_db = xp.minimum(_TEN_LOG10_2 * (lg_geo - lg_arith), F32(0.0))
        alpha = xp.minimum(sfm_db * _INV_NEG60, F32(1.0))
        t1 = alpha * TMN_DB
        t2 = F32(1.0) - alpha
        offset_db = t1 + t2 * NMT_DB
        t_part = spread_e * xexp2(offset_db * _NEG_L210_10, xp)
    else:
        t_part = e_part * _SIMPLE_FACTOR
    t_part = xp.maximum(t_part, xp.asarray(cst["ath_part"]))
    t_density = t_part * inv_counts
    big = F32(1e30)
    dens = xp.where(xp.asarray(cst["pb_mask"]), t_density[..., :, None], big)
    band_t = xp.min(dens, axis=-2) * xp.asarray(cst["width"])   # exact min
    band_e = seg_sums(p, cst["band_edges"], xp)
    return band_t, band_e


def band_pe(band_e, band_t, width, xp):
    """Perceptual entropy of one band set: fixed-tree total of
    width * log2(1 + sqrt(e/t)), the ratio's sqrt evaluated in the log2
    domain (exp2(0.5*(log2(e+TINY) - log2(t+TINY)))) so no divide or
    backend sqrt appears."""
    s = xexp2(_HALF * (xlog2(band_e + TINY, xp) - xlog2(band_t + TINY, xp)),
              xp)
    v = xp.asarray(width) * xlog2(F32(1.0) + s, xp)
    return tree_sum(v, xp)


# ---------------------------------------------------------------------------
# Transient detection (R5) — pinned arithmetic
# ---------------------------------------------------------------------------

ATTACK_RATIO = F32(10.0)
ATTACK_ABS = F32(1e-4)
ATTACK_EPS = F32(1e-12)
N_SUB = 16
_SUB_EDGES = tuple(range(0, C.LONG_SIZE + 1, C.LONG_SIZE // N_SUB))
# EPS folded into the prefix NUMERATOR so no multiply ever feeds an add:
# prefix_mean + EPS == (csum_i + EPS*i) * (1/i), with EPS*i and 1/i
# rounded once from float64
_EPS_I = np.asarray([1e-12 * i for i in range(1, N_SUB)], np.float64
                    ).astype(F32)
_INV_I = np.asarray([1.0 / i for i in range(1, N_SUB)], np.float64
                    ).astype(F32)


def transient_detect(frames, xp):
    """[..., 2048] f32 -> [...] bool attack flags; pinned arithmetic.

    d = in-frame first difference (subs, exact); e = 16 sub-block energies
    of d^2 via the segmented scan tree; prefix sums by a Hillis-Steele
    ladder (adds only); threshold compare with the EPS folded into the
    numerator (no multiply result ever feeds an add).
    """
    fr = frames
    d = xp.concatenate(
        [xp.zeros_like(fr[..., :1]), fr[..., 1:] - fr[..., :-1]], axis=-1)
    e = seg_sums(d * d, _SUB_EDGES, xp)
    csum = e
    for step in (1, 2, 4, 8):
        sh = xp.concatenate(
            [xp.zeros(e.shape[:-1] + (step,), e.dtype),
             csum[..., :-step]], axis=-1)
        csum = csum + sh
    pm = (csum[..., :-1] + xp.asarray(_EPS_I)) * xp.asarray(_INV_I)
    thr = pm * ATTACK_RATIO
    attack = (e[..., 1:] > thr) & (e[..., 1:] > ATTACK_ABS)
    return attack.any(axis=-1)


def allowed_noise(e_mdct, e_full, t_full, xp):
    """Per-band permitted noise energy: e_mdct / SMR with
    SMR = clip(e_full/(t_full+TINY), SMR_FLOOR, SMR_CEIL), evaluated
    divide-free as e_mdct * exp2(clip(log2(t+TINY) - log2(e+TINY),
    log2(1/CEIL), log2(1/FLOOR)))."""
    inv_log = xlog2(t_full + TINY, xp) - xlog2(e_full + TINY, xp)
    inv_log = xp.clip(inv_log, _LOG2_INV_SMR_CEIL, _LOG2_INV_SMR_FLOOR)
    return e_mdct * xexp2(inv_log, xp)


SMR_FLOOR = F32(1e-3)
SMR_CEIL = F32(1e12)
_LOG2_INV_SMR_CEIL = F32(np.log2(1e-12))
_LOG2_INV_SMR_FLOOR = F32(np.log2(1e3))
