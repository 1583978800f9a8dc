"""Bit-exact psychoacoustics in PyTorch (normative arithmetic rev 4).

The PyTorch form of the JAX package's `xpsy.py`: the psycho chain is a
fixed sequence of single-rounded IEEE-754 f32 ops —

  * FFT: the radix-2 fixed-sequence FFT (real input via the half-size
    complex transform + fixed-op untwist); on the card it runs in the
    CUDA kernel of ops/kernels/fft_stages.py.
  * Segment sums (bins -> partitions/bands): a Hillis-Steele segmented
    prefix scan with STATIC masks, then a rounding-free selection of each
    segment's last element.
  * Spreading: an unrolled fixed-order sum over masker partitions.
  * Transcendentals: xlog2/xexp2/xsqrt as fixed sequences of single
    mul/add ops with an exponent/mantissa split through an int32 bitcast
    (`Tensor.view(torch.int32)`), coefficients rounded once from float64.

Traps this module avoids: library float reductions (`torch.sum`,
`cumsum`, `matmul`) pick their own order, so every float sum here is one
of the pinned trees (`seg_scan`, `tree_sum`, the fold in `groups_pe`);
`max`/`min` are exact. Every constant is the Python float of its f32
value (`f32`), so a tensor-scalar op rounds exactly as the spec's does.
Values are bitwise equal to the JAX package's `xpsy` with xp=np
(tests/test_torch_primitives.py).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from . import config as C
from . import tables as T

F32 = np.float32


def f32(v) -> float:
    """The float32 value of v as a Python float (exact in f32)."""
    return float(np.float32(v))


TINY = f32(1e-20)
LN2 = f32(0.6931471805599453)
LOG10_2 = f32(0.30102999566398120)
LOG2_10 = f32(3.321928094887362)
SQRT2 = f32(1.4142135623730951)
_EXP_K = tuple(f32(1.0 / v) for v in (5040.0, 720.0, 120.0, 24.0, 6.0,
                                     2.0, 1.0, 1.0))
_LOG2_P = tuple(f32(v) for v in (
    0.0,
    1.4426950216293335, -0.7213475704193115, 0.48089826107025146,
    -0.36067137122154236, 0.28854310512542725, -0.24054786562919617,
    0.2060815393924713, -0.17848600447177887, 0.15869304537773132,
    -0.15966284275054932, 0.15780037641525269, -0.08521182835102081))
RSQRT_P = tuple(f32(v) for v in (
    1.9494401216506958, -1.6151533126831055, 0.911236047744751,
    -0.2903306782245636, 0.04800727963447571, -0.003200492588803172))
_MIN_NORMAL = f32(2.0 ** -126)


def _bits_of(x):
    """float32 -> its int32 bit pattern (exact)."""
    return x.contiguous().view(torch.int32)


def _from_bits(i):
    """int32 bit pattern -> float32 (exact)."""
    return i.contiguous().view(torch.float32)


def xlog2(x):
    """Normative log2 for positive finite normal f32 inputs: exponent via
    integer bitcast, mantissa in [sqrt2/2, sqrt2), divide-free degree-12
    Horner in t = m - 1."""
    bits = _bits_of(x)
    e = (bits >> 23) - 127
    m = _from_bits((bits & 0x007FFFFF) | 0x3F800000)          # [1, 2)
    big = m >= SQRT2
    m = torch.where(big, m * 0.5, m)
    e = torch.where(big, e + 1, e)
    t = m - 1.0
    p = _LOG2_P[-1] * t + _LOG2_P[-2]
    for c in _LOG2_P[-3::-1]:
        p = p * t + c
    return e.to(torch.float32) + p


def xsqrt(x):
    """Normative sqrt for non-negative f32 inputs: even/odd exponent split
    (integer ops), polynomial 1/sqrt start on m in [1, 4), two Newton
    steps, s = m * r. Subnormal or zero inputs -> 0."""
    bits = _bits_of(x)
    eb = (bits >> 23) - 127
    odd = eb & 1
    m = _from_bits((bits & 0x007FFFFF) | 0x3F800000)          # [1, 2)
    m = torch.where(odd == 1, m * 2.0, m)                # [1, 4) exact
    e2 = (eb - odd) >> 1                                 # arithmetic shift
    r = RSQRT_P[-1] * m + RSQRT_P[-2]
    for c in RSQRT_P[-3::-1]:
        r = r * m + c
    for _ in range(2):
        mr = m * r
        h = mr * r
        w = 1.5 - 0.5 * h
        r = r * w
    s = m * r
    scale = _from_bits((e2 + 127) << 23)                       # 2^(e/2) exact
    return torch.where(x < _MIN_NORMAL, 0.0, s * scale)


def xexp2(x):
    """Normative 2^x for f32 inputs in the psycho range (|x| < 126):
    k = round-half-even(x), f = x - k exact, Taylor-Horner exp(f*ln2),
    scale by 2^k via integer bitcast."""
    k = torch.round(x).to(torch.int32).clamp(-126, 126)
    f = x - k.to(torch.float32)
    c = f * LN2
    p = _EXP_K[0] * c + _EXP_K[1]
    for kk in _EXP_K[2:]:
        p = p * c + kk
    return p * _from_bits((k + 127) << 23)


def xlog10(x):
    return xlog2(x) * LOG10_2


def xpow10(x):
    return xexp2(x * LOG2_10)


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


@functools.lru_cache(maxsize=None)
def _dev_seg_tables(edges: tuple, device: str):
    stages, ends = _seg_tables_from_edges(edges)
    return (tuple((d, torch.from_numpy(m).to(device)) for d, m in stages),
            torch.from_numpy(np.maximum(ends, 0)).to(device))


def seg_scan(p, stages):
    """Segmented inclusive prefix sum along the last axis: after the scan,
    position i holds sum(p[seg_start(i) : i+1]) — a fixed balanced-tree
    op DAG (log2(max_width) stages of shifted adds)."""
    for d, mask in stages:
        sh = torch.cat([p.new_zeros(p.shape[:-1] + (d,)), p[..., :-d]],
                       dim=-1)
        p = torch.where(mask, p + sh, p)
    return p


def seg_sums(p, edges: tuple):
    """[..., n] -> [..., S] per-segment sums (fixed-tree arithmetic).

    Edge lists may hold ZERO-WIDTH segments (unified band layouts): their
    end index is clamped into range and the caller masks the
    (meaningless) selected value to 0."""
    stages, ends = _dev_seg_tables(edges, str(p.device))
    return seg_scan(p, stages)[..., ends]


def groups_pe(band_e, band_t, width):
    """Perceptual entropy of an EIGHT_SHORT frame: per-group fixed-tree
    totals folded left-to-right over the 8 groups."""
    g = band_pe(band_e, band_t, width)            # [..., 8]
    pe = g[..., 0]
    for i in range(1, g.shape[-1]):
        pe = pe + g[..., i]
    return pe


def tree_sum(v):
    """Fixed pairwise-tree sum along the last axis (padded to a power of
    two with exact zeros)."""
    n = v.shape[-1]
    m = 1
    while m < n:
        m *= 2
    if m != n:
        v = torch.cat([v, v.new_zeros(v.shape[:-1] + (m - n,))], dim=-1)
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


@functools.lru_cache(maxsize=None)
def _dev_rfft(n: int, device: str):
    cr, ci = _rfft_tables(n)
    return torch.from_numpy(cr).to(device), torch.from_numpy(ci).to(device)


def rfft_pre(w):
    """The real FFT's input as the half-size complex transform's:
    z[m] = w[2m] + i*w[2m+1]. [..., n] -> (zr, zi) [..., n/2]."""
    return w[..., 0::2].contiguous(), w[..., 1::2].contiguous()


def rfft_untwist_power(ar, ai):
    """Z = FFT_{n/2}(z) [..., n/2] -> the power spectrum bins 0..n/2-1:
    X[k] = A[k] + W_k * B[k] with A = (Z[k]+conj(Z[-k]))/2,
    B = -i (Z[k]-conj(Z[-k]))/2 — every multiply/add a pinned single op."""
    h = ar.shape[-1]
    # Z[-k]: index (h - k) mod h = [0, h-1, h-2, ..., 1]
    br = torch.cat([ar[..., :1], torch.flip(ar[..., 1:], [-1])], dim=-1)
    bi = torch.cat([ai[..., :1], torch.flip(ai[..., 1:], [-1])], dim=-1)
    a_re = (ar + br) * 0.5
    a_im = (ai - bi) * 0.5
    b_re = (ai + bi) * 0.5
    b_im = (br - ar) * 0.5
    cr, ci = _dev_rfft(2 * h, str(ar.device))
    x_re = a_re + (b_re * cr - b_im * ci)
    x_im = a_im + (b_re * ci + b_im * cr)
    return x_re * x_re + x_im * x_im


def rfft_power(w):
    """[..., n] real f32 -> [..., n/2] power spectrum bins 0..n/2-1:
    `rfft_pre`, the FFT, `rfft_untwist_power`. The FFT is
    `fft_stages.fft`: K1 on the card, the plain `xmath.fft_dif` for a CPU
    tensor."""
    from .ops.kernels import fft_stages      # it imports xmath
    return rfft_untwist_power(*fft_stages.fft(*rfft_pre(w)))


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


@functools.lru_cache(maxsize=None)
def dev_psy_tables(fs: int, long_block: bool, device: str):
    """psy_tables with its arrays as tensors on `device`."""
    cst = psy_tables(fs, long_block)
    out = dict(cst)
    for k in ("hann", "spread_rows", "inv_counts", "ath_part", "pb_mask",
              "width"):
        out[k] = torch.from_numpy(np.ascontiguousarray(cst[k])).to(device)
    return out


SFM_FLOOR_REL = f32(1e-12)
TMN_DB = f32(18.0)
NMT_DB = f32(6.0)
_SIMPLE_FACTOR = f32(10.0 ** (-12.0 / 10.0))
_TEN_LOG10_2 = f32(10.0 * 0.3010299956639812)   # sfm_db per log2 unit
_INV_NEG60 = f32(-1.0 / 60.0)
_NEG_L210_10 = f32(-3.321928094887362 / 10.0)   # exp2 arg per offset dB
BIG = f32(1e30)


def _stage_count(edges: tuple) -> int:
    """The stages of `seg_scan` over these edges (shifts 1, 2, 4, ...
    below the widest segment)."""
    return len(_seg_tables_from_edges(edges)[0])


@functools.lru_cache(maxsize=None)
def kernel_blobs(fs: int, long_block: bool):
    """(f32 blob, i32 blob) of one block family for the analysis kernels
    (csrc/analysis_pre.cu reads hann, csrc/psycho.cu the rest).

    The layout of the JAX package's `xpsy.ffi_blobs` (its native kernel's,
    native/xpsy_ffi.cpp) without the FFT stage twiddles, which K1 holds;
    derived here from this module's own `psy_tables`:
      i32: n, h, npart, nb, part stages, band stages, groups (1 or 8),
           SHORT_OFFSET, then part_seg_start [h], part_ends [npart],
           band_seg_start [h], band_ends [nb], pb_mask [npart * nb]
      f32: hann [n], untwist cr [h], ci [h], spread [npart * npart],
           inv_counts [npart], ath [npart], width [nb]
    """
    cst = psy_tables(fs, long_block)
    h = C.LONG_COEFFS if long_block else C.SHORT_COEFFS
    cr, ci = _rfft_tables(2 * h)
    npart, nb = cst["npart"], cst["nb"]

    def seg_start_of(edges):
        e = np.asarray(edges, np.int64)
        out = np.zeros(h, np.int32)
        for s in range(len(e) - 1):
            out[e[s]:e[s + 1]] = e[s]
        return out

    pe_ = np.asarray(cst["part_edges"], np.int64)
    be_ = np.asarray(cst["band_edges"], np.int64)
    i32 = np.concatenate([
        np.asarray([2 * h, h, npart, nb, _stage_count(cst["part_edges"]),
                    _stage_count(cst["band_edges"]),
                    1 if long_block else C.N_SHORT, C.SHORT_OFFSET],
                   np.int32),
        seg_start_of(pe_), (pe_[1:] - 1).astype(np.int32),
        seg_start_of(be_), (be_[1:] - 1).astype(np.int32),
        cst["pb_mask"].astype(np.int32).reshape(-1),
    ]).astype(np.int32)
    f32_ = np.concatenate([
        cst["hann"], cr, ci, cst["spread_rows"].reshape(-1),
        cst["inv_counts"], cst["ath_part"], cst["width"],
    ]).astype(F32)
    return f32_, i32


SCHED_STAGES = 8        # seg_scan stages K8's lane tables hold, at most


@functools.lru_cache(maxsize=None)
def kernel_sched(fs: int, long_block: bool) -> np.ndarray:
    """i32 lane tables of one block family for K8 (csrc/psycho.cu), which
    runs a frame on one warp and its scans over the 1024 bins (group g's H
    bins at g * H) in registers, lane l holding bins 32 l + j; derived
    from `kernel_blobs`' i32 blob and `psy_tables`' pb_mask:
      part_take [8, 32], band_take [8, 32]: bit j of (stage st, lane l)
          is set where bin 32 l + j takes stage st of seg_scan over the
          partitions / bands (the bin 2^st below it lies in its segment)
      part_end [NP], band_end [nb]: each segment's last bin in its group
      band_lo [nb], band_hi [nb]: the partitions pb_mask maps to each
          band, a contiguous range lo .. hi (lo > hi where none)
    Offsets: 0, 256, 512, 512 + NP, 512 + NP + nb, 512 + NP + 2 nb."""
    _, i32 = kernel_blobs(fs, long_block)
    h, npart, nb = int(i32[1]), int(i32[2]), int(i32[3])
    groups = int(i32[6])
    o = 8
    part_start, o = i32[o:o + h], o + h
    part_ends, o = i32[o:o + npart], o + npart
    band_start, o = i32[o:o + h], o + h
    band_ends, o = i32[o:o + nb], o + nb
    pb = i32[o:o + npart * nb].reshape(npart, nb).astype(bool)
    k = np.arange(C.LONG_COEFFS)
    bitw = np.left_shift(np.int64(1), np.arange(32, dtype=np.int64))

    def lanes(bits):            # [1024] bool -> [32] i32: lane l, bit j
        v = (bits.reshape(32, 32).astype(np.int64) * bitw).sum(axis=1)
        return v.astype(np.uint32).view(np.int32)

    takes = []
    for start, stages in ((part_start, int(i32[4])),
                          (band_start, int(i32[5]))):
        if stages > SCHED_STAGES:
            raise ValueError(f"kernel_sched: {stages} scan stages at {fs} "
                             f"Hz, the kernel runs {SCHED_STAGES}")
        abs_start = np.concatenate([g * h + start for g in range(groups)])
        takes += [lanes((k - (1 << st) >= abs_start) & (st < stages))
                  for st in range(SCHED_STAGES)]
    lo = np.full(nb, 0, np.int64)
    hi = np.full(nb, -1, np.int64)
    for b in range(nb):
        idx = np.nonzero(pb[:, b])[0]
        if len(idx):
            if idx[-1] - idx[0] + 1 != len(idx):
                raise ValueError(f"kernel_sched: band {b} at {fs} Hz maps "
                                 f"to partitions that are not contiguous")
            lo[b], hi[b] = idx[0], idx[-1]
    return np.concatenate(takes + [part_ends, band_ends, lo, hi]).astype(
        np.int32)


def spread_apply(e_part, rows):
    """Spreading convolution as a fixed-order sum over masker partitions:
    out = sum_i e[..., i] * rows[i, :], evaluated i = 0..NP-1 with one
    multiply and one add per term (no matmul)."""
    out = e_part[..., 0:1] * rows[0]
    for i in range(1, rows.shape[0]):
        out = out + e_part[..., i:i + 1] * rows[i]
    return out


def block_thresholds(p, cst, full_psycho: bool):
    """Power spectrum [..., bins] -> (band_threshold[..., nb],
    band_energy[..., nb]). `cst` is dev_psy_tables(...). Divide-free."""
    p = torch.maximum(p, SFM_FLOOR_REL * p.amax(dim=-1, keepdim=True))
    e_part = seg_sums(p, cst["part_edges"])
    inv_counts = cst["inv_counts"]
    if full_psycho:
        spread_e = spread_apply(e_part, cst["spread_rows"])
        # spectral flatness in the log2 domain: log2(geo) - log2(arith)
        lg_geo = seg_sums(xlog2(p + TINY), cst["part_edges"]) * inv_counts
        lg_arith = xlog2(e_part * inv_counts + TINY)
        sfm_db = torch.clamp(_TEN_LOG10_2 * (lg_geo - lg_arith), max=0.0)
        alpha = torch.clamp(sfm_db * _INV_NEG60, max=1.0)
        t1 = alpha * TMN_DB
        t2 = 1.0 - alpha
        offset_db = t1 + t2 * NMT_DB
        t_part = spread_e * xexp2(offset_db * _NEG_L210_10)
    else:
        t_part = e_part * _SIMPLE_FACTOR
    t_part = torch.maximum(t_part, cst["ath_part"])
    t_density = t_part * inv_counts
    dens = torch.where(cst["pb_mask"], t_density[..., :, None], BIG)
    band_t = dens.amin(dim=-2) * cst["width"]                # exact min
    band_e = seg_sums(p, cst["band_edges"])
    return band_t, band_e


def band_pe(band_e, band_t, width):
    """Perceptual entropy of one band set: fixed-tree total of
    width * log2(1 + sqrt(e/t)), the ratio's sqrt evaluated in the log2
    domain (exp2(0.5*(log2(e+TINY) - log2(t+TINY))))."""
    s = xexp2(0.5 * (xlog2(band_e + TINY) - xlog2(band_t + TINY)))
    v = width * xlog2(1.0 + s)
    return tree_sum(v)


# ---------------------------------------------------------------------------
# Transient detection — pinned arithmetic shared with the spec
# ---------------------------------------------------------------------------

ATTACK_RATIO = f32(10.0)
ATTACK_ABS = f32(1e-4)
N_SUB = 16
_SUB_EDGES = tuple(range(0, C.LONG_SIZE + 1, C.LONG_SIZE // N_SUB))
# EPS folded into the prefix NUMERATOR: (csum_i + EPS*i) * (1/i), with
# EPS*i and 1/i rounded once from float64
_EPS_I = np.asarray([1e-12 * i for i in range(1, N_SUB)], np.float64
                    ).astype(F32)
_INV_I = np.asarray([1.0 / i for i in range(1, N_SUB)], np.float64
                    ).astype(F32)


@functools.lru_cache(maxsize=None)
def _dev_transient(device: str):
    return (torch.from_numpy(_EPS_I).to(device),
            torch.from_numpy(_INV_I).to(device))


def transient_detect(frames):
    """[..., 2048] f32 -> [...] bool attack flags; pinned arithmetic:
    in-frame first difference, 16 sub-block energies of d^2 via the
    segmented scan tree, Hillis-Steele prefix ladder, threshold compare
    with the EPS folded into the numerator."""
    fr = frames
    d = torch.cat([torch.zeros_like(fr[..., :1]), fr[..., 1:] - fr[..., :-1]],
                  dim=-1)
    e = seg_sums(d * d, _SUB_EDGES)
    csum = e
    for step in (1, 2, 4, 8):
        sh = torch.cat([e.new_zeros(e.shape[:-1] + (step,)),
                        csum[..., :-step]], dim=-1)
        csum = csum + sh
    eps_i, inv_i = _dev_transient(str(frames.device))
    pm = (csum[..., :-1] + eps_i) * inv_i
    thr = pm * ATTACK_RATIO
    attack = (e[..., 1:] > thr) & (e[..., 1:] > ATTACK_ABS)
    return attack.any(dim=-1)


_LOG2_INV_SMR_CEIL = f32(np.log2(1e-12))
_LOG2_INV_SMR_FLOOR = f32(np.log2(1e3))


def allowed_noise(e_mdct, e_full, t_full):
    """Per-band permitted noise energy, divide-free:
    e_mdct * exp2(clip(log2(t+TINY) - log2(e+TINY), log2(1/CEIL),
    log2(1/FLOOR)))."""
    inv_log = xlog2(t_full + TINY) - xlog2(e_full + TINY)
    inv_log = torch.clamp(inv_log, _LOG2_INV_SMR_CEIL, _LOG2_INV_SMR_FLOOR)
    return e_mdct * xexp2(inv_log)


@functools.lru_cache(maxsize=1)
def kernel_consts() -> np.ndarray:
    """The f32 constants of the analysis kernels' chains, in the order of
    `struct Consts` in csrc/xpsy_dev.cuh (this module's f32 roundings):
    TINY, LN2, SQRT2, the xlog2 coefficients [13], the xexp2 coefficients
    [8], SFM_FLOOR_REL, TMN_DB, NMT_DB, the simple-model factor,
    10 log10(2), -1/60, -log2(10)/10, BIG, log2(1/SMR_CEIL),
    log2(1/SMR_FLOOR), ATTACK_RATIO, ATTACK_ABS, EPS * i [15], 1 / i [15]."""
    return np.concatenate([
        [TINY, LN2, SQRT2], _LOG2_P, _EXP_K,
        [SFM_FLOOR_REL, TMN_DB, NMT_DB, _SIMPLE_FACTOR, _TEN_LOG10_2,
         _INV_NEG60, _NEG_L210_10, BIG, _LOG2_INV_SMR_CEIL,
         _LOG2_INV_SMR_FLOOR, ATTACK_RATIO, ATTACK_ABS],
        _EPS_I, _INV_I]).astype(F32)
