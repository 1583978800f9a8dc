"""Numeric tables for the MRC1 codec (the port's own copy).

Everything here is generated deterministically (integer-weight Huffman,
closed-form windows/filter tables). This is a copy of the JAX package's
`tables.py` (less three helpers the port does not use: `dct_iv_matrix`,
`band_matrix`, `_build_codebook_cached`), kept so the port imports
nothing of that package;
tests/test_torch_primitives.py holds every table bitwise equal to the
JAX package's (`tables_as_numpy`).

Covers reference components (SURVEY.md §2): R3 windows, R6 scale-factor
bands, R7 psychoacoustic constants (partitions / spreading / ATH), and the
R12 Huffman codebooks.
"""
from __future__ import annotations

import functools
import heapq

import numpy as np

from . import config as C

# ---------------------------------------------------------------------------
# Windows (R3)
# ---------------------------------------------------------------------------


def _sine_window(n: int) -> np.ndarray:
    """Sine window of length n (Princen-Bradley compliant)."""
    k = np.arange(n, dtype=np.float64)
    return np.sin(np.pi / n * (k + 0.5))


def _kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    """Kaiser-Bessel derived window of length n (power complementary)."""
    half = n // 2
    kais = np.kaiser(half + 1, alpha * np.pi)
    csum = np.cumsum(kais)
    w_half = np.sqrt(csum[:half] / csum[half])
    return np.concatenate([w_half, w_half[::-1]])


@functools.lru_cache(maxsize=None)
def window_halves(kind: str = "sine"):
    """(long_rise, long_fall, short_rise, short_fall) float64 arrays."""
    fn = _sine_window if kind == "sine" else _kbd_window
    wl = fn(2 * C.LONG_COEFFS)
    ws = fn(2 * C.SHORT_COEFFS)
    return (
        wl[: C.LONG_COEFFS],
        wl[C.LONG_COEFFS:],
        ws[: C.SHORT_COEFFS],
        ws[C.SHORT_COEFFS:],
    )


@functools.lru_cache(maxsize=None)
def long_windows(kind: str = "sine") -> np.ndarray:
    """[5, LONG_SIZE] float64: composed long window per block type.

    Index = block type. The SHORT row is unused by the long path (zeros);
    short frames are windowed per sub-block with `short_window`.
    LONG      = [rise1024 | fall1024]
    START     = [rise1024 | ones448 fall128 zeros448]
    STOP      = [zeros448 rise128 ones448 | fall1024]
    STARTSTOP = short edges on both sides.
    """
    lr, lf, sr, sf = window_halves(kind)
    z = np.zeros(C.SHORT_OFFSET)
    o = np.ones(C.SHORT_OFFSET)
    long_left = lr
    long_right = lf
    short_left = np.concatenate([z, sr, o])
    short_right = np.concatenate([o, sf, z])
    w = np.zeros((C.N_BLOCK_TYPES, C.LONG_SIZE))
    w[C.LONG] = np.concatenate([long_left, long_right])
    w[C.START] = np.concatenate([long_left, short_right])
    w[C.STOP] = np.concatenate([short_left, long_right])
    w[C.STARTSTOP] = np.concatenate([short_left, short_right])
    return w


@functools.lru_cache(maxsize=None)
def short_window(kind: str = "sine") -> np.ndarray:
    """[SHORT_SIZE] float64 sine/KBD window for every short sub-block."""
    _, _, sr, sf = window_halves(kind)
    return np.concatenate([sr, sf])


# ---------------------------------------------------------------------------
# Bark scale helpers (R6/R7)
# ---------------------------------------------------------------------------


def bark(f_hz: np.ndarray) -> np.ndarray:
    f = np.asarray(f_hz, dtype=np.float64)
    return 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)


def _ath_db(f_hz: np.ndarray) -> np.ndarray:
    """Absolute threshold in quiet, dB SPL (Terhardt)."""
    f = np.maximum(np.asarray(f_hz, dtype=np.float64), 20.0) / 1000.0
    return (3.64 * f ** -0.8
            - 6.5 * np.exp(-0.6 * (f - 3.3) ** 2)
            + 1e-3 * f ** 4)


# ---------------------------------------------------------------------------
# Scale-factor bands (R6)
# ---------------------------------------------------------------------------


def _make_sfb_edges(n_bins: int, fs: int, bark_width: float, min_bins: int) -> np.ndarray:
    """Greedy bark-proportional band edges; every edge a multiple of 4 bins."""
    binf = (np.arange(n_bins + 1)) * (fs / 2.0) / n_bins   # bin edge freqs
    binz = bark(binf)
    edges = [0]
    i = 0
    while i < n_bins:
        j = i + min_bins
        while j < n_bins and (binz[j] - binz[i]) < bark_width:
            j += 4
        j = min(j, n_bins)
        if n_bins - j < min_bins:      # absorb a too-small tail band
            j = n_bins
        edges.append(j)
        i = j
    return np.asarray(edges, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def sfb_long(fs: int) -> np.ndarray:
    """Long-block scale-factor band edges [n_sfb+1] for sample rate fs."""
    return _make_sfb_edges(C.LONG_COEFFS, fs, bark_width=0.55, min_bins=4)


@functools.lru_cache(maxsize=None)
def sfb_short(fs: int) -> np.ndarray:
    """Short-block scale-factor band edges [n_sfb+1] for sample rate fs."""
    return _make_sfb_edges(C.SHORT_COEFFS, fs, bark_width=1.2, min_bins=4)


@functools.lru_cache(maxsize=None)
def unified_layout(fs: int):
    """Uniform per-frame band layout shared by long and short frames.

    Every frame, regardless of block type, exposes NB scale-factor bands over
    its 1024-coefficient vector (short frames store coefficients group-major:
    coeff[g*128 + k]). Long-family types use the long SFB edges padded with
    zero-width bands; SHORT uses the 8 groups' short edges concatenated.
    This keeps every downstream stage (psycho mapping, RD loop, entropy
    coding) shape-static for XLA (SURVEY.md §7 step 2).

    Returns dict:
      nb          int, number of unified bands (= max(nb_long, 8*nb_short))
      nb_long     int, real long bands
      nb_short    int, short bands per group
      edges       [N_BLOCK_TYPES, nb+1] int32 band edges into the 1024 space
      bin_band    [N_BLOCK_TYPES, LONG_COEFFS] int32 band index of each bin
      width       [N_BLOCK_TYPES, nb] int32 band widths
      group_of    [N_BLOCK_TYPES, nb] int32 short group id (0 for long types)
    """
    el = sfb_long(fs)
    es = sfb_short(fs)
    nb_long = len(el) - 1
    nb_short = len(es) - 1
    nb = max(nb_long, C.N_SHORT * nb_short)

    edges = np.zeros((C.N_BLOCK_TYPES, nb + 1), dtype=np.int32)
    group_of = np.zeros((C.N_BLOCK_TYPES, nb), dtype=np.int32)
    long_edges = np.concatenate(
        [el, np.full(nb - nb_long, C.LONG_COEFFS, dtype=np.int32)])
    short_concat = [0]
    for g in range(C.N_SHORT):
        short_concat.extend((g * C.SHORT_COEFFS + es[1:]).tolist())
    short_edges = np.asarray(short_concat, dtype=np.int32)
    short_edges = np.concatenate(
        [short_edges, np.full(nb - C.N_SHORT * nb_short, C.LONG_COEFFS,
                              dtype=np.int32)])
    for bt in range(C.N_BLOCK_TYPES):
        if bt == C.SHORT:
            edges[bt] = short_edges
            group_of[bt, :C.N_SHORT * nb_short] = np.repeat(
                np.arange(C.N_SHORT), nb_short)
        else:
            edges[bt] = long_edges

    width = (edges[:, 1:] - edges[:, :-1]).astype(np.int32)
    bin_band = np.zeros((C.N_BLOCK_TYPES, C.LONG_COEFFS), dtype=np.int32)
    for bt in range(C.N_BLOCK_TYPES):
        bin_band[bt] = np.searchsorted(edges[bt], np.arange(C.LONG_COEFFS),
                                       side="right") - 1
    # [N_BLOCK_TYPES, LONG_COEFFS, nb] 0/1 float32 membership, for float
    # band reductions as (MXU-friendly) matmuls. Float sums must NOT use a
    # cumsum-at-edges trick: subtracting two large running sums cancels
    # catastrophically for low-energy bands.
    band_mask = np.zeros((C.N_BLOCK_TYPES, C.LONG_COEFFS, nb),
                         dtype=np.float32)
    for bt in range(C.N_BLOCK_TYPES):
        band_mask[bt, np.arange(C.LONG_COEFFS), bin_band[bt]] = 1.0
    # tuple-granular membership (pairs / 4-tuples never straddle bands
    # because all edges are multiples of 4)
    mask2 = band_mask[:, ::2, :].copy()
    mask4 = band_mask[:, ::4, :].copy()
    return {
        "nb": nb, "nb_long": nb_long, "nb_short": nb_short,
        "edges": edges, "bin_band": bin_band, "width": width,
        "group_of": group_of, "band_mask": band_mask,
        "mask2": mask2, "mask4": mask4,
    }


# ---------------------------------------------------------------------------
# Psychoacoustic constants (R7): partitions, spreading, ATH
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def psy_tables(fs: int, n_bins: int):
    """Psychoacoustic tables for an FFT with `n_bins` positive-freq bins.

    Returns a dict of float64 arrays:
      part_mat   [n_bins, NP]  bin->partition 0/1 membership
      spread     [NP, NP]      row-normalized spreading matrix (masker row i
                               spreads to maskee col j)
      ath_energy [NP]          absolute threshold in quiet, linear energy per
                               partition (full scale sine == 96 dB SPL)
      part_bark  [NP]          partition center bark
      npart      int
    """
    freqs = (np.arange(n_bins) + 0.5) * (fs / 2.0) / n_bins
    z = bark(freqs)
    width = 1.0 / 3.0 if n_bins >= 512 else 1.0
    part_idx = np.minimum((z / width).astype(np.int64),
                          int(z[-1] / width))
    # compress to consecutive ids
    uniq = np.unique(part_idx)
    remap = {u: i for i, u in enumerate(uniq)}
    part_idx = np.asarray([remap[p] for p in part_idx], dtype=np.int64)
    npart = int(part_idx.max()) + 1

    part_mat = np.zeros((n_bins, npart))
    part_mat[np.arange(n_bins), part_idx] = 1.0

    counts = part_mat.sum(axis=0)
    part_bark = (part_mat.T @ z) / counts

    dz = part_bark[None, :] - part_bark[:, None]     # maskee - masker
    # Schroeder spreading function (dB)
    s_db = 15.81 + 7.5 * (dz + 0.474) - 17.5 * np.sqrt(1.0 + (dz + 0.474) ** 2)
    s_db = np.maximum(s_db, -100.0)
    spread = 10.0 ** (s_db / 10.0)
    # Normalize each masker row to unit total leaked energy so a flat
    # spectrum keeps its overall energy after spreading.
    spread /= spread.sum(axis=1, keepdims=True)

    # ATH: min over bins in partition; dB SPL -> linear with full-scale
    # sine = 96 dB SPL => energy 1.0 maps to 96 dB.
    ath_spl = _ath_db(freqs)
    big = 1e30
    ath_bin = 10.0 ** ((np.minimum(ath_spl, 96.0) - 96.0) / 10.0)
    per_part = np.where(part_mat > 0, ath_bin[:, None], big)
    ath_energy = per_part.min(axis=0) * counts   # per-partition total energy

    return {
        "part_mat": part_mat,
        "spread": spread,
        "ath_energy": ath_energy,
        "part_bark": part_bark,
        "npart": npart,
    }


@functools.lru_cache(maxsize=None)
def part_to_band_min_mat(fs: int, long_block: bool):
    """[NP, n_sfb] 0/1 matrix: partition overlaps scale-factor band.

    Used to take a conservative min over overlapping partitions when mapping
    partition thresholds to per-SFB thresholds.
    """
    n_bins = C.LONG_COEFFS if long_block else C.SHORT_COEFFS
    edges = sfb_long(fs) if long_block else sfb_short(fs)
    pt = psy_tables(fs, n_bins)
    part_of_bin = np.argmax(pt["part_mat"], axis=1)
    nb = len(edges) - 1
    m = np.zeros((pt["npart"], nb))
    for b in range(nb):
        parts = np.unique(part_of_bin[edges[b]:edges[b + 1]])
        m[parts, b] = 1.0
    return m


# ---------------------------------------------------------------------------
# Huffman codebooks (R12) — canonical, length-limited, integer weights
# ---------------------------------------------------------------------------


def _huffman_lengths(weights: np.ndarray) -> np.ndarray:
    """Code lengths via Huffman on integer weights, deterministic tie-break."""
    n = len(weights)
    if n == 1:
        return np.array([1], dtype=np.int32)
    heap = [(int(w), i, None) for i, w in enumerate(weights)]
    counter = n
    nodes = {}   # id -> (left_id, right_id)
    heapq.heapify(heap)
    while len(heap) > 1:
        w1, i1, _ = heapq.heappop(heap)
        w2, i2, _ = heapq.heappop(heap)
        nodes[counter] = (i1, i2)
        heapq.heappush(heap, (w1 + w2, counter, None))
        counter += 1
    lengths = np.zeros(counter, dtype=np.int32)
    root = heap[0][1]
    stack = [(root, 0)]
    while stack:
        nid, depth = stack.pop()
        if nid in nodes:
            l, r = nodes[nid]
            stack.append((l, depth + 1))
            stack.append((r, depth + 1))
        else:
            lengths[nid] = max(depth, 1)
    return lengths[:n]


def _limit_lengths(lengths: np.ndarray, maxlen: int) -> np.ndarray:
    """Clamp code lengths to maxlen and repair the Kraft sum (deterministic)."""
    l = np.minimum(lengths.astype(np.int64), maxlen)
    kraft = np.sum(2.0 ** (-l.astype(np.float64)))
    # Overfull tree: lengthen the shortest-of-the-longest codes until valid.
    order = np.argsort(l, kind="stable")
    while kraft > 1.0 + 1e-12:
        # find symbol with largest length < maxlen, break ties by symbol id
        cand = np.where(l < maxlen)[0]
        i = cand[np.argmax(l[cand])]
        kraft += 2.0 ** (-(l[i] + 1)) - 2.0 ** (-l[i])
        l[i] += 1
    del order
    return l.astype(np.int32)


def canonical_codes(lengths: np.ndarray):
    """Canonical Huffman codes for given lengths. Returns (codes u32, lengths)."""
    n = len(lengths)
    order = np.lexsort((np.arange(n), lengths))
    codes = np.zeros(n, dtype=np.uint32)
    code = 0
    prev_len = 0
    for sym in order:
        ln = int(lengths[sym])
        code <<= (ln - prev_len)
        codes[sym] = code
        code += 1
        prev_len = ln
    return codes, lengths.astype(np.int32)


def _two_sided_geometric_weights(vmax: int, r: float) -> np.ndarray:
    v = np.arange(-vmax, vmax + 1)
    p = r ** np.abs(v)
    w = np.maximum((p * (1 << 20)).astype(np.int64), 1)
    return w


class Codebook:
    """A canonical Huffman codebook over tuple symbols."""

    def __init__(self, codes, lengths, dim, vmin, vmax, signed):
        self.codes = codes            # [n_sym] uint32
        self.lengths = lengths        # [n_sym] int32
        self.dim = dim                # tuple size (2 or 4)
        self.vmin = vmin
        self.vmax = vmax
        self.signed = signed          # False => magnitudes + sign bits
        self.n_vals = vmax - vmin + 1

    def sym_index(self, tup: np.ndarray) -> np.ndarray:
        """Map [..., dim] tuple values to symbol indices (row-major)."""
        t = np.asarray(tup) - self.vmin
        idx = np.zeros(t.shape[:-1], dtype=np.int64)
        for d in range(self.dim):
            idx = idx * self.n_vals + t[..., d]
        return idx

    def sym_tuple(self, idx: np.ndarray) -> np.ndarray:
        out = np.zeros(np.shape(idx) + (self.dim,), dtype=np.int64)
        rem = np.asarray(idx, dtype=np.int64)
        for d in range(self.dim - 1, -1, -1):
            out[..., d] = rem % self.n_vals + self.vmin
            rem = rem // self.n_vals
        return out


def _build_codebook(dim, vmin, vmax, weights) -> Codebook:
    lengths = _limit_lengths(_huffman_lengths(weights), C.MAX_CODE_LEN)
    codes, lengths = canonical_codes(lengths)
    return Codebook(codes, lengths, dim, vmin, vmax, signed=(vmin < 0))


@functools.lru_cache(maxsize=None)
def spectrum_codebooks():
    """The three non-trivial spectrum codebooks (CB_SMALL, CB_MID, CB_ESC).

    CB_SMALL: 4-tuples of values in [-1,1]   (81 symbols, signed)
    CB_MID:   2-tuples of values in [-4,4]   (81 symbols, signed)
    CB_ESC:   2-tuples of magnitudes [0,16]  (289 symbols) + sign bits +
              escape coding for magnitudes >= 16 (see escape_len/esc coding)
    """
    # CB_SMALL: product of per-value probs p0=0.6, p±1=0.2
    p1 = np.array([0.2, 0.6, 0.2])
    w1 = np.ones((3,) * 4)
    for d in range(4):
        shape = [1] * 4
        shape[d] = 3
        w1 = w1 * p1.reshape(shape)
    w1 = np.maximum((w1.reshape(-1) * (1 << 22)).astype(np.int64), 1)
    cb1 = _build_codebook(4, -1, 1, tuple(w1.tolist()))

    # CB_MID: two-sided geometric r=0.45 per value
    p2 = 0.45 ** np.abs(np.arange(-4, 5))
    w2 = np.maximum(((p2[:, None] * p2[None, :]).reshape(-1) * (1 << 22))
                    .astype(np.int64), 1)
    cb2 = _build_codebook(2, -4, 4, tuple(w2.tolist()))

    # CB_ESC: geometric r=0.62 on magnitudes 0..16
    p3 = 0.62 ** np.arange(17, dtype=np.float64)
    w3 = np.maximum(((p3[:, None] * p3[None, :]).reshape(-1) * (1 << 22))
                    .astype(np.int64), 1)
    cb3 = _build_codebook(2, 0, 16, tuple(w3.tolist()))
    return cb1, cb2, cb3


@functools.lru_cache(maxsize=None)
def sf_codebook() -> Codebook:
    """Scale-factor delta codebook: deltas in [-60, 60], 1-tuples."""
    w = _two_sided_geometric_weights(C.SF_DELTA_MAX, 0.85)
    lengths = _limit_lengths(_huffman_lengths(w), C.MAX_CODE_LEN)
    codes, lengths = canonical_codes(lengths)
    return Codebook(codes, lengths, 1, -C.SF_DELTA_MAX, C.SF_DELTA_MAX,
                    signed=True)


@functools.lru_cache(maxsize=1)
def _escape_len_table() -> np.ndarray:
    """[QMAX+1] int64 escape-suffix lengths, built once with the exact
    integer formula (e = bit_length - 1 == floor(log2 m) for ints)."""
    m = np.arange(C.QMAX + 1, dtype=np.int64)
    e = np.zeros(C.QMAX + 1, dtype=np.int64)
    v = np.maximum(m, 1)
    while (v > 1).any():                      # e = floor(log2(m)), exact
        big = v > 1
        e += big
        v = np.where(big, v >> 1, v)
    return np.where(m >= C.ESC_MAG, 2 * e - 3, 0).astype(np.int32)


def escape_len(mag: np.ndarray) -> np.ndarray:
    """Bits for the escape suffix of magnitudes >= ESC_MAG (0 otherwise).

    Escape coding for m >= 16: let e = floor(log2(m)) (e >= 4). Emit
    (e - 4) one bits, a zero bit, then e bits of (m - 2^e).
    Total = 2e - 3 bits. Magnitudes are <= QMAX by the quantizer clamp,
    so this is one table lookup (the former per-element np.log2 was a
    spec-codec hotspot)."""
    m = np.abs(np.asarray(mag))
    return np.take(_escape_len_table(), m, mode="clip")


@functools.lru_cache(maxsize=None)
def code_arrays():
    """Flat codeword/length arrays for fast cost computation & packing.

    Returns dict with int32 lengths and uint32 codes:
      len_small[81]  codes_small[81]   CB_SMALL 4-tuple symbols
      len_mid[81]    codes_mid[81]     CB_MID 2-tuple symbols
      len_esc[289]   codes_esc[289]    CB_ESC magnitude-pair symbols
      len_sf[121]    codes_sf[121]     scale-factor delta symbols
    """
    cb1, cb2, cb3 = spectrum_codebooks()
    sfc = sf_codebook()
    return {
        "len_small": cb1.lengths.astype(np.int32),
        "codes_small": cb1.codes.astype(np.uint32),
        "len_mid": cb2.lengths.astype(np.int32),
        "codes_mid": cb2.codes.astype(np.uint32),
        "len_esc": cb3.lengths.astype(np.int32),
        "codes_esc": cb3.codes.astype(np.uint32),
        "len_sf": sfc.lengths.astype(np.int32),
        "codes_sf": sfc.codes.astype(np.uint32),
    }


@functools.lru_cache(maxsize=None)
def decode_table(which: str):
    """First-code canonical decode arrays for a codebook.

    Returns (min_len, max_len, first_code[L+1], first_sym[L+1], sym_order)
    such that a MSB-first reader can decode: accumulate bits; at length l,
    if code < first_code[l] + count[l] ... standard canonical decode:
      sym = sym_order[first_sym[l] + (code - first_code[l])]
    """
    if which == "sf":
        cb = sf_codebook()
    else:
        cb = spectrum_codebooks()["small mid esc".split().index(which)]
    lengths = cb.lengths
    n = len(lengths)
    order = np.lexsort((np.arange(n), lengths))
    max_len = int(lengths.max())
    min_len = int(lengths.min())
    first_code = np.zeros(max_len + 2, dtype=np.int64)
    first_sym = np.zeros(max_len + 2, dtype=np.int64)
    counts = np.bincount(lengths, minlength=max_len + 1)
    code = 0
    sym_pos = 0
    for l in range(1, max_len + 1):
        first_code[l] = code
        first_sym[l] = sym_pos
        code = (code + counts[l]) << 1
        sym_pos += counts[l]
    first_code[max_len + 1] = code
    return min_len, max_len, first_code, first_sym, order
