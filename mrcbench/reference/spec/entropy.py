"""Normative entropy coding: codebook selection, bit costing, symbols.

The port's copy of the JAX package's `spec/entropy.py`.

Reference component R12 + the bit-counting half of R9 (SURVEY.md §2).

Bitstream layout of one channel-frame's *content* (after the frame length
prefix, see spec/bitstream.py):
    [3  block_type]
    [8  global gain]
    [2  codebook id]            x real bands (block-type dependent count)
    [sf delta codeword]         x real bands (delta vs previous band's
                                exponent; band 0 vs the global gain)
    [payload codewords]         x real bands with cb_id > 0:
        CB_SMALL: one codeword per 4-tuple
        CB_MID:   one codeword per pair
        CB_ESC:   per pair: magnitude-pair codeword, then one sign bit per
                  nonzero value (in order), then escape suffix per value
                  with magnitude >= ESC_MAG (in order)

Everything here is exact integer arithmetic, so the JAX mirror
(mrcaudiocodec_tpu/ops/entropy.py) reproduces costs bit-for-bit.
"""
from __future__ import annotations

import numpy as np

import functools

from .. import config as C
from .. import tables as T

BIG = np.int32(1 << 24)


@functools.lru_cache(maxsize=1)
def _len_tables_i32():
    """int32 views of the codeword-length tables (all lengths fit int32;
    int64 cost tensors doubled the RD sweep's memory traffic)."""
    ca = T.code_arrays()
    return {k: np.ascontiguousarray(ca[k], dtype=np.int32)
            for k in ("len_small", "len_mid", "len_esc", "len_sf")}


def _tuple_sym_small(q4: np.ndarray) -> np.ndarray:
    """[..., 4] values in [-1,1] -> symbol index [0,81)."""
    t = q4 + 1
    return ((t[..., 0] * 3 + t[..., 1]) * 3 + t[..., 2]) * 3 + t[..., 3]


def _pair_sym_mid(q2: np.ndarray) -> np.ndarray:
    t = q2 + 4
    return t[..., 0] * 9 + t[..., 1]


def _pair_sym_esc(q2: np.ndarray) -> np.ndarray:
    m = np.minimum(np.abs(q2), C.ESC_MAG)
    return m[..., 0] * (C.ESC_MAG + 1) + m[..., 1]


def escape_bits(mag: np.ndarray) -> np.ndarray:
    """Escape suffix length per value (0 if |q| < ESC_MAG)."""
    return T.escape_len(mag)           # int32 table lookup (sign-safe)


def band_reduce(per_bin: np.ndarray, edges: np.ndarray, op=np.add) -> np.ndarray:
    """Reduce a per-bin array into bands given edges (handles empty bands)."""
    ext = np.concatenate([per_bin, np.zeros_like(per_bin[..., :1])], axis=-1)
    out = op.reduceat(ext, edges[:-1], axis=-1)
    empty = edges[1:] == edges[:-1]
    return np.where(empty, 0, out)


def payload_costs(q: np.ndarray, edges: np.ndarray):
    """Quantized frame(s) -> per-band payload bits under each codebook.

    q: [..., 1024] int, edges: [NB+1].
    Returns (costs[..., NB, 4] int64, valid[..., NB, 4] bool):
      costs[..., 0] = 0 (CB_ZERO), valid only if band all-zero
      costs[..., 1] = CB_SMALL bits, valid if band max |q| <= 1
      costs[..., 2] = CB_MID bits,   valid if band max |q| <= 4
      costs[..., 3] = CB_ESC bits,   always valid
    """
    lt = _len_tables_i32()
    aq = np.abs(q)

    sym1 = _tuple_sym_small(np.clip(q, -1, 1).reshape(q.shape[:-1] + (-1, 4)))
    bits1_t = np.take(lt["len_small"], sym1)                    # per 4-tuple
    sym2 = _pair_sym_mid(np.clip(q, -4, 4).reshape(q.shape[:-1] + (-1, 2)))
    bits2_t = np.take(lt["len_mid"], sym2)                      # per pair
    qp = q.reshape(q.shape[:-1] + (-1, 2))
    sym3 = _pair_sym_esc(qp)
    bits3_t = (np.take(lt["len_esc"], sym3)
               + (qp[..., 0] != 0) + (qp[..., 1] != 0)          # sign bits
               + escape_bits(qp[..., 0]) + escape_bits(qp[..., 1]))

    # Expand tuple costs back to per-bin (divided evenly) is lossy; instead
    # reduce per-tuple costs with tuple-granular edges (edges are multiples
    # of 4, so they are multiples of the tuple sizes).
    e4 = edges // 4
    e2 = edges // 2
    bits1 = band_reduce(bits1_t, e4)
    bits2 = band_reduce(bits2_t, e2)
    bits3 = band_reduce(bits3_t, e2)

    maxq = band_reduce(aq, edges, op=np.maximum)
    costs = np.stack([np.zeros_like(bits1), bits1, bits2, bits3], axis=-1)
    valid = np.stack([
        maxq == 0,
        maxq <= 1,
        maxq <= 4,
        np.ones_like(maxq, dtype=bool),
    ], axis=-1)
    return costs, valid


def choose_codebooks(q: np.ndarray, edges: np.ndarray, width: np.ndarray):
    """Select the cheapest valid codebook per band.

    Returns (cb[..., NB] int32, payload[..., NB] int64). Zero-width (padding)
    bands get cb=0, payload=0.
    """
    costs, valid = payload_costs(q, edges)
    masked = np.where(valid, costs, BIG)
    cb = np.argmin(masked, axis=-1).astype(np.int32)
    payload = np.take_along_axis(masked, cb[..., None].astype(np.int64),
                                 axis=-1)[..., 0]
    empty = width == 0
    cb = np.where(empty, 0, cb)
    payload = np.where(empty, 0, payload)
    return cb, payload


def sf_delta_bits(amp: np.ndarray, width: np.ndarray) -> np.ndarray:
    """Scale-factor delta bits for the full real-band chain.

    amp: [..., NB] int; width: [NB]. delta_b = amp_{b-1} - amp_b with
    amp_{-1} = 0 (i.e. band 0 delta is -amp_0 vs the global gain). Padding
    bands (width 0) are excluded from the chain.
    """
    lt = _len_tables_i32()
    real = width > 0
    a = np.where(real, amp, 0)
    prev = np.concatenate([np.zeros_like(a[..., :1]), a[..., :-1]], axis=-1)
    delta = prev - a
    bits = np.take(lt["len_sf"], delta + C.SF_DELTA_MAX)
    return np.where(real, bits, 0).sum(axis=-1)


def frame_content_bits(q, amp, edges, width) -> np.ndarray:
    """Total content bits of frame(s): type+gain+cb ids+sf deltas+payload."""
    cb, payload = choose_codebooks(q, edges, width)
    nreal = int((width > 0).sum())
    fixed = C.BLOCK_TYPE_BITS + C.GAIN_BITS + C.CB_BITS * nreal
    return fixed + sf_delta_bits(amp, width) + payload.sum(axis=-1)


# ---------------------------------------------------------------------------
# Symbol emission (encoder back-end) and parsing (decoder front-end)
# ---------------------------------------------------------------------------


def encode_frame_symbols(q: np.ndarray, amp: np.ndarray, gain: int,
                         block_type: int, fs: int):
    """One frame -> (codes uint32 list, lens list) ready for bit packing."""
    lay = T.unified_layout(fs)
    edges = lay["edges"][block_type]
    width = lay["width"][block_type]
    ca = T.code_arrays()
    cb, _ = choose_codebooks(q, edges, width)
    real = np.where(width > 0)[0]

    codes: list[int] = [block_type, int(gain)]
    lens: list[int] = [C.BLOCK_TYPE_BITS, C.GAIN_BITS]
    for b in real:
        codes.append(int(cb[b]))
        lens.append(C.CB_BITS)
    prev = 0
    for b in real:
        a = int(amp[b])
        delta = prev - a
        codes.append(int(ca["codes_sf"][delta + C.SF_DELTA_MAX]))
        lens.append(int(ca["len_sf"][delta + C.SF_DELTA_MAX]))
        prev = a
    for b in real:
        if cb[b] == C.CB_ZERO:
            continue
        lo, hi = int(edges[b]), int(edges[b + 1])
        vals = q[lo:hi]
        if cb[b] == C.CB_SMALL:
            syms = _tuple_sym_small(vals.reshape(-1, 4))
            for s in syms:
                codes.append(int(ca["codes_small"][s]))
                lens.append(int(ca["len_small"][s]))
        elif cb[b] == C.CB_MID:
            syms = _pair_sym_mid(vals.reshape(-1, 2))
            for s in syms:
                codes.append(int(ca["codes_mid"][s]))
                lens.append(int(ca["len_mid"][s]))
        else:
            pairs = vals.reshape(-1, 2)
            syms = _pair_sym_esc(pairs)
            for i, s in enumerate(syms):
                codes.append(int(ca["codes_esc"][s]))
                lens.append(int(ca["len_esc"][s]))
                for v in pairs[i]:
                    if v != 0:
                        codes.append(0 if v > 0 else 1)
                        lens.append(1)
                for v in pairs[i]:
                    m = abs(int(v))
                    if m >= C.ESC_MAG:
                        e = m.bit_length() - 1
                        # (e-4) ones, a zero, then e bits of (m - 2^e)
                        codes.append(((1 << (e - 4)) - 1) << 1)
                        lens.append(e - 3)
                        codes.append(m - (1 << e))
                        lens.append(e)
    return codes, lens


class _Bits:
    """Lightweight MSB-first cursor over a numpy bit array."""

    def __init__(self, bits: np.ndarray, pos: int = 0):
        self.bits = bits
        self.pos = pos

    def take(self, n: int) -> int:
        out = 0
        for b in self.bits[self.pos:self.pos + n]:
            out = (out << 1) | int(b)
        self.pos += n
        return out


def _decode_sym(cur: _Bits, which: str) -> int:
    min_len, max_len, first_code, first_sym, order = T.decode_table(which)
    code = cur.take(min_len)
    l = min_len
    counts_cache = _decode_counts(which)
    while True:
        idx = code - first_code[l]
        if 0 <= idx < counts_cache[l]:
            return int(order[first_sym[l] + idx])
        code = (code << 1) | cur.take(1)
        l += 1
        if l > max_len:
            raise ValueError("invalid Huffman code")


import functools


@functools.lru_cache(maxsize=None)
def _decode_counts(which: str):
    if which == "sf":
        cb = T.sf_codebook()
    else:
        cb = T.spectrum_codebooks()["small mid esc".split().index(which)]
    _, max_len, _, _, _ = T.decode_table(which)
    return np.bincount(cb.lengths, minlength=max_len + 2)


def decode_frame_content(cur: _Bits, fs: int):
    """Parse one channel-frame's content. Returns (q[1024], e_bin[1024],
    block_type, gain)."""
    lay = T.unified_layout(fs)
    block_type = cur.take(C.BLOCK_TYPE_BITS)
    if block_type >= C.N_BLOCK_TYPES:
        raise ValueError(f"invalid block type {block_type}")
    gain = cur.take(C.GAIN_BITS)
    edges = lay["edges"][block_type]
    width = lay["width"][block_type]
    real = np.where(width > 0)[0]
    cbs = {b: cur.take(C.CB_BITS) for b in real}
    amp = np.zeros(lay["nb"], dtype=np.int32)
    prev = 0
    cb1, cb2, cb3 = T.spectrum_codebooks()
    for b in real:
        delta = _decode_sym(cur, "sf") - C.SF_DELTA_MAX
        a = prev - delta
        amp[b] = a
        prev = a
    q = np.zeros(C.LONG_COEFFS, dtype=np.int32)
    for b in real:
        lo, hi = int(edges[b]), int(edges[b + 1])
        cbid = cbs[b]
        if cbid == C.CB_ZERO:
            continue
        if cbid == C.CB_SMALL:
            for t in range(lo, hi, 4):
                sym = _decode_sym(cur, "small")
                q[t:t + 4] = cb1.sym_tuple(sym)
        elif cbid == C.CB_MID:
            for t in range(lo, hi, 2):
                sym = _decode_sym(cur, "mid")
                q[t:t + 2] = cb2.sym_tuple(sym)
        else:
            for t in range(lo, hi, 2):
                sym = _decode_sym(cur, "esc")
                mags = cb3.sym_tuple(sym)
                vals = mags.astype(np.int64).copy()
                signs = [cur.take(1) if m != 0 else 0 for m in mags]
                for i, m in enumerate(mags):
                    if m >= C.ESC_MAG:
                        e = 4
                        while cur.take(1):
                            e += 1
                            # corrupt stream guard: legal magnitudes are
                            # <= QMAX = 4095, so the largest encodable
                            # exponent is 11 ((1<<11) + 2047). Anything
                            # bigger can only come from a corrupt stream;
                            # without this check the value would wrap
                            # through int64 into the int32 q array.
                            if e > 11:
                                raise ValueError(
                                    f"escape exponent {e} exceeds QMAX range")
                        # e <= 11 bounds the magnitude at 2^11 + (2^11 - 1)
                        # = 4095 = QMAX, so no separate value check needed.
                        vals[i] = (1 << e) + cur.take(e)
                for i, s in enumerate(signs):
                    if s:
                        vals[i] = -vals[i]
                q[t:t + 2] = vals
    bin_band = lay["bin_band"][block_type]
    e_band = np.clip(gain - amp, C.GAIN_MIN, C.GAIN_MAX)
    e_bin = e_band[bin_band]
    return q, e_bin, block_type, gain
