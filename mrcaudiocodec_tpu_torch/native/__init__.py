"""ctypes loader for the native host bitstream runtime (mrc_native.cpp).

The record parser (`decode_records`) and the record packer
(`pack_records_native`) are host C++, built with g++ at first use into
the package's git-ignored `build/` directory. A failed build raises: the
port has no pure-Python fallback.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys
import threading

import numpy as np

from .. import config as C
from .. import tables as T

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "mrc_native.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "build")
_SO = os.path.join(_BUILD, f"mrc_native_{sys.implementation.cache_tag}.so")


def _build() -> str:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    os.makedirs(_BUILD, exist_ok=True)
    # private temp path + os.replace: several processes (pytest-xdist
    # workers) or threads may race to build, and none may load a
    # half-written .so
    tmp = f"{_SO}.tmp.{os.getpid()}.{threading.get_ident()}"
    res = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
         _SRC, "-o", tmp],
        capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{res.stderr}")
    os.replace(tmp, _SO)
    return _SO


@functools.lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(_build())
    lib.mrc_decode_records.restype = ctypes.c_int
    lib.mrc_pack_records.restype = ctypes.c_int
    return lib


def _ptr(a, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


@functools.lru_cache(maxsize=None)
def _decode_tables(fs: int):
    """Contiguous int64/int32 table arrays for the C ABI."""
    out = []
    for which in ("sf", "small", "mid", "esc"):
        min_len, max_len, first_code, first_sym, order = T.decode_table(which)
        if which == "sf":
            cb = T.sf_codebook()
        else:
            cb = T.spectrum_codebooks()["small mid esc".split().index(which)]
        counts = np.bincount(cb.lengths, minlength=max_len + 2).astype(np.int64)
        out.append((np.ascontiguousarray(first_code, np.int64),
                    np.ascontiguousarray(first_sym, np.int64),
                    np.ascontiguousarray(order, np.int64),
                    counts, int(min_len), int(max_len)))
    lay = T.unified_layout(fs)
    edges = np.ascontiguousarray(lay["edges"], np.int32)
    width = np.ascontiguousarray(lay["width"], np.int32)
    return out, edges, width, int(lay["nb"])


def decode_records(data: bytes, content_bit_offsets: np.ndarray, fs: int,
                   n_threads: int = 0):
    """Decode all frame records natively.

    content_bit_offsets: [R] int64 bit offset of each record's content
    (i.e. after the 20-bit length prefix).
    Returns (q [R,1024] i32, e_band [R,NB] i32, bt [R] i32, gain [R] i32).
    """
    lib = _lib()
    (sf, sm, md, es), edges, width, nb = _decode_tables(fs)
    r = len(content_bit_offsets)
    q = np.zeros((r, C.LONG_COEFFS), np.int32)
    e_band = np.zeros((r, nb), np.int32)
    bt = np.zeros(r, np.int32)
    gain = np.zeros(r, np.int32)
    buf = np.frombuffer(data, np.uint8)
    offs = np.ascontiguousarray(content_bit_offsets, np.int64)

    def targs(t):
        fc, fsym, order, counts, mn, mx = t
        return (_ptr(fc, ctypes.c_int64), _ptr(fsym, ctypes.c_int64),
                _ptr(order, ctypes.c_int64), _ptr(counts, ctypes.c_int64),
                ctypes.c_int32(mn), ctypes.c_int32(mx))

    rc = lib.mrc_decode_records(
        _ptr(buf, ctypes.c_uint8), ctypes.c_int64(len(buf) * 8),
        _ptr(offs, ctypes.c_int64),
        ctypes.c_int64(r),
        *targs(sf), *targs(sm), *targs(md), *targs(es),
        _ptr(edges, ctypes.c_int32), _ptr(width, ctypes.c_int32),
        ctypes.c_int32(nb), ctypes.c_int32(C.LONG_COEFFS),
        ctypes.c_int32(n_threads),
        _ptr(q, ctypes.c_int32), _ptr(e_band, ctypes.c_int32),
        _ptr(bt, ctypes.c_int32), _ptr(gain, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"native decode failed with code {rc}")
    return q, e_band, bt, gain


def pack_records_native(q, amp, gain, bt, cb, fs: int,
                        n_threads: int = 0) -> bytes:
    """Emit all frame records (prefix+content+pad) natively, in parallel.

    q [R,1024] int16, amp [R,NB] int8, gain [R] int16, bt [R] int8,
    cb [R,NB] int8. Returns the concatenated record bytes.
    """
    lib = _lib()
    ca = T.code_arrays()
    lay = T.unified_layout(fs)
    nb = int(lay["nb"])
    r = q.shape[0]
    rec_cap = 8192
    out = np.zeros(r * rec_cap, np.uint8)
    sizes = np.zeros(r, np.int64)
    args = []
    for book in ("small", "mid", "esc", "sf"):
        args.append(_ptr(np.ascontiguousarray(ca[f"codes_{book}"], np.uint32),
                         ctypes.c_uint32))
        args.append(_ptr(np.ascontiguousarray(ca[f"len_{book}"], np.int32),
                         ctypes.c_int32))
    edges = np.ascontiguousarray(lay["edges"], np.int32)
    width = np.ascontiguousarray(lay["width"], np.int32)
    rc = lib.mrc_pack_records(
        _ptr(np.ascontiguousarray(q, np.int16), ctypes.c_int16),
        _ptr(np.ascontiguousarray(amp, np.int8), ctypes.c_int8),
        _ptr(np.ascontiguousarray(gain, np.int16), ctypes.c_int16),
        _ptr(np.ascontiguousarray(bt, np.int8), ctypes.c_int8),
        _ptr(np.ascontiguousarray(cb, np.int8), ctypes.c_int8),
        ctypes.c_int64(r), *args,
        _ptr(edges, ctypes.c_int32), _ptr(width, ctypes.c_int32),
        ctypes.c_int32(nb), ctypes.c_int32(C.LONG_COEFFS),
        ctypes.c_int32(n_threads), ctypes.c_int64(rec_cap),
        _ptr(out, ctypes.c_uint8), _ptr(sizes, ctypes.c_int64))
    if rc != 0:
        raise RuntimeError(f"native record pack failed ({rc})")
    # concatenate the per-record byte runs
    idx = np.repeat(np.arange(r) * rec_cap, sizes) + _ranges(sizes)
    return out[idx].tobytes()


def _ranges(counts: np.ndarray) -> np.ndarray:
    """[c0, c1, ...] -> [0..c0), [0..c1), ... concatenated."""
    total = int(counts.sum())
    ends = np.cumsum(counts)
    out = np.arange(total)
    out -= np.repeat(ends - counts, counts)
    return out
