"""MSB-first bit packing/unpacking (reference component R13, SURVEY.md §2).

A verbatim copy of the JAX package's `utils/bits.py`. `BitWriter` writes
the stream header; `BitReader` reads it. `pack_codes` is the vectorized
NumPy MSB-first packer behind `BitWriter.getvalue`.
"""
from __future__ import annotations

import numpy as np


class BitWriter:
    """Sequential MSB-first bit writer."""

    def __init__(self):
        self._bits: list[int] = []   # list of (value, nbits) packed lazily
        self._vals: list[int] = []
        self._lens: list[int] = []
        self.bitpos = 0

    def write(self, value: int, nbits: int) -> None:
        if nbits < 0 or (nbits < 64 and int(value) >> nbits):
            raise ValueError(f"value {value} does not fit in {nbits} bits")
        self._vals.append(int(value))
        self._lens.append(int(nbits))
        self.bitpos += nbits

    def align(self) -> None:
        pad = (-self.bitpos) % 8
        if pad:
            self.write(0, pad)

    def getvalue(self) -> bytes:
        codes = np.asarray(self._vals, dtype=np.uint64)
        lens = np.asarray(self._lens, dtype=np.int64)
        return pack_codes(codes, lens)


class BitReader:
    """Sequential MSB-first bit reader over a bytes/ndarray buffer."""

    def __init__(self, data, bitpos: int = 0):
        self._bits = np.unpackbits(np.frombuffer(bytes(data), dtype=np.uint8))
        self.bitpos = bitpos

    def read(self, nbits: int) -> int:
        if self.bitpos + nbits > len(self._bits):
            raise EOFError("bitstream exhausted")
        out = 0
        for b in self._bits[self.bitpos:self.bitpos + nbits]:
            out = (out << 1) | int(b)
        self.bitpos += nbits
        return out

    def read_bit(self) -> int:
        b = int(self._bits[self.bitpos])
        self.bitpos += 1
        return b

    def align(self) -> None:
        self.bitpos += (-self.bitpos) % 8

    @property
    def remaining(self) -> int:
        return len(self._bits) - self.bitpos


def pack_codes(codes: np.ndarray, lengths: np.ndarray) -> bytes:
    """Vectorized MSB-first packer: concatenate codewords into bytes.

    codes:   uint64 array of codeword values (right-aligned)
    lengths: int64 array of codeword bit lengths (0 allowed => skipped)

    Returns the packed bytes, final partial byte zero-padded.
    """
    codes = np.asarray(codes, dtype=np.uint64)
    lengths = np.asarray(lengths, dtype=np.int64)
    total = int(lengths.sum())
    if total == 0:
        return b""
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    # Expand every codeword into its individual bits.
    nz = lengths > 0
    codes, lengths, offsets = codes[nz], lengths[nz], offsets[nz]
    reps = lengths
    # bit position within each code: lengths[i]-1 .. 0 (MSB first)
    idx = np.repeat(offsets + lengths, reps) - np.arange(total) - 1
    # For symbol i spanning [offsets[i], offsets[i]+len[i]), the bit at
    # global position p is (code >> (offsets[i]+len[i]-1-p)) & 1.
    shift = idx.astype(np.uint64) - 0  # = offsets+len-1-p computed directly:
    code_rep = np.repeat(codes, reps)
    # global positions covered, in order:
    pos = np.arange(total)
    shift = (np.repeat(offsets + lengths, reps) - pos - 1).astype(np.uint64)
    bits = ((code_rep >> shift) & np.uint64(1)).astype(np.uint8)
    nbytes = (total + 7) // 8
    padded = np.zeros(nbytes * 8, dtype=np.uint8)
    padded[:total] = bits
    return np.packbits(padded).tobytes()
