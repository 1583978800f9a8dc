"""Record packing on the device: decision arrays -> a chunk's MRC1 stream
body.

Port of mrcaudiocodec_tpu/ops/device_pack.py. The encoder builds every
record's bytes where its decisions are, and lays them back to back in
stream order there, so what crosses back is the stream's body and each
record's length, not the decision arrays (q alone is 2 KB a record) nor
cap-padded records; the host only prepends the header and joins one slice
per chunk (the JAX package's `encode_device_packed` does that
concatenation on the host).

`pack_stream(q, amp, gain, bt, cb, order, fs, cap)` launches the CUDA
kernel K3 (ops/kernels/record_pack.py) for CUDA tensors and takes the
plain version `pack_stream_plain` below for CPU tensors. Both raise for a
record longer than `cap`, so a truncated record never reaches a stream
(the JAX `_assemble_bytes` drops such bytes silently).

`pack_records_plain` is the per-record plain packer: the slot grid of the
JAX `_slots`, built with integer gathers (the codebook of each pair comes
from `bin_band`, not from the JAX bf16 mask einsum), then an exclusive
`cumsum` of the slot lengths and each slot's <= 4 byte contributions added
with `scatter_add_` into [F, cap]: slots never share a bit, so the sum is
the OR. `pack_stream_plain` packs the records `order` names with it and
compacts them with an integer exclusive `cumsum` of their lengths and an
index gather. Slot grid per record (models/packing.py of the JAX
package):
  [0]              20-bit length prefix (the content length)
  [1, 2]           block type (3), gain (8)
  [3 .. 3+NB)      codebook ids (2 bits, real bands)
  [.. +NB)         scale-factor delta codewords (real bands)
  [.. +512*5)      per pair: main | sign a | sign b | escape a | escape b
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import config as C
from .. import tables as T
from . import entropy
from .kernels import record_pack

I64 = torch.int64


def record_cap_bytes(cfg) -> int:
    """Static per-config upper bound on a record's total bytes."""
    mean_bits = int(cfg.mean_frame_bits)
    hi = int(mean_bits * (1.0 + C.RESERVOIR_MAX_WITHDRAW))
    return (C.FRAME_LEN_BITS + hi) // 8 + 2


def pack_cap_bytes(cfg) -> int:
    """The cap the encoder packs with. A frame whose budget fits sends at
    most its budget, so record_cap_bytes(cfg) holds it; a frame that no
    gain fits takes GAIN_MAX, where every q of an input in [-1, 1] is 0,
    and sends its header, codebook ids and scale factors whatever the
    budget. At a few tens of kbps that record is the longer one (16 kbps
    stereo 48 kHz: 77 bytes against a record_cap_bytes of 47), so the cap
    is the larger of the two."""
    nb = int(T.unified_layout(cfg.fs)["nb"])
    sf = int(T.code_arrays()["len_sf"].max())
    head = C.FRAME_LEN_BITS + C.BLOCK_TYPE_BITS + C.GAIN_BITS
    return max(record_cap_bytes(cfg),
               (head + nb * (C.CB_BITS + sf) + 7) // 8)


@functools.lru_cache(maxsize=None)
def _codes(device: str):
    """{codes_*, len_*} as int64 tensors on `device`."""
    return {k: torch.from_numpy(v.astype(np.int64)).to(device)
            for k, v in T.code_arrays().items()}


def _book(ca, book: str, sym):
    return ca[f"codes_{book}"][sym], ca[f"len_{book}"][sym]


def _escape(mag):
    """Escape word and length of magnitudes >= ESC_MAG (0, 0 below):
    (e - 4) ones, a zero, the e low bits of m; e = floor(log2 m) <= 12."""
    e = torch.full_like(mag, 4)
    for k in range(5, 13):
        e = e + (mag >= (1 << k)).to(I64)
    ones = torch.bitwise_left_shift(torch.ones_like(e), e - 4) - 1
    word = (torch.bitwise_left_shift(ones, e + 1)
            | (mag - torch.bitwise_left_shift(torch.ones_like(e), e)))
    esc = mag >= C.ESC_MAG
    return torch.where(esc, word, 0), torch.where(esc, 2 * e - 3, 0)


def slots(q, amp, gain, bt, cb, fs: int):
    """Decisions [F, ...] -> (codes [F, S], lens [F, S], content [F]),
    int64, in emission order, the length prefix first."""
    dev = q.device
    ca = _codes(str(dev))
    tb = entropy.dev_tables(fs, str(dev))
    q, amp, gain, bt, cb = (t.to(I64) for t in (q, amp, gain, bt, cb))
    f = q.shape[0]
    real = tb["width"][bt] > 0                                  # [F, NB]

    head_c = torch.stack([bt, gain], 1)
    head_l = torch.tensor([C.BLOCK_TYPE_BITS, C.GAIN_BITS], dtype=I64,
                          device=dev).expand(f, 2)
    cb_c = torch.where(real, cb, 0)
    cb_l = torch.where(real, C.CB_BITS, 0)
    a = torch.where(real, amp, 0)
    prev = torch.cat([torch.zeros_like(a[:, :1]), a[:, :-1]], 1)
    sf_c, sf_l = _book(ca, "sf", prev - a + C.SF_DELTA_MAX)
    sf_c, sf_l = torch.where(real, sf_c, 0), torch.where(real, sf_l, 0)

    # the codebook of each pair: an integer gather of its band's id
    cbp = torch.gather(cb, 1, tb["band2"][bt])                  # [F, 512]
    qp = q.reshape(f, -1, 2)
    aq = qp.abs()
    # CB_SMALL: a 4-tuple on the even pair, nothing on the odd one
    q4 = (q.clamp(-1, 1) + 1).reshape(f, -1, 4)
    sym1 = ((q4[..., 0] * 3 + q4[..., 1]) * 3 + q4[..., 2]) * 3 + q4[..., 3]
    c1, l1 = _book(ca, "small", sym1)
    is1 = cbp[:, ::2] == C.CB_SMALL
    zero = torch.zeros_like(c1)
    c1 = torch.stack([torch.where(is1, c1, 0), zero], -1).reshape(f, -1)
    l1 = torch.stack([torch.where(is1, l1, 0), zero], -1).reshape(f, -1)
    q2 = qp.clamp(-4, 4) + 4
    c2, l2 = _book(ca, "mid", q2[..., 0] * 9 + q2[..., 1])
    is2 = cbp == C.CB_MID
    m2 = aq.clamp(max=C.ESC_MAG)
    c3, l3 = _book(ca, "esc", m2[..., 0] * (C.ESC_MAG + 1) + m2[..., 1])
    is3 = cbp == C.CB_ESC
    main_c = c1 + torch.where(is2, c2, 0) + torch.where(is3, c3, 0)
    main_l = l1 + torch.where(is2, l2, 0) + torch.where(is3, l3, 0)
    nz = is3[..., None] & (qp != 0)
    sign_c = torch.where(nz, (qp < 0).to(I64), 0)
    sign_l = nz.to(I64)
    esc_c, esc_l = _escape(aq)
    esc_c = torch.where(is3[..., None], esc_c, 0)
    esc_l = torch.where(is3[..., None], esc_l, 0)
    pay_c = torch.cat([main_c[..., None], sign_c, esc_c], -1).reshape(f, -1)
    pay_l = torch.cat([main_l[..., None], sign_l, esc_l], -1).reshape(f, -1)

    lens = torch.cat([head_l, cb_l, sf_l, pay_l], 1)
    content = lens.sum(1)
    prefix_l = torch.full((f, 1), C.FRAME_LEN_BITS, dtype=I64, device=dev)
    codes = torch.cat([content[:, None], head_c, cb_c, sf_c, pay_c], 1)
    return codes, torch.cat([prefix_l, lens], 1), content


def assemble_bytes(codes, lens, cap: int):
    """codes/lens [F, S] -> record bytes [F, cap] uint8 (bytes past `cap`
    dropped: the caller checks nbytes against cap)."""
    f = codes.shape[0]
    codes = codes & (torch.bitwise_left_shift(torch.ones_like(lens), lens)
                     - 1)
    end = torch.cumsum(lens, 1)
    first = (end - lens) >> 3
    out = torch.zeros((f, cap + 1), dtype=I64, device=codes.device)
    for k in range(4):                  # a slot spans at most 4 bytes
        j = first + k
        sh = end - 8 * (j + 1)
        val = torch.where(sh >= 0,
                          torch.bitwise_right_shift(codes, sh.clamp(min=0)),
                          torch.bitwise_left_shift(codes, (-sh).clamp(min=0))
                          ) & 255
        valid = (lens > 0) & (8 * j < end) & (j < cap)
        out.scatter_add_(1, torch.where(valid, j, cap),
                         torch.where(valid, val, 0))
    return out[:, :cap].to(torch.uint8)


def pack_records_plain(q, amp, gain, bt, cb, fs: int, cap: int):
    """The per-record plain packer (pack_stream_plain's first step): ->
    (rec [F, cap] uint8, nbytes [F] int32); raises for a record longer
    than cap."""
    nb = int(T.unified_layout(fs)["nb"])
    record_pack.check_decisions("pack_records_plain", q, amp, gain, bt, cb,
                                nb, False)
    codes, lens, content = slots(q, amp, gain, bt, cb, fs)
    nbytes = ((C.FRAME_LEN_BITS + content + 7) >> 3).to(torch.int32)
    need = int(nbytes.max()) if nbytes.numel() else 0
    if need > cap:
        raise ValueError(f"pack_records_plain: a record needs {need} bytes, "
                         f"more than cap={cap}")
    return assemble_bytes(codes, lens, cap), nbytes


def pack_stream_plain(q, amp, gain, bt, cb, order, fs: int, cap: int):
    """Plain PyTorch version of K3: the records `order` names, packed and
    laid back to back -> (body [N * cap] uint8, its first `total` bytes
    the records in order, zeros after; nbytes [N] int32 in stream order;
    status [2] int32 on the host, (total, max nbytes)). Raises for a
    record longer than cap."""
    record_pack.check_order("pack_stream_plain", order, q)
    n = order.shape[0]
    if n == 0:
        return (torch.zeros((0,), dtype=torch.uint8, device=q.device),
                torch.zeros((0,), dtype=torch.int32, device=q.device),
                torch.zeros(2, dtype=torch.int32))
    sel = [t.index_select(0, order.to(I64)) for t in (q, amp, gain, bt, cb)]
    rec, nbytes = pack_records_plain(*sel, fs, cap)
    runs = nbytes.to(I64)
    total = int(runs.sum())
    start = torch.cumsum(runs, 0) - runs            # exclusive, exact
    rid = torch.repeat_interleave(torch.arange(n, device=q.device), runs)
    at = torch.arange(total, device=q.device) - start[rid]
    body = torch.zeros((n * cap,), dtype=torch.uint8, device=q.device)
    body[:total] = rec[rid, at]
    status = torch.tensor([total, int(nbytes.max())], dtype=torch.int32)
    return body, nbytes, status


def pack_stream(q, amp, gain, bt, cb, order, fs: int, cap: int):
    """Decisions [F, ...] and a stream order [N] -> (body, nbytes, status)
    as `pack_stream_plain` gives them: K3 on the card, the plain version
    for CPU tensors, an error otherwise."""
    if q.is_cuda:
        return record_pack.pack_stream_kernel(q, amp, gain, bt, cb, order,
                                              fs, cap)
    if q.device.type == "cpu":
        return pack_stream_plain(q, amp, gain, bt, cb, order, fs, cap)
    raise ValueError(f"no record packing for device {q.device}")
