"""Measurement helpers of chip_smoke.py's kernel phases and the
benchmark's work counts (`mrcbench/work`).

    card_line()                    the card's name and power limit
    device_ms(fn, ...)             profiler device ms per call of fn()
    kernel_modules()               K1-K10's wrapper modules
    capture_inputs(run, per_key)   K1-K10 inputs recorded at their wrappers
    kernel_bound(key, args)        bytes, ops and op rate of one launch
    rd_loop_ops(args, kept)        K4's f32 ops, kept magnitudes or not
    psycho_ops(bt, fs, full)       K8's f32 ops on these block types
    bound_ms(parts)                the least time for a set of launches

Bounds are against the H100 SXM's published rates at its 700 W limit; a
card set below that runs slower, so every time is logged beside
`card_line()`. Nothing here runs at import; torch and the kernel modules
are imported by the functions that use them.
"""
from __future__ import annotations

import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
# H100 SXM f32 outside the tensor cores is 67e12 FLOP/s (data sheet), which
# counts one FMA as two operations. The kernels are built with --fmad=false
# and every counted op is its own instruction (an add, a multiply, a
# compare), so they run at half that rate: 132 SMs x 128 lanes x ~1.98 GHz.
F32_OPS_PER_S = 67e12 / 2
# H100 SXM: 64 INT32 lanes per SM against 128 FP32 (Hopper white paper)
INT32_OPS_PER_S = F32_OPS_PER_S / 2

KERNEL_NAMES = ("fft_stages", "quant_cost", "record_pack", "rd_loop",
                "transients", "analysis_pre", "mdct_post", "psycho",
                "synth_pre", "synth_post")
# f32 ops a bin (K2's pricing): quantize (two xsqrt of 24 ops, the step
# and |x| * step, a * sqrt(a), add, floor, min); dequantize by its chain
# (max, xlog2's 26, the 4/3 multiply, xexp2's 20, the zero select, the
# step, the sign) or from K4's |q|^(4/3) table (the read, the step, the
# product, the sign); then d = x - xhat and d * d; the scan adds one op a
# bin a stage
QUANT_OPS = 54
DEQUANT_OPS = 53
DEQUANT_TABLE_OPS = 4
# the analysis kernels' f32 ops (an op of the torch DAG each; a negation
# and a compare count as one): xlog2 (the compare, the halving, t = m - 1,
# 12 Horner steps of 2, the exponent's exact conversion and e + p) and
# xexp2 (the rounding add and its exact conversion, f, f * ln2, 7 Horner
# steps of 2, the scale); a sample of the transient detector (difference,
# square, one tree add) and its 16 sub-blocks' ladder and compares
XLOG2_OPS = 29
XEXP2_OPS = 19
TRANSIENT_OPS_PER_SAMPLE = 3
TRANSIENT_OPS_PER_FRAME = 4 * 16 + 15 * 5
# the synthesis kernels' f32 ops a frame: K9 dequantizes a bin in 3 (the
# step's product, |q|^(4/3) * step, the sign) and pre-twiddles each of the
# two families' 512 complex values in 6; a bin beyond QMAX adds the chain
# (xlog2, the 4/3 product, xexp2). K10: a long frame's 1024 coefficients
# (post-twiddle 3 or 4 ops and the scale), 1536 unfold negations and 2048
# window products; a SHORT frame the same on its 8 sub-blocks plus 2048
# adds of the overlap; the hop add a sample, and for int16 the product,
# the rounding and the two clamps
SYNTH_PRE_OPS_PER_FRAME = 1024 * 3 + 2 * 512 * 6
SYNTH_PRE_OPS_OVER_QMAX = XLOG2_OPS + 1 + XEXP2_OPS
SYNTH_POST_OPS_LONG = 512 * 3 + 512 * 4 + 1024 + 1536 + 2048
SYNTH_POST_OPS_SHORT = 8 * (64 * 3 + 64 * 4 + 128 + 192 + 256) + 2048
SYNTH_POST_OPS_HOP = 1024
SYNTH_POST_OPS_PCM16 = 1024 * 4


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def device_ms(fn, iters: int = 20, match=None, per_call: int = 1):
    """Mean device ms per call of fn() from torch.profiler's kernel times:
    the kernels whose name holds `match`, `per_call` of them a call, or
    (match None) every kernel fn launched but fills. It is the recorded
    launches' mean time times the launches a call, and it is kept only
    from a trace that holds every launch (iters x per_call of them; for
    match None a multiple of iters): the trace can drop launches. None if
    three traces in a row miss some."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the trace can miss the first launches of a session: open it
            # with fills, which no measured function launches, and leave
            # them out
            pad = torch.empty(1024, device="cuda")
            for _ in range(50):
                pad.fill_(1.0)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0)
            if t > 0 and "FillFunctor" not in e.key and (
                    match is None or match in e.key):
                total += t
                count += e.count
        whole = (count > 0 and count % iters == 0 if match is None
                 else count == iters * per_call)
        if whole:
            return total / 1e3 / count * (count // iters if match is None
                                          else per_call)
        seen.append(count)
    log(f"[times] device ms not measured for {match or 'all kernels'}: the "
        f"traces held {seen} of {iters} x {per_call} launches")
    return None


def kernel_modules():
    """The kernel wrappers' modules in KERNEL_NAMES order (K1-K10)."""
    import importlib
    return tuple(importlib.import_module(f"{__package__}.ops.kernels.{n}")
                 for n in KERNEL_NAMES)


def capture_inputs(run, per_key: int = 1):
    """Run run() with K1-K10's wrappers recording a copy of their arguments
    -> {key: args} of the first `per_key` calls of each key: K1
    ("fft_stages", shape), K2 ("quant_cost", (rows, G)), K3 ("record_pack",
    (records in the stream order,)), K4 ("rd_loop", (rows,)), K5
    ("transients", (rows, frames)), K6-K8 ("analysis_pre" / "mdct_post" /
    "psycho", (frame rows,)), K9 and K10 ("synth_pre" / "synth_post",
    (frame rows,)), in call order; the i-th call (i > 0) of a key is
    stored under key + (i,). K10's arguments are kept up to `prev`."""
    import torch
    from .ops.kernels import (analysis_pre, fft_stages, mdct_post, psycho,
                              quant_cost, rd_loop, record_pack, synth_post,
                              synth_pre, transients)
    seen, calls = {}, {}
    hooks = ((fft_stages, "fft_kernel",
              lambda a: ("fft_stages", tuple(a[0].shape))),
             (quant_cost, "payload_bits_kernel",
              lambda a: ("quant_cost", tuple(a[2].shape))),
             (record_pack, "pack_stream_kernel",
              lambda a: ("record_pack", (a[5].shape[0],))),
             (rd_loop, "rd_loop_kernel",
              lambda a: ("rd_loop", (a[0].shape[0],))),
             (transients, "transients_kernel",
              lambda a: ("transients", (a[0].shape[0],
                                        a[0].shape[1] // 1024 - 3))),
             (analysis_pre, "analysis_pre_kernel",
              lambda a: ("analysis_pre", (a[1].numel(),))),
             (mdct_post, "mdct_post_kernel",
              lambda a: ("mdct_post", (a[4].shape[0],))),
             (psycho, "psycho_kernel",
              lambda a: ("psycho", (a[5].shape[0],))),
             (synth_pre, "synth_pre_kernel",
              lambda a: ("synth_pre", (a[2].numel(),))),
             (synth_post, "synth_post_kernel",
              lambda a: ("synth_post", (a[4].numel(),))))
    saved = []
    for mod, attr, key_of in hooks:
        orig = getattr(mod, attr)
        saved.append((mod, attr, orig))

        def rec(*args, _orig=orig, _key_of=key_of):
            key = _key_of(args)
            i = calls[key] = calls.get(key, -1) + 1
            if i < per_key:
                # K10's `out` (the caller's slice of a clip buffer) is
                # left out: a replay writes a fresh pcm
                kept = args[:8] if key[0] == "synth_post" else args
                seen[key + ((i,) if i else ())] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in kept)
            return _orig(*args)
        setattr(mod, attr, rec)
    try:
        run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)
    return seen


def kernel_bound(key, args):
    """-> (bytes, ops, ops per s) of one launch on these inputs: each input
    read once, each output written once; the ops each kernel must do."""
    from . import config as C
    from . import tables as T
    from .ops import device_pack
    if key[0] == "fft_stages":
        points, n = args[0].numel(), args[0].shape[-1]
        stages = n.bit_length() - 1
        # each point read and written once, plus the compact twiddle table
        return (points * 16 + (n - 1) * 8, points // 2 * stages * 10,
                F32_OPS_PER_S)
    if key[0] == "quant_cost":
        rows, g = args[2].shape
        return (rows * C.LONG_COEFFS * 8 + rows * (2 * g + 1) * 4,
                rows * g * C.LONG_COEFFS * QUANT_OPS, F32_OPS_PER_S)
    if key[0] == "rd_loop":
        # x and allowed in, q and amp out, six [F] words, the |q|^(4/3)
        # table; the candidates and over-masks these inputs need
        rows, nb = args[1].shape
        return (rows * (2 * C.LONG_COEFFS + 2 * nb + 6) * 4
                + (C.QMAX + 1) * 4, rd_loop_ops(args), F32_OPS_PER_S)
    if key[0] in ("transients", "analysis_pre", "mdct_post", "psycho"):
        return analysis_bound(key[0], args)
    if key[0] in ("synth_pre", "synth_post"):
        return synthesis_bound(key[0], args)
    # K3: the packed records' q, amp, cb, gain, bt and their order entries
    # in; the compact body and nbytes out. Integer work these records need:
    # a shift and an OR per bit-carrying slot
    order, fs = args[5], args[6]
    n, nb = order.shape[0], T.unified_layout(fs)["nb"]
    sel = [t.index_select(0, order.long()) for t in args[:5]]
    _, lens, content = device_pack.slots(*sel, fs)
    body = int(((C.FRAME_LEN_BITS + content + 7) >> 3).sum())
    return (n * (2 * C.LONG_COEFFS + 2 * nb + 2 + 1 + 4) + body + n * 4,
            2 * int((lens > 0).sum()), INT32_OPS_PER_S)


def analysis_bound(name, args):
    """(bytes, ops, ops per s) of one launch of K5-K8 on these inputs:
    each input read once (K5 and K6 read each sample once, though the
    frames overlap; K7 and K8 the transform or spectrum the frame's block
    type selects), each output written once; the f32 ops that work needs."""
    from . import config as C
    from . import tables as T
    from . import xpsy
    if name in ("transients", "analysis_pre"):
        audio = args[0]
        samples = audio.numel()
        conv = 2 * samples if audio.dtype.itemsize == 2 else 0
        read = samples * audio.dtype.itemsize
    if name == "transients":
        r, ext = audio.shape[0], audio.shape[1] // C.HOP - 1    # s + 2
        ops = conv + (r * ext * (C.LONG_SIZE * TRANSIENT_OPS_PER_SAMPLE
                                 + TRANSIENT_OPS_PER_FRAME)
                      if args[1] else 0)
        return read + r * (ext - 2) * 4, ops, F32_OPS_PER_S
    if name == "analysis_pre":
        bt, parts = args[1], args[3]
        nf = bt.numel()
        mdct = parts in ("all", "mdct")
        psy = parts in ("all", "psycho")
        # MDCT: window, fold (negate and subtract, or subtract), pre-twiddle
        # (4 multiplies and 2 adds a pair) for the long and the 8 short
        # transforms; psycho: the Hann window
        per = mdct * 2 * (2048 + 1536 + 512 * 6) + psy * 2 * 2048
        out = (mdct * 1024 + psy * 2048) * 8
        tables = (mdct * (5 * 2048 + 256 + 2049 + 257)
                  + psy * (2048 + 256)) * 4
        return (read + nf * (4 + out) + tables, conv + nf * per,
                F32_OPS_PER_S)
    if name == "mdct_post":
        nf = args[4].shape[0]
        # post-twiddle (3 or 4 ops a coefficient) and the scale
        return (nf * (4096 + 4 + 4096) + (2049 + 257) * 4,
                nf * (512 * 3 + 512 * 4 + 1024), F32_OPS_PER_S)
    bt, fs, full = args[5], args[6], args[7]
    nf, nb = bt.shape[0], T.unified_layout(fs)["nb"]
    blobs = sum(b.nbytes for lb in (True, False)
                for b in xpsy.kernel_blobs(fs, lb))
    return (nf * (8192 + 4096 + 4 + 8 * nb + 4) + blobs,
            psycho_ops(bt, fs, full), F32_OPS_PER_S)


def synthesis_bound(name, args):
    """(bytes, ops, ops per s) of one launch of K9 or K10 on these inputs:
    K9 reads q, the exponents and the block types once and writes K1's
    four inputs (8 KB a frame); K10 reads the transform each frame's block
    type selects (4 KB a frame), the block types and, where given, the
    previous chunk's tail (4 KB a row) and writes the PCM (f32 or int16),
    first and tail; both read their tables once. Ops as counted above,
    K9's chain for each bin of this run's q beyond QMAX."""
    import torch
    from . import config as C
    dct = (2049 + 257) * 4
    if name == "synth_pre":
        q, e_band, bt = args[0], args[1], args[2]
        nf = bt.numel()
        over = int((q.to(torch.int32).abs() > C.QMAX).sum())
        tables = 5 * 1024 * 4 + (C.QMAX + 1) * 4 + dct + 4 * 4
        return (q.numel() * 2 + e_band.numel() * 2 + nf + nf * 8192
                + tables, nf * SYNTH_PRE_OPS_PER_FRAME
                + over * SYNTH_PRE_OPS_OVER_QMAX, F32_OPS_PER_S)
    bt, pcm16 = args[4], args[6]
    prev = args[7] if len(args) > 7 else None
    r, nf = bt.shape[0], bt.numel()
    n_short = int((bt == C.SHORT).sum())
    out = nf * C.HOP * (2 if pcm16 else 4) + 2 * r * C.HOP * 4
    if prev is not None:
        out += r * C.HOP * 4                # the previous tail, read
    ops = ((nf - n_short) * SYNTH_POST_OPS_LONG
           + n_short * SYNTH_POST_OPS_SHORT
           + nf * (SYNTH_POST_OPS_HOP + (SYNTH_POST_OPS_PCM16 if pcm16
                                         else 0)))
    return (nf * 4096 + nf + out + (5 * 2048 + 256) * 4 + dct, ops,
            F32_OPS_PER_S)


def psycho_ops(bt, fs: int, full: bool) -> int:
    """K8's f32 ops on these block types: each frame's own family only
    (the kernel computes no other), counted by the torch DAG's ops."""
    from . import config as C
    from . import tables as T
    from . import xpsy
    nb_u = T.unified_layout(fs)["nb"]
    n_short = int((bt == C.SHORT).sum())
    total = 0
    for long_block, frames in ((True, bt.shape[0] - n_short),
                               (False, n_short)):
        cst = xpsy.psy_tables(fs, long_block)
        g = 1 if long_block else C.N_SHORT
        bins, npart, nb = C.LONG_COEFFS, cst["npart"], cst["nb"]
        p2 = 1 << (nb - 1).bit_length()
        part_st = xpsy._stage_count(cst["part_edges"])
        band_st = xpsy._stage_count(cst["band_edges"])
        # untwist and power (19 a bin), the max and the floor
        per = bins * 21 + g
        # scans: p (and the xlog2 of p + TINY) over partitions, p and the
        # coefficients squared over bands
        per += bins * (part_st * (2 if full else 1) + 2 * band_st + 1)
        if full:
            per += bins * (XLOG2_OPS + 1)
            # spreading, flatness, xexp2, offsets (about 12 ops)
            per += g * npart * (2 * npart - 1 + XLOG2_OPS + XEXP2_OPS + 14)
        else:
            per += g * npart
        per += g * npart * 2                          # ATH max, density
        # a band: the min over the partitions, the width, the PE term
        per += g * nb * (npart + 1 + 3 * XLOG2_OPS + XEXP2_OPS + 6)
        per += g * (p2 - 1) + (g - 1)                  # tree, fold
        # allowed noise of each unified band
        per += nb_u * (2 * XLOG2_OPS + XEXP2_OPS + 6)
        total += frames * per
    return total


def rd_loop_ops(args, kept: bool = True) -> int:
    """K4's f32 ops on these inputs, from what the plain loop reaches
    (rd.loop_counts): each candidate's quantize, then every over-mask's
    d, d * d and scan stages (one op a bin a stage). kept (K4's design):
    only the entry quantizes, and every over-mask dequantizes from the
    table; else (the count of a K4 that quantizes again) every over-mask
    quantizes and dequantizes by the xlog2 / xexp2 chain."""
    from . import config as C
    from .ops import rd
    bt, fs = args[3], args[6]
    st = rd.loop_counts(*args)
    short = (bt == C.SHORT).to(st["over_masks"].dtype)
    stages = (short * rd.scan_stages(fs, True)
              + (1 - short) * rd.scan_stages(fs, False))
    masks = int((st["over_masks"] * (2 + stages)).sum())
    n_masks = int(st["over_masks"].sum())
    if kept:
        per_bin = (int(st["cands"].sum()) + bt.shape[0]) * QUANT_OPS \
            + n_masks * DEQUANT_TABLE_OPS + masks
    else:
        per_bin = int(st["cands"].sum()) * QUANT_OPS \
            + n_masks * (QUANT_OPS + DEQUANT_OPS) + masks
    return C.LONG_COEFFS * per_bin


def bound_ms(parts):
    """The least time (ms) the card could take for launches with these
    (bytes, ops, ops per s) -> (ms, "bytes" or "operations"): the larger
    of all their bytes over the HBM rate and all their ops over their
    rates."""
    t_b = sum(b for b, _, _ in parts) / HBM_BYTES_PER_S * 1e3
    t_o = sum(o / rate for _, o, rate in parts) * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")
