#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is non-zero:
  1. card: name and power limit (nvidia-smi), CUDA version, capability 9.0
  2. build: the main path's eleven CUDA kernels from csrc/ (nvcc, one
     process per source started together, -Xptxas -v per kernel); K4's
     blocks resident an SM (the occupancy calculator), at least 7, and
     K8's frames in flight an SM, at least 20 (2 blocks of 10 warps)
  3. kernels against their plain PyTorch versions, bitwise:
     K1 fft_stages at all four FFT sizes (card kernel vs plain on the card
     and on the CPU); K2 quant_cost at G in {32, 8, 4, 1}, zero and random
     amplification, all block types, fs 44100/48000/32000; K3 record_pack
     on random decisions (every codebook and block type, escapes up to
     QMAX, all three fs) in stream orders that are in turn, shuffled or
     skip records, at 1, 31, 32, 33, a tile +- 1, 8192 and 65536 records,
     20 repeated launches giving the same bytes, and a too-small cap,
     which must raise; then all four on the main path's own inputs,
     captured at their wrappers: one 30 s stereo encode (one chunk of 2586
     frame rows), its decode, and one 64 x 10 s stereo corpus batch
     (chunks of 8192 frame rows); K4 rd_loop also on RD corner sets the
     encoder makes on the card (16 kbps stereo 48 kHz, where the GAIN_MAX
     fallback is reached; 320 kbps; the 30 s chunk with every frame
     SHORT, with silent budget-0 pad frames, with allowed noise a
     millionth, so frames run every outer iteration), with how many frames
     reach each corner, on the CPU too for 256 rows of each, and 20
     repeated launches giving the same outputs; K4's |q|^(4/3) table
     built on the card == built on the CPU; the analysis kernels K5
     transients, K6 analysis_pre, K7 mdct_post and K8 psycho on the 30 s
     clip's chunk, a 64 x 10 s corpus chunk with pad frames, a config 3
     chunk (48 kHz), 32 kHz, the kbd window, window switching off, full
     psycho off, an all-silent chunk, a transient-dense chunk (SHORT
     frames) and strided rows, and the whole kernel path of
     encoder._analyze_chunk on the card == the eager chain on the CPU;
     the decoder's synthesis kernels K9 synth_pre and K10 synth_post on
     every slab of the goldens' streams, a 48 kHz, a 32 kHz and a kbd
     stereo stream, a SHORT-dense stream, a stream silent across its
     seams at DEC_CHUNK 5 and the crafted escapes beyond QMAX, K10 at R =
     1, 2 and 3 rows, f32 and int16 PCM, with prev null, the previous
     slab's tail and a tail of +-0, +-inf and NaN (hold_k10), each
     stream's card decode == its CPU decode; K9 and K10 also on the 30 s
     decode's own inputs (2048 and 538 frame rows, K10 the same ways)
  4. on those captured inputs, each kernel's time (CUDA events, and the
     profiler's device time per launch) beside its plain version's, one
     PyTorch library call where one exists (torch.fft.fft for K1) and the
     card's bound; where K4's time goes: its device ms and bound (by this
     design's op count and by one that quantizes again in every over-mask)
     on the budget-0 pad rows alone, the
     30 s chunk at its own and at a millionth of its allowed noise, the
     time of one outer iteration from them, and the OUTER_MAX set cut to
     132 ... 2586 rows (latency or issue); where K8's time goes
     (k8_locate: the 30 s chunk's inputs cut to 132 ... 2586 rows, full
     psycho off, a SHORT-dense chunk against as many mostly-long rows, the
     batch's 8192) and K5's (k5_locate: the 30 s chunk's 2 rows, its row 0
     alone, the batch chunk) and K10's (k10_locate: the decode's 2048 and
     538 rows, f32 and int16, and the 2048 rows cut to 66 ... 2048), each beside
     its bound; K11 pad_rows on its inputs captured at its wrapper from
     one 30 s encode (one launch) and one 64 x 10 s batch (7 launches):
     each launch bit for bit == the host pad it replaced
     (upload_chunk(_padded_rows(...))) and == its plain version, its
     event ms, device ms and byte bound at the 30 s chunk and the batch's
     8192-row chunk, its SASS audit (no FFMA, no .FTZ); the SASS
     instruction mix of K1-K11
  5. goldens g1-g6 encoded on the card (records built by K3) against their
     SHA-256 digests; each decoded on the card and on the CPU, PCM bitwise
     equal
  6. a 4 s stereo 128 kbps clip: the card stream == the host-packed card
     stream (decisions downloaded, native packer) == the CPU stream;
     decodes equal
  7. full size: the benchmark clip (30 s stereo 44.1 kHz 128 kbps, int16)
     encoded and decoded on the card, kernel launch counts of that run (K4
     once and K2 twice a chunk, K5-K8 once and K1 four times a chunk in
     the encode, no RD host sync, no plain RD loop; K9 and K10 once and K1
     twice a chunk in the decode, nothing else; the
     plain path's host syncs on the same clip beside them), then one
     warm-up and 5 timed runs of each
  8. where the time goes: host-clock ms per encode/decode stage (the pack
     stage as the stream order built and uploaded, device pack, download
     of the compact stream body and assemble, beside the host-pack path,
     with the bytes each downloads; the decode as the native parse, the
     slabs' transposes and casts, upload, synth (the chunks in order, each
     K10 adding the tail before it into its slice of one clip buffer) and
     the one download, already [n, channels]),
     and the card's busy share (the decode's copies counted: 1 download)
     with the top kernels (torch.profiler), with K1-K10's
     launches and device ms in one encode and one decode; the analysis
     alone (_analyze_chunk on the clip's chunk): its launch count and
     device events (K5, K6, K1 x 4, K7, K8 and nothing else), device ms,
     best wall and busy share; _synth_chunk alone on each of the decode's
     two chunks the same way (K9, K1 x 2, K10 and nothing else);
     decide_chunk on
     the clip's chunk with K4, with the loop in its plain version (the
     parent's path) and with every kernel plain, in turns: wall, device
     ms, host syncs
  9. the probe path (P1-P5, mrcaudiocodec_tpu_torch/probes/): builds the
     four probe libraries and the --fmad=true control, runs each probe
     module on the card with the launch counts, asserts P3's
     classifications and the SASS audit (no FFMA, no .FTZ where the
     sources allow none, so in none of K1-K10's libraries; FFMA in the
     control), holds each of the 15 probe
     bodies against its plain version (bitwise; v1 within 4 if exp2f/powf
     differ), and times each beside its plain version, its bound and a
     library call; P1 and P4 again at 2048 rows
 10. the corpus path: corpus.encode_batch on 64 clips x 10 s stereo
     128 kbps (the corpus bench's batch), fused on the card, with the launch
     counts of that run; every stream == the clip's single-clip card
     encode, and a 5-clip mixed-length bucket too; wall time (5 timed runs
     after a warm-up), real-time factor, frames/s, peak device memory and
     the card's busy share, and the device time outside K1-K10
 11. the CLI: python -m mrcaudiocodec_tpu_torch.cli encode, info, decode in
     subprocesses on a WAV the script writes; the .mrc bytes == codec.encode
     and the WAV == codec.decode on the card
 12. the parallel path (parallel/), on the card: acceptance config 3 (5 min
     48 kHz stereo 192 kbps) encoded on the card == its card encode with
     K1-K10 swapped for their plain versions, its card decode == the
     decode with K9 and K10 swapped for theirs; (a) sharded encode, every
     shard in turn in this process (LocalShards): the 30 s clip at (data,
     seq) = (1, 4), (2, 2), (2, 1) == codec.encode, config 3 at (1, 4) ==
     its unsharded encode, the 64 x 10 s batch at (4, 2) == phase 10's
     streams; (b) sharded decode of the 30 s stream at (1, 4), (2, 2) ==
     codec.decode float32 bitwise; the K1-K10 launch counts of (a) and of
     (b) (the decodes: K9, K1, K10 only); K1-K10 held bitwise to their plain versions on the inputs the
     (1, 4) encodes and decode gave them (captured at the wrappers, every
     shard's); walls of (a) at (1, 4) beside the unsharded encode; (c)
     corpus.encode_batch over devices ["cuda:0", "cuda:0"] == the
     one-device batch, and both timed; (d) parallel.launch scaling with
     NCCL at world size 1 (a subprocess; its JSON line); (e) two pairs of
     processes on the one card with gloo, side by side: launch corpus
     --num-hosts 2 over a 10-clip mixed-length corpus (manifests partition
     it, every .mrc == codec.encode) and a GroupShards encode at (1, 2), a
     seq shard in each process (streams == codec.encode; each exchange's
     host-clock ms)
 13. the bench: mrcaudiocodec_tpu_torch.bench.main(["--full", "--kernels"])
     in this process at its default sizes (the 30 s clip, the spec on
     4 s), with K1-K10's launch counts around it and their plain versions
     counted too (none may run), its device-resident decode K9, K1 x 2
     and K10 a slab and nothing else; its JSON line has the root bench.py's 11
     keys, the stream equals the port's spec's, segSNR and PSNR equal the
     spec's; every value logged beside the card's name and power limit
 14. one JSON line listing the kernels
The last line is {"ok": true, "device": {...}}. Without a CUDA card, or
without the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time

import numpy as np

# ---------------------------------------------------------------------------
# Inputs (copies of the repository's test and benchmark clip generators)
# ---------------------------------------------------------------------------


def make_golden_clip(fs, seconds, channels):
    rng = np.random.default_rng(12345)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * 330 * t)
         + 0.18 * np.sin(2 * np.pi * 1870 * t)).astype(np.float32)
    x += (0.015 * rng.standard_normal(n)).astype(np.float32)
    x[n // 3:n // 3 + 72] += (0.55 * rng.standard_normal(72)).astype(np.float32)
    x = np.clip(x, -1, 1)
    xi = np.clip(np.round(x * 32768.0), -32768, 32767).astype(np.int16)
    x = xi.astype(np.float32) / np.float32(32768.0)
    if channels == 2:
        return np.stack([x, np.roll(x, 13) * 0.85], 1)
    return x[:, None]


GOLDEN = [
    ("g1", 44100, 1, 96000, {},
     "ff3b0dc43fd0d13086f074705708a8b6e4b6b4fad36d0ecd720cc6ce1e8a3be9"),
    ("g2", 44100, 2, 128000, {},
     "ded8e52e57d05ddc1dc1d1584a1955432fced1dd309af734183bb0137cb8e641"),
    ("g3", 48000, 2, 192000, {},
     "301dab67db619b02f1d8f219eba0e163e8942db0a30a3bdc60d6e57a3ea2d16e"),
    ("g4", 44100, 1, 96000, {'window_switching': False},
     "60122258716993c3f2c3861a9c39562d86208eb803c561655346900e69ce9dfe"),
    ("g5_32k", 32000, 1, 64000, {},
     "b8c763155cdb68e1af709e3fa79b4e5a47901196d790e5b9106d67097366907a"),
    ("g6_kbd", 44100, 1, 96000, {'window': 'kbd'},
     "88e0688b2c6e3d5618dcde34f44b6d6ad3efde4e22a1a1c6d432277b7c6de9c8"),
]


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors/arrays of the same dtype."""
    import torch
    a = a.detach().cpu() if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    b = b.detach().cpu() if isinstance(b, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    """0 where the two are equal bit for bit (NaN and inf included)."""
    if bits_equal(a, b):
        return 0.0
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `iters` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def full_clip():
    """The benchmark clip and its config: 30 s stereo 44.1 kHz 128 kbps,
    int16."""
    from mrcaudiocodec_tpu_torch.bench import make_clip, to_i16
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    return (CodecConfig(fs=44100, channels=2, bitrate=128000),
            to_i16(make_clip(44100, 30.0, 2)))


KERNELS = ("fft_stages", "quant_cost", "record_pack", "rd_loop",
           "transients", "analysis_pre", "mdct_post", "psycho",
           "synth_pre", "synth_post")
ANALYSIS = ("transients", "analysis_pre", "mdct_post", "psycho")
SYNTHESIS = ("synth_pre", "synth_post")


def rd_loop_plain_all(*args):
    """K4's plain version with the payloads it needs from K2's plain
    version too: no kernel in the comparison."""
    from mrcaudiocodec_tpu_torch.ops import rd
    return plain_path(lambda: rd.rd_loop_plain(*args), ("quant_cost",))


def kernel_pair(name):
    """(kernel wrapper, plain version) of K1-K10 by name."""
    from mrcaudiocodec_tpu_torch.ops import device_pack
    from mrcaudiocodec_tpu_torch.ops.kernels import (
        analysis_pre, fft_stages, mdct_post, psycho, quant_cost, rd_loop,
        record_pack, synth_post, synth_pre, transients)
    return {"fft_stages": (fft_stages.fft_kernel, fft_stages.fft_plain),
            "synth_pre": (synth_pre.synth_pre_kernel,
                          synth_pre.synth_pre_plain),
            "synth_post": (synth_post.synth_post_kernel,
                           synth_post.synth_post_plain),
            "transients": (transients.transients_kernel,
                           transients.transients_plain),
            "analysis_pre": (analysis_pre.analysis_pre_kernel,
                             analysis_pre.analysis_pre_plain),
            "mdct_post": (mdct_post.mdct_post_kernel,
                          mdct_post.mdct_post_plain),
            "psycho": (psycho.psycho_kernel, psycho.psycho_plain),
            "quant_cost": (quant_cost.payload_bits_kernel,
                           quant_cost.payload_bits_plain),
            "record_pack": (record_pack.pack_stream_kernel,
                            device_pack.pack_stream_plain),
            "rd_loop": (rd_loop.rd_loop_kernel, rd_loop_plain_all)}[name]


def kernel_modules():
    """The kernel wrappers' modules, K1-K10 in order (KERNELS')."""
    from mrcaudiocodec_tpu_torch import profiling
    check(profiling.KERNEL_NAMES == KERNELS, "profiling.KERNEL_NAMES differ")
    return profiling.kernel_modules()


def rd_exits() -> int:
    """The RD loop's exit tests that have read the card so far (the port's
    `host_syncs.rd_exit` counter)."""
    from mrcaudiocodec_tpu_torch import trace
    return trace.counters().get("host_syncs.rd_exit", 0)


def plain_path(run, names=KERNELS):
    """run() with the named kernels' wrappers (default K1-K10) replaced by
    their plain PyTorch versions (on the same card) -> what run()
    returns. K4's plain version takes its payloads from K2's wrapper, so
    names=("rd_loop",) is the path before K4: the loop in PyTorch, K2 for
    every sweep."""
    from mrcaudiocodec_tpu_torch.ops import rd
    attrs = {"fft_stages": "fft_kernel", "quant_cost": "payload_bits_kernel",
             "record_pack": "pack_stream_kernel",
             "rd_loop": "rd_loop_kernel", **{n: f"{n}_kernel"
                                             for n in ANALYSIS + SYNTHESIS}}
    mods = dict(zip(KERNELS, kernel_modules()))
    swaps = [(mods[n], attrs[n], n) for n in names]
    saved = [getattr(mod, attr) for mod, attr, _ in swaps]
    try:
        for mod, attr, name in swaps:
            setattr(mod, attr, rd.rd_loop_plain if name == "rd_loop"
                    else kernel_pair(name)[1])
        return run()
    finally:
        for (mod, attr, _), orig in zip(swaps, saved):
            setattr(mod, attr, orig)


def hold_to_plain(caps, where, err):
    """Each captured input of caps (capture_inputs) through the kernel and
    its plain version, bitwise; err: max |err| by kernel, updated."""
    for key, args in caps.items():
        kernel, plain = kernel_pair(key[0])
        got, want = outputs(key[0], kernel(*args), plain(*args))
        ok = all(bits_equal(g, w) for g, w in zip(got, want))
        err[key[0]] = max([err[key[0]]] + [max_abs_err(g, w)
                                            for g, w in zip(got, want)])
        call = f" (call {key[2] + 1})" if len(key) > 2 else ""
        log(f"[kernels] {key[0]} on the {where} path's own input "
            f"{key[1]}{call}: kernel == plain bitwise: {ok}")
        check(ok, f"{key[0]} {key[1]}{call} ({where}) differs from its "
              f"plain version")


def main_path_inputs(dev):
    """The inputs K1-K10 get on the main path, captured at their wrappers:
    {"encode": one encode of the 30 s stereo clip (one chunk of 1293
    frames x 2 rows = 2586 frame rows), "decode": its decode (chunks of
    1024 and 269 frames x 2 rows, 2048 and 538 frame rows for K1, K9 and
    K10), "corpus": one 64 x 10 s stereo batch
    (128 rows x chunks of 64 frames = 8192 frame rows)}, each as
    capture_inputs gives it. K2 runs the inner sweep (G=32, then G=8) and
    K4 the loop after it."""
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch import corpus
    from mrcaudiocodec_tpu_torch.models import codec, decoder, encoder
    from mrcaudiocodec_tpu_torch.profiling import capture_inputs
    cfg, xi = full_clip()
    box = []
    out = {"encode": capture_inputs(
        lambda: box.append(codec.encode(xi, cfg, device=dev)))}
    out["decode"] = capture_inputs(lambda: codec.decode(box[0], device=dev))
    clips = corpus._synth_corpus(64, 10.0)
    out["corpus"] = capture_inputs(
        lambda: corpus.encode_batch(clips, cfg, device=dev))
    for where, caps in out.items():
        log(f"[kernels] {where}: kernel inputs captured at "
            f"{[(k[0], k[1]) for k in caps]}")
    # the frame rows of one chunk, from the encoder's own chunking
    rows = {"encode": cfg.channels * encoder.chunk_spans(
                C.frames_for_samples(xi.shape[0]), cfg.channels)[0][1],
            "corpus": 2 * len(clips) * encoder.chunk_spans(
                corpus.FRAME_BUCKET * -(-C.frames_for_samples(
                    clips[0].shape[0]) // corpus.FRAME_BUCKET),
                2 * len(clips))[0][1]}
    # the decode's chunks: DEC_CHUNK frames, then the rest, x 2 rows
    nf30 = C.frames_for_samples(xi.shape[0])
    for r in (cfg.channels * decoder.DEC_CHUNK,
              cfg.channels * (nf30 - decoder.DEC_CHUNK)):
        for name in SYNTHESIS:
            check((name, (r,)) in out["decode"],
                  f"decode: no kernel input at {(name, (r,))}")
    log(f"[kernels] decode: K9 and K10 inputs captured at "
        f"{cfg.channels * decoder.DEC_CHUNK} and "
        f"{cfg.channels * (nf30 - decoder.DEC_CHUNK)} frame rows")
    for where, r in rows.items():
        log(f"[kernels] {where}: {r} frame rows a chunk")
        for key in (("quant_cost", (r, 32)), ("quant_cost", (r, 8)),
                    ("rd_loop", (r,)), ("record_pack", (r,)),
                    ("analysis_pre", (r,)), ("mdct_post", (r,)),
                    ("psycho", (r,))):
            check(key in out[where], f"{where}: no kernel input at {key}")
    return out


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card():
    import torch
    from mrcaudiocodec_tpu_torch.profiling import card_line
    smi = card_line()
    cap = torch.cuda.get_device_capability(0)
    log(f"[card] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"capability {cap}; devices {torch.cuda.device_count()}")
    check(cap == (9, 0), f"need compute capability 9.0, got {cap}")
    return smi


def phase_build():
    from mrcaudiocodec_tpu_torch.ops.kernels import build
    t0 = time.perf_counter()
    logs = build.build(build.MAIN, force=True)
    log(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s "
        f"({' '.join(build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    log("[build] fft_stages: static shared memory per size (ptxas above); "
        "quant_cost: dynamic shared memory 8448 B per frame of the block "
        "(1 frame at G >= 4, 4 / G below), set at launch; record_pack: "
        "dynamic shared memory per warp of 128 B plus two staging buffers "
        "of cap rounded up to 4 B, warps per block from the cap "
        "(record_pack.warps_per_block); rd_loop: static shared memory "
        "for one frame a block (ptxas above); transients: static shared "
        "memory (ptxas above), a block of T + 2 warps a tile of T block "
        "types, T from the rows and frames (transients.tile_outputs: 10 "
        "at 2 x 1293, 13 at 128 x 64 on 132 SMs); analysis_pre: static "
        "shared memory, a block a frame; psycho: dynamic shared memory, two "
        "rows of 1056 words and one of 512 a warp, a warp a frame (below); "
        "mdct_post: none; synth_pre: static shared memory (4 KB, a "
        "frame's dequantized bins), a block a frame; synth_post: static "
        "shared memory (33 KB: 2 staged frames' coefficients and long "
        "window halves of 2 rows, the short window), a block a hop of 2 "
        "rows")
    from mrcaudiocodec_tpu_torch.ops.kernels import psycho, rd_loop
    resident = rd_loop.blocks_per_sm()
    log(f"[build] rd_loop: {resident} blocks (of 128 threads) resident an "
        f"SM by the occupancy calculator; the design asks for 7")
    check(resident >= 7, f"rd_loop holds {resident} blocks an SM, not 7")
    warps, smem, blocks = psycho.occupancy()
    log(f"[build] psycho: {smem} B of dynamic shared memory a block of "
        f"{warps} warps, {blocks} blocks ({warps * blocks} frames in "
        f"flight) an SM by the occupancy calculator; the design asks for 2 "
        f"(20 frames)")
    check(warps * blocks >= 20, f"psycho holds {warps * blocks} frames an "
          f"SM, not 20")


def phase_kernels(dev):
    """Each kernel against its plain version, bitwise: on random inputs,
    then on the main path's own (main_path_inputs). -> (max |err| each,
    those inputs)."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch import tables as T
    from mrcaudiocodec_tpu_torch.ops.kernels import fft_stages, quant_cost
    rng = np.random.default_rng(2024)
    log("[kernels] tolerance 0: kernel and plain outputs must be equal bit "
        "for bit (f32 compared as int32 patterns)")
    err = {"fft_stages": 0.0, "quant_cost": 0.0, "rd_loop": 0.0}
    rows = 2600
    for n in fft_stages.FFT_SIZES:
        shape = (rows, n) if n >= 512 else (rows, 8, n)
        zr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        zi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        kr, ki = fft_stages.fft_kernel(zr.to(dev), zi.to(dev))
        pr, pi = fft_stages.fft_plain(zr.to(dev), zi.to(dev))
        cr, ci = fft_stages.fft_plain(zr, zi)
        torch.cuda.synchronize()
        ok = (bits_equal(kr, pr) and bits_equal(ki, pi)
              and bits_equal(kr, cr) and bits_equal(ki, ci))
        e = max(max_abs_err(kr, cr), max_abs_err(ki, ci))
        err["fft_stages"] = max(err["fft_stages"], e)
        log(f"[kernels] fft_stages n={n} shape={shape}: kernel == plain "
            f"(card, CPU) bitwise: {ok}")
        check(ok, f"fft_stages n={n} differs from its plain version")
    nf = 192
    for fs in (44100, 48000, 32000):
        nb = T.unified_layout(fs)["nb"]
        for g in (32, 8, 4, 1):
            for amp_kind in ("zero", "random"):
                scale = 10.0 ** rng.uniform(-3, 2.5, (nf, 1))
                x = (rng.standard_normal((nf, C.LONG_COEFFS)) * scale
                     ).astype(np.float32)
                x[0] = 0.0
                bt = (np.arange(nf) % C.N_BLOCK_TYPES).astype(np.int32)
                amp = (np.zeros((nf, nb), np.int32) if amp_kind == "zero"
                       else rng.integers(0, C.AMP_MAX + 1, (nf, nb)
                                         ).astype(np.int32))
                if g == 32:
                    gains = np.broadcast_to(np.arange(0, 256, 8, dtype=np.int32),
                                            (nf, 32)).copy()
                else:
                    gains = rng.integers(0, 256, (nf, g)).astype(np.int32)
                lay = T.unified_layout(fs)
                amp_bin = np.take_along_axis(amp, lay["bin_band"][bt], 1)
                args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                        for a in (x, amp_bin, gains, bt)]
                kb = quant_cost.payload_bits_kernel(*args, fs)
                pb = quant_cost.payload_bits_plain(*args, fs)
                torch.cuda.synchronize()
                ok = bits_equal(kb, pb)
                err["quant_cost"] = max(err["quant_cost"], max_abs_err(kb, pb))
                log(f"[kernels] quant_cost fs={fs} G={g} amp={amp_kind}: "
                    f"kernel == plain bitwise: {ok}")
                check(ok, f"quant_cost fs={fs} G={g} amp={amp_kind} differs")
    err["record_pack"] = phase_kernels_record_pack(dev, rng)
    phase_analysis(dev, err)
    phase_synthesis(dev, err)
    # the kernels on the inputs the main path gives them
    inputs = main_path_inputs(dev)
    for where, caps in inputs.items():
        hold_to_plain(caps, where, err)
        for key, args in caps.items():
            if key[0] == "rd_loop":
                log_rd_corners(f"{where} {key[1]}", args)
    before = None
    for key, args in inputs["decode"].items():
        if key[0] == "synth_post":
            n = hold_k10(f"decode {key[1]}", args[:4], args[4], args[5],
                         before, err)
            log(f"[kernels] synth_post on the decode's own input {key[1]} "
                f"(prev {'given' if args[7] is not None else 'null'} on "
                f"the main path): kernel == plain bitwise in {n} "
                f"comparisons (R = 1, 2, 3, f32 and int16, prev null, the "
                f"previous chunk's, +-0 / inf / NaN)")
            before = (args[:4], args[4])
    rd_sets = phase_kernels_rd_loop(dev, inputs, err)
    return err, inputs, rd_sets


def log_rd_corners(where, args):
    """How many of K4's frames on these inputs reach each corner of the
    loop (the plain version's per-frame counts) -> those counts."""
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.ops import rd
    st = {k: v.cpu() for k, v in rd.loop_counts(*args).items()}
    outer = st["outer"]
    n = {"frames": int(outer.numel()), "loop ran": int((outer > 0).sum()),
         "fallback": int((st["fallbacks"] > 0).sum()),
         "at OUTER_MAX": int((outer == C.OUTER_MAX - 1).sum()),
         "outer iterations": int(outer.sum()),
         "candidates": int(st["cands"].sum()),
         "budget-0 rows": int((args[2] == -C.FRAME_LEN_BITS - 7).sum())}
    log(f"[kernels] rd_loop corners, {where}: {json.dumps(n)}; frames at "
        f"the most amplification the loop can give (AMP_STEP x (OUTER_MAX - "
        f"1) = {C.AMP_STEP * (C.OUTER_MAX - 1)}, so AMP_MAX = {C.AMP_MAX} is "
        f"out of reach): those at OUTER_MAX")
    return n


def rd_loop_args(x, allowed, budget_content, bt, fs):
    """K4's arguments for these frames, gain0 and bits0 from the inner
    sweep on the card (K2), as rd_batch makes them."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.ops import rd
    nf, nb = allowed.shape
    zeros = torch.zeros((nf, nb), dtype=torch.int32, device=x.device)
    zbin = torch.zeros((nf, C.LONG_COEFFS), dtype=torch.int32,
                       device=x.device)
    bt = bt.contiguous()
    gain0, bits0 = rd.inner_gain_search(x, zeros, budget_content, bt, fs,
                                        zbin)
    return (x.contiguous(), allowed.contiguous(), budget_content.contiguous(),
            bt, gain0.contiguous(), bits0.contiguous(), fs)


def phase_kernels_rd_loop(dev, inputs, err):
    """K4 against its plain version (K2's payloads plain too), bitwise, on
    RD corner sets, each logged with how many frames reach each corner:
    the inputs a 4 s stereo encode gives K4 at 16 kbps 48 kHz (starved:
    the GAIN_MAX fallback) and at 320 kbps 44.1 kHz (lavish); the 30 s
    clip's chunk with every frame SHORT, with every third row a silent
    pad frame of budget 0, and with allowed noise a millionth (frames run
    every outer iteration); 256 rows of each on the CPU too; then 20
    repeated launches on the 30 s chunk. -> {name: K4's arguments} of the
    30 s chunk and each corner set, for phase 4's k4_locate."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.bench import make_clip
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec
    from mrcaudiocodec_tpu_torch.ops import rd
    from mrcaudiocodec_tpu_torch.ops.kernels import rd_loop
    from mrcaudiocodec_tpu_torch.profiling import capture_inputs
    card_table = rd_loop.pow43_table(dev)
    ok = bits_equal(card_table, rd_loop.pow43_table("cpu"))
    log(f"[kernels] rd_loop: the |q|^(4/3) table ({card_table.numel()} "
        f"entries) built on the card == built on the CPU, bitwise: {ok}")
    check(ok, "rd_loop's table differs between the card and the CPU")
    sets = {}
    for name, fs, rate in (("starved 16 kbps stereo 48 kHz", 48000, 16000),
                           ("lavish 320 kbps stereo 44.1 kHz", 44100,
                            320000)):
        cfg = CodecConfig(fs=fs, channels=2, bitrate=rate)
        clip = make_clip(fs, 4.0, 2, seed=5)
        caps = capture_inputs(lambda: codec.encode(clip, cfg, device=dev))
        sets[name] = next(a for k, a in caps.items() if k[0] == "rd_loop")
    base = next(a for k, a in inputs["encode"].items() if k[0] == "rd_loop")
    x, allowed, bc, bt, _, _, fs = base
    sets["30 s chunk, every frame SHORT"] = rd_loop_args(
        x, allowed, bc, torch.full_like(bt, C.SHORT), fs)
    pad = (torch.arange(x.shape[0], device=x.device) % 3 == 1)
    sets["30 s chunk, every third row a silent budget-0 pad frame"] = \
        rd_loop_args(torch.where(pad[:, None], 0.0, x),
                     torch.where(pad[:, None], 0.0, allowed),
                     torch.where(pad, -C.FRAME_LEN_BITS - 7, bc).to(
                         torch.int32),
                     torch.where(pad, C.LONG, bt).to(torch.int32), fs)
    sets["30 s chunk, allowed noise a millionth"] = rd_loop_args(
        x, allowed * 1e-6, bc, bt, fs)
    need = {"starved 16 kbps stereo 48 kHz": "fallback",
            "30 s chunk, allowed noise a millionth": "at OUTER_MAX",
            "30 s chunk, every third row a silent budget-0 pad frame":
                "budget-0 rows"}
    for name, args in sets.items():
        got, want = outputs("rd_loop", rd_loop.rd_loop_kernel(*args),
                            rd_loop_plain_all(*args))
        ok = all(bits_equal(g, w) for g, w in zip(got, want))
        cpu = [a[:256].cpu() if isinstance(a, torch.Tensor) else a
               for a in args]
        ok_cpu = all(bits_equal(g[:256], w) for g, w in
                     zip(got, rd.rd_loop_plain(*cpu)))
        err["rd_loop"] = max([err["rd_loop"]] + [max_abs_err(g, w)
                                                 for g, w in zip(got, want)])
        log(f"[kernels] rd_loop on {name} ({args[0].shape[0]} rows, fs "
            f"{args[6]}): kernel == plain bitwise on the card: {ok}; first "
            f"256 rows == plain on the CPU: {ok_cpu}")
        check(ok and ok_cpu, f"rd_loop differs from its plain version on "
              f"{name}")
        n = log_rd_corners(name, args)
        check(n["loop ran"] > 0, f"rd_loop: the loop never ran on {name}")
        if name in need:
            check(n[need[name]] > 0, f"rd_loop: no frame reached "
                  f"'{need[name]}' on {name}")
    first = rd_loop.rd_loop_kernel(*base)
    same = 0
    for _ in range(20):
        same += all(torch.equal(g, w) for g, w in
                    zip(rd_loop.rd_loop_kernel(*base), first))
    log(f"[kernels] rd_loop: 20 repeated launches on the 30 s chunk "
        f"({base[0].shape[0]} rows) identical to the first: {same}/20")
    check(same == 20, "rd_loop gave different outputs on a repeat")
    return {"30 s chunk": base, **sets}


def analysis_cases():
    """The analysis kernels' input chunks -> [(name, cfg, hop rows [R,
    (s + 3) * HOP] as numpy, row slice or None)]: the 30 s clip's chunk
    (2586 frame rows); the 64 x 10 s corpus batch's last chunk (8192 frame
    rows, with the bucket's silent pad frames); config 3's second chunk
    (48 kHz stereo 192 kbps); 32 kHz; the kbd window; window switching
    off; full psycho off; an all-silent chunk; a chunk dense with
    transients (SHORT frames); and the 30 s rows as a column slice of the
    whole padded clip, as the sharded path hands them over (rows with a
    stride of their own)."""
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch import corpus
    from mrcaudiocodec_tpu_torch.bench import make_clip, to_i16
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import encoder

    def chunk(x, cfg, which=0):
        nf = C.frames_for_samples(x.shape[0])
        P = encoder._padded_rows(x, nf)
        spans = encoder.chunk_spans(nf, P.shape[0])
        f0, s = spans[which]
        return P[:, f0 * C.HOP:(f0 + s + 3) * C.HOP]

    cfg, xi = full_clip()
    cases = [("30 s clip", cfg, chunk(xi, cfg), None)]
    clips = corpus._synth_corpus(64, 10.0)
    nch = 2
    nf_list = [C.frames_for_samples(c.shape[0]) for c in clips]
    nf = -(-max(nf_list) // corpus.FRAME_BUCKET) * corpus.FRAME_BUCKET
    P = np.zeros((len(clips) * nch, (nf + 6) * C.HOP), np.float32)
    for i, c in enumerate(clips):
        P[i * nch:(i + 1) * nch, 2 * C.HOP:2 * C.HOP + c.shape[0]] = c.T
    f0, s = encoder.chunk_spans(nf, P.shape[0])[-1]
    check(f0 + s > max(nf_list), "the corpus chunk holds no pad frame")
    cases.append(("64 x 10 s corpus, last chunk (pad frames)", cfg,
                  P[:, f0 * C.HOP:(f0 + s + 3) * C.HOP], None))
    cfg3 = CodecConfig(fs=48000, channels=2, bitrate=192000)
    cases.append(("config 3 (48 kHz, 192 kbps), second chunk", cfg3,
                  chunk(to_i16(make_clip(48000, 120.0, 2, seed=3)), cfg3,
                        1), None))
    x10 = to_i16(make_clip(44100, 10.0, 2, seed=7))
    for name, fs, kw in (("32 kHz", 32000, {}), ("kbd window", 44100,
                                                 {"window": "kbd"}),
                         ("window switching off", 44100,
                          {"window_switching": False}),
                         ("full psycho off", 44100, {"full_psycho": False})):
        c = CodecConfig(fs=fs, channels=2, bitrate=128000, **kw)
        x = x10 if fs == 44100 else to_i16(make_clip(fs, 10.0, 2, seed=8))
        cases.append((name, c, chunk(x, c), None))
    cases.append(("all silent", cfg, chunk(np.zeros((44100 * 5, 2),
                                                    np.int16), cfg), None))
    rng = np.random.default_rng(11)
    xt = (0.01 * rng.standard_normal((44100 * 5, 2))).astype(np.float32)
    for pos in range(300, xt.shape[0] - 200, 1500):
        xt[pos:pos + 40] += (0.8 * rng.standard_normal((40, 2))).astype(
            np.float32)
    cases.append(("transient-dense", cfg, chunk(np.clip(xt, -1, 1), cfg),
                  None))
    nf30 = C.frames_for_samples(xi.shape[0])
    cases.append(("30 s rows as a strided slice (frames 100-599)", cfg,
                  encoder._padded_rows(xi, nf30),
                  slice(100 * C.HOP, (100 + 500 + 3) * C.HOP)))
    return cases


def phase_analysis(dev, err):
    """K5-K8 against their plain versions on the card, bitwise, on each
    of analysis_cases(): K5 on the hop rows; K6 on the rows and the plain
    block types; K7 and K8 on K1's outputs of K6's plain outputs (K8 with
    the plain coefficients); then the whole kernel path of
    encoder._analyze_chunk on the card against the eager chain on the
    CPU, every output. err: max |err| by kernel, updated."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.models import encoder
    from mrcaudiocodec_tpu_torch.ops.kernels import (
        analysis_pre, fft_stages, mdct_post, psycho, transients)
    for name in ANALYSIS:
        err.setdefault(name, 0.0)

    def hold(kname, where, got, want):
        got, want = outputs(kname, got, want)
        ok = all(bits_equal(g, w) for g, w in zip(got, want))
        e = max(max_abs_err(g, w) for g, w in zip(got, want))
        err[kname] = max(err[kname], e)
        if not ok:
            for i, (g, w) in enumerate(zip(got, want)):
                g, w = g.cpu(), w.cpu()
                if g.dtype == torch.float32:
                    g, w = g.view(torch.int32), w.view(torch.int32)
                bad = (g != w).nonzero()
                if len(bad):
                    idx = tuple(bad[0].tolist())
                    log(f"[analysis] {kname} {where}: output {i} differs at "
                        f"{len(bad)} places, first {idx}: kernel "
                        f"{got[i].cpu()[idx].item()!r} plain "
                        f"{want[i].cpu()[idx].item()!r}")
        return ok

    t0 = time.perf_counter()
    for name, cfg, rows, cols in analysis_cases():
        full = torch.from_numpy(np.ascontiguousarray(rows)).to(dev)
        audio = full if cols is None else full[:, cols]
        r, s = audio.shape[0], audio.shape[1] // C.HOP - 3
        ws = cfg.window_switching
        bt_p = transients.transients_plain(audio, ws)
        ok = {"transients": hold("transients", name,
                                 transients.transients_kernel(audio, ws),
                                 bt_p)}
        pre_p = analysis_pre.analysis_pre_plain(audio, bt_p, cfg.window)
        ok["analysis_pre"] = hold(
            "analysis_pre", name,
            analysis_pre.analysis_pre_kernel(audio, bt_p, cfg.window),
            pre_p)
        spec = [fft_stages.fft_kernel(pre_p[i], pre_p[i + 1])
                for i in range(0, 8, 2)]
        btf = bt_p.reshape(-1)
        co_p = mdct_post.mdct_post_plain(*spec[0], *spec[1], btf)
        ok["mdct_post"] = hold(
            "mdct_post", name,
            mdct_post.mdct_post_kernel(*spec[0], *spec[1], btf), co_p)
        args = (*spec[2], *spec[3], co_p, btf, cfg.fs, cfg.full_psycho)
        ok["psycho"] = hold("psycho", name, psycho.psycho_kernel(*args),
                            psycho.psycho_plain(*args))
        card = encoder._analyze_chunk(audio, cfg)
        cpu = encoder._analyze_chunk(audio.cpu(), cfg)
        torch.cuda.synchronize()
        ok["card == CPU"] = all(bits_equal(a, b) for a, b in zip(card, cpu))
        n_short = int((bt_p == C.SHORT).sum())
        log(f"[analysis] {name}: {r} rows x {s} frames "
            f"({'int16' if audio.dtype == torch.int16 else 'f32'}, fs "
            f"{cfg.fs}, {cfg.window}, window switching {ws}, full psycho "
            f"{cfg.full_psycho}; {n_short} SHORT frames): kernel == plain "
            f"bitwise {json.dumps(ok)}")
        for k, v in ok.items():
            check(v, f"{k} differs on '{name}'")
        del full, audio, pre_p, spec, card, cpu
    torch.cuda.empty_cache()
    log(f"[analysis] every case held in {time.perf_counter() - t0:.1f} s")


def synthesis_cases(dev):
    """K9's and K10's input slabs -> [(name, fs, window, [(q, e_band, bt)
    numpy slabs], stream or None)]: the goldens g1-g6 (44.1, 48 and 32
    kHz, mono and stereo, window switching off, the kbd window), a 48 kHz
    and a 32 kHz stereo stream, the kbd window in stereo, a SHORT-dense
    stream, a stream silent from 1/8 of its length at DEC_CHUNK 5 (-0
    samples across the seams), and the crafted escapes beyond QMAX of
    tests/test_torch_hardening.py (exponents 14, 15 and 18; the int16 slab
    gives -16507, -32768 and 0) as two-frame slabs."""
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch import native
    from mrcaudiocodec_tpu_torch import tables as T
    from mrcaudiocodec_tpu_torch.bench import make_clip
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec, decoder
    from mrcaudiocodec_tpu_torch.utils.bits import BitWriter
    out = []

    def add(name, x, cfg, chunk=None):
        bs = codec.encode(x, cfg, device=dev)
        saved = decoder.DEC_CHUNK
        decoder.DEC_CHUNK = chunk or saved
        try:
            slabs = decoder.record_slabs(bs)
        finally:
            decoder.DEC_CHUNK = saved
        out.append((name, cfg.fs, cfg.window, slabs, bs, chunk))

    for name, fs, ch, br, kw, _ in GOLDEN:
        add(f"golden {name}", make_golden_clip(fs, 0.7, ch),
            CodecConfig(fs=fs, channels=ch, bitrate=br, **kw))
    for fs, kw in ((48000, {}), (32000, {}), (44100, {"window": "kbd"})):
        add(f"{fs} Hz {kw.get('window', 'sine')} stereo",
            make_clip(fs, 3.0, 2, seed=9),
            CodecConfig(fs=fs, channels=2, bitrate=128000, **kw))
    rng = np.random.default_rng(11)
    xt = (0.01 * rng.standard_normal((44100 * 3, 2))).astype(np.float32)
    for pos in range(300, xt.shape[0] - 200, 1500):
        xt[pos:pos + 40] += (0.8 * rng.standard_normal((40, 2))).astype(
            np.float32)
    add("SHORT-dense", np.clip(xt, -1, 1),
        CodecConfig(fs=44100, channels=2, bitrate=128000))
    xf = make_clip(44100, 0.5, 2, seed=4)
    xf[xf.shape[0] // 8:] = 0.0
    add("silence across seams at DEC_CHUNK 5", xf,
        CodecConfig(fs=44100, channels=2, bitrate=128000), chunk=5)
    lay, ca = T.unified_layout(44100), T.code_arrays()
    real = np.where(lay["width"][C.LONG] > 0)[0]
    for run, suffix in ((10, 123), (11, 0), (14, 0)):
        w = BitWriter()
        w.write(C.LONG, C.BLOCK_TYPE_BITS)
        w.write(100, C.GAIN_BITS)
        for b in real:
            w.write(C.CB_ESC if b == real[0] else C.CB_ZERO, C.CB_BITS)
        for _ in real:
            w.write(int(ca["codes_sf"][C.SF_DELTA_MAX]),
                    int(ca["len_sf"][C.SF_DELTA_MAX]))
        sym = 16 * (C.ESC_MAG + 1)
        w.write(int(ca["codes_esc"][sym]), int(ca["len_esc"][sym]))
        w.write(1, 1)
        w.write((1 << run) - 1, run)
        w.write(0, 1)
        w.write(suffix, 4 + run)
        w.write(0, 64)
        q, e, bt, _ = native.decode_records(w.getvalue() + bytes(8),
                                            np.zeros(1, np.int64), 44100)
        slab = tuple(np.ascontiguousarray(np.repeat(a[None], 2, 1))
                     for a in (q.astype(np.int16), e.astype(np.int16),
                               bt.astype(np.int8)))
        out.append((f"escape beyond QMAX (exponent {4 + run}, q "
                    f"{int(q[0, 0])} -> int16 {int(slab[0][0, 0, 0])})",
                    44100, "sine", [slab], None, None))
    return out


def special_tail(rows, dev):
    """A previous chunk's tail [rows, 1024] f32 holding +0, -0, +-inf and
    NaN among ordinary values."""
    import torch
    t = (np.random.default_rng(rows).standard_normal((rows, 1024))
         * 0.3).astype(np.float32)
    t[:, 0::5] = 0.0
    t[:, 1::5] = -0.0
    t[:, 2::17] = np.inf
    t[:, 3::19] = -np.inf
    t[:, 4::23] = np.nan
    return torch.from_numpy(t).to(dev)


def k10_rows(spec, bt, rows):
    """K10's inputs for the rows `rows` (a row may repeat) of a chunk:
    (K1's four planes, bt) -> the same of len(rows) rows."""
    import torch
    r, s = bt.shape
    sel = torch.tensor(rows, device=bt.device)
    planes = tuple(p.reshape((r, s) + p.shape[1:])[sel].reshape(
        (len(rows) * s,) + p.shape[1:]).contiguous() for p in spec)
    return planes, bt[sel].contiguous()


def hold_k10(where, spec, bt, window, prev_chunk, err):
    """K10 == its plain version on the card, bitwise, on a chunk's K1
    outputs (spec) and bt at R = 1, 2 and 3 rows (rows 0; 0, 1; 0, 1, 0
    of the chunk, modulo its rows), f32 and int16 PCM, with prev null, the
    real previous chunk's tail (prev_chunk: that chunk's (spec, bt), None
    for a chunk that opens its stream) and a tail holding +-0, +-inf and
    NaN. err: max |err| by kernel, updated. -> the comparisons made."""
    from mrcaudiocodec_tpu_torch.ops.kernels import synth_post
    r = bt.shape[0]
    n = 0
    for rr in (1, 2, 3):
        rows = [i % r for i in range(rr)]
        planes, b = k10_rows(spec, bt, rows)
        tails = {"null": None, "+-0, inf, NaN": special_tail(rr, bt.device)}
        if prev_chunk is not None:
            pp, pb = k10_rows(*prev_chunk, rows)
            tails["the previous chunk's"] = synth_post.synth_post_plain(
                *pp, pb, window, False)[2]
        for name, tail in tails.items():
            for pcm16 in (False, True):
                got, want = outputs("synth_post", synth_post.synth_post_kernel(
                    *planes, b, window, pcm16, tail),
                    synth_post.synth_post_plain(*planes, b, window, pcm16,
                                                tail))
                ok = all(bits_equal(g, w) for g, w in zip(got, want))
                err["synth_post"] = max([err["synth_post"]] + [
                    max_abs_err(g, w) for g, w in zip(got, want)])
                check(ok, f"synth_post differs from its plain version on "
                      f"'{where}' at R = {rr}, prev {name}, "
                      f"{'int16' if pcm16 else 'f32'}")
                n += 1
    return n


def phase_synthesis(dev, err):
    """K9 and K10 against their plain versions on the card, bitwise, on
    every slab of synthesis_cases(): K9 on the records, K10 on K1's
    outputs of K9's plain outputs (hold_k10: R = 1, 2, 3 rows, f32 and
    int16 PCM, prev null, the previous slab's tail or a tail of +-0, inf
    and NaN); then each stream's card decode (f32 and int16, at the case's
    DEC_CHUNK) == its CPU decode. err: max |err| by kernel, updated."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.models import codec, decoder
    from mrcaudiocodec_tpu_torch.ops.kernels import fft_stages, synth_pre
    for name in SYNTHESIS:
        err.setdefault(name, 0.0)

    def hold(kname, where, got, want):
        got, want = outputs(kname, got, want)
        ok = all(bits_equal(g, w) for g, w in zip(got, want))
        err[kname] = max([err[kname]] + [max_abs_err(g, w)
                                         for g, w in zip(got, want)])
        check(ok, f"{kname} differs from its plain version on '{where}'")
        return ok

    t0 = time.perf_counter()
    for name, fs, window, slabs, bs, chunk in synthesis_cases(dev):
        rows, held, before = 0, 0, None
        for slab in slabs:
            args = tuple(torch.from_numpy(a).to(dev) for a in slab)
            rows = max(rows, args[2].numel())
            pre = synth_pre.synth_pre_plain(*args, fs)
            hold("synth_pre", name, synth_pre.synth_pre_kernel(*args, fs),
                 pre)
            spec = (*fft_stages.fft_kernel(*pre[:2]),
                    *fft_stages.fft_kernel(*pre[2:]))
            held += hold_k10(name, spec, args[2], window, before, err)
            before = (spec, args[2])
        n_short = sum(int((s[2] == C.SHORT).sum()) for s in slabs)
        same = "no stream"
        if bs is not None:
            saved = decoder.DEC_CHUNK
            decoder.DEC_CHUNK = chunk or saved
            try:
                same = all(bits_equal(codec.decode(bs, device=dev,
                                                   pcm_dtype=d)[0],
                                      codec.decode(bs, device="cpu",
                                                   pcm_dtype=d)[0])
                           for d in ("float32", "int16"))
            finally:
                decoder.DEC_CHUNK = saved
            check(same, f"'{name}': the card decode differs from the CPU's")
        log(f"[synthesis] {name}: {len(slabs)} slabs (up to {rows} frame "
            f"rows, {n_short} SHORT frames; fs {fs}, {window}): K9 and K10 "
            f"== plain bitwise: True (K10 in {held} comparisons: R = 1, 2, "
            f"3, f32 and int16, prev null, the previous slab's, +-0 / inf "
            f"/ NaN); card decode == CPU decode (f32, int16): {same}")
    log(f"[synthesis] every case held in {time.perf_counter() - t0:.1f} s")


def outputs(name, got, want):
    """A kernel's and its plain version's outputs as tuples to compare,
    after a synchronize: K3's body cut to the `total` bytes the plain
    version's status gives (the kernel writes nothing past them)."""
    import torch
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name == "record_pack":
        total = int(want[2][0])
        got = (got[0][:total],) + got[1:]
        want = (want[0][:total],) + want[1:]
    return got, want


def record_orders(n, rng):
    """Stream orders over n records: in turn, shuffled, and one that skips
    about a third of them (the corpus batch's pad frames), shuffled."""
    keep = np.flatnonzero(rng.random(n) < 0.66)
    keep = keep if len(keep) else np.arange(1)
    return {"in turn": np.arange(n), "shuffled": rng.permutation(n),
            "skipping": rng.permutation(keep)}


def tiled_decisions(rng, n, fs):
    """random_decisions for n records, tiled from at most 4096."""
    from mrcaudiocodec_tpu_torch.ops.kernels import record_pack
    base = record_pack.random_decisions(rng, min(n, 4096), fs)
    reps = -(-n // len(base[0]))
    return [np.ascontiguousarray(np.concatenate([v] * reps)[:n])
            for v in base]


def phase_kernels_record_pack(dev, rng):
    """K3 against its plain version (on the card, and on the CPU up to 600
    records), bitwise: random decisions at each fs in three stream orders
    at record counts around a warp and a tile and up to 65536 (long
    look-back chains), 20 repeated launches on one input, and a cap one
    byte too small, which must raise. -> max |err|."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.ops import device_pack
    from mrcaudiocodec_tpu_torch.ops.kernels import record_pack
    cap = 4096
    tile = record_pack.warps_per_block(cap)
    err, cases = 0.0, 0
    for fs in (44100, 48000, 32000):
        d = record_pack.random_decisions(rng, 600, fs)
        q, cb, bt = np.abs(d[0].astype(np.int64)), d[4], d[3]
        check(set(bt.tolist()) == set(range(C.N_BLOCK_TYPES))
              and set(np.unique(cb).tolist()) == set(range(C.N_CODEBOOKS))
              and q.max() == C.QMAX and (q == C.ESC_MAG).any(),
              f"random decisions at fs={fs} miss a slot kind")
        for n in (1, 31, 32, 33, tile - 1, tile, tile + 1, 600, 8192, 65536):
            if n == 600:
                dn = d
            elif n <= 600:
                dn = [v[:n] for v in d]
            else:
                dn = tiled_decisions(rng, n, fs)
            dc = [torch.from_numpy(v).to(dev) for v in dn]
            for kind, order in record_orders(n, rng).items():
                oc = torch.from_numpy(order.astype(np.int32))
                args = (*dc, oc.to(dev), fs, cap)
                got, want = outputs(
                    "record_pack", record_pack.pack_stream_kernel(*args),
                    device_pack.pack_stream_plain(*args))
                ok = all(bits_equal(g, w) for g, w in zip(got, want))
                if n <= 600:
                    _, cpu = outputs("record_pack", got,
                                     device_pack.pack_stream_plain(
                                         *[t.cpu() for t in dc], oc, fs, cap))
                    ok = ok and all(bits_equal(g, w)
                                    for g, w in zip(got, cpu))
                err = max([err] + [max_abs_err(g, w)
                                   for g, w in zip(got, want)])
                cases += 1
                if n in (600, 65536) or not ok:
                    log(f"[kernels] record_pack fs={fs} {n} records, order "
                        f"{kind} ({len(order)} packed), cap {cap}, "
                        f"{int(want[2][0])} bytes: kernel == plain (card"
                        f"{', CPU' if n <= 600 else ''}) bitwise: {ok}")
                check(ok, f"record_pack fs={fs} n={n} order {kind} differs "
                      f"from its plain version")
    log(f"[kernels] record_pack: {cases} cases (3 fs x record counts 1, 31, "
        f"32, 33, {tile - 1}, {tile}, {tile + 1} (a tile of {tile} at cap "
        f"{cap}), 600, 8192, 65536 x orders in turn, shuffled, skipping) all "
        f"bitwise equal")
    # 20 launches on one input: the same bytes every time
    dc = [torch.from_numpy(v).to(dev) for v in tiled_decisions(rng, 8192,
                                                               44100)]
    oc = torch.from_numpy(record_orders(8192, rng)["skipping"].astype(
        np.int32)).to(dev)
    first = record_pack.pack_stream_kernel(*dc, oc, 44100, cap)
    total = int(first[2][0])
    same = 0
    for _ in range(20):
        b, nb_, st = record_pack.pack_stream_kernel(*dc, oc, 44100, cap)
        same += bool(torch.equal(b[:total], first[0][:total])
                     and torch.equal(nb_, first[1])
                     and torch.equal(st, first[2]))
    log(f"[kernels] record_pack: 20 repeated launches on 8192 records "
        f"({len(oc)} packed, {total} bytes) identical to the first: {same}/20")
    check(same == 20, "record_pack gave different bytes on a repeat")
    need = int(first[2][1])                  # its longest record
    try:
        record_pack.pack_stream_kernel(*dc, oc, 44100, need - 1)
        raised = False
    except ValueError as e:
        raised = "more than cap" in str(e)
    log(f"[kernels] record_pack with cap {need - 1} for a {need}-byte "
        f"record raises: {raised}")
    check(raised, "record_pack did not raise for a too-small cap")
    return err


def phase_goldens(dev):
    import torch
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec
    from mrcaudiocodec_tpu_torch.ops.kernels import record_pack
    record_pack.launches = 0
    for name, fs, ch, br, kw, digest in GOLDEN:
        cfg = CodecConfig(fs=fs, channels=ch, bitrate=br, **kw)
        bs = codec.encode(make_golden_clip(fs, 0.7, ch), cfg, device=dev)
        got = hashlib.sha256(bs).hexdigest()
        y_card, _ = codec.decode(bs, device=dev)
        y_cpu, _ = codec.decode(bs, device="cpu")
        same = bits_equal(y_card, y_cpu)
        log(f"[goldens] {name}: digest match {got == digest}; card decode == "
            f"CPU decode bitwise {same}")
        check(got == digest, f"golden {name}: {got} != {digest}")
        check(same, f"golden {name}: card and CPU decodes differ")
    torch.cuda.synchronize()
    log(f"[goldens] records built on the card: {record_pack.launches} "
        f"record_pack launches for the six encodes")
    check(record_pack.launches >= len(GOLDEN),
          "the golden encodes did not pack their records with record_pack")


def phase_card_vs_cpu(dev):
    from mrcaudiocodec_tpu_torch.bench import make_clip
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec, encoder, packing
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    x = make_clip(44100, 4.0, 2, seed=4)
    t0 = time.perf_counter()
    bs_card = codec.encode(x, cfg, device=dev)
    t1 = time.perf_counter()
    bs_cpu = codec.encode(x, cfg, device="cpu")
    t2 = time.perf_counter()
    dec, nf = encoder.encode_arrays(x, cfg, device=dev)
    bs_host = packing.pack_stream(dec, nf, x.shape[0], cfg)
    y_card, _ = codec.decode(bs_card, device=dev)
    y_cpu, _ = codec.decode(bs_cpu, device="cpu")
    same_pcm = bits_equal(y_card, y_cpu)
    log(f"[card-vs-cpu] 4 s stereo: device-packed card stream == "
        f"host-packed card stream {bs_card == bs_host}, == CPU stream "
        f"{bs_card == bs_cpu} ({len(bs_card)} bytes; card {t1 - t0:.2f} s, "
        f"CPU {t2 - t1:.2f} s host clock); decodes bitwise equal {same_pcm}")
    check(bs_card == bs_host, "device-packed and host-packed streams differ")
    check(bs_card == bs_cpu, "card and CPU streams differ")
    check(same_pcm, "card and CPU decodes differ")


def phase_full(dev):
    """Main path at full size; returns (launch counts, stats)."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.bench import segmental_snr
    from mrcaudiocodec_tpu_torch.models import codec, decoder, encoder
    from mrcaudiocodec_tpu_torch.ops import rd
    seconds = 30.0
    cfg, xi = full_clip()
    x = xi.astype(np.float32) / np.float32(32768.0)
    chunks = len(encoder.chunk_spans(C.frames_for_samples(xi.shape[0]),
                                     cfg.channels))
    dec_chunks = -(-C.frames_for_samples(xi.shape[0]) // decoder.DEC_CHUNK)

    kernels = kernel_modules()
    plain_loops = [0]
    orig_plain = rd.rd_loop_plain

    def counted_plain(*a, **k):
        plain_loops[0] += 1
        return orig_plain(*a, **k)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rd.rd_loop_plain = counted_plain
    try:
        for k in kernels:
            k.launches = 0
        s0 = rd_exits()
        bs = codec.encode(xi, cfg, device=dev)
        torch.cuda.synchronize()
        enc_launch = {k.__name__.rsplit(".", 1)[-1]: k.launches
                      for k in kernels}
        syncs = rd_exits() - s0
    finally:
        rd.rd_loop_plain = orig_plain
    enc_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    y, _ = codec.decode(bs, device=dev)
    torch.cuda.synchronize()
    dec_launch = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    dec_peak = torch.cuda.max_memory_allocated()
    s0 = rd_exits()
    bs_plain = plain_path(lambda: codec.encode(xi, cfg, device=dev))
    plain_syncs = rd_exits() - s0
    log(f"[full] launches in one encode ({chunks} chunk): {enc_launch}; in "
        f"one decode ({dec_chunks} chunks): {dec_launch}; RD loop-exit host "
        f"syncs in the encode: "
        f"{syncs}, plain RD loops run: {plain_loops[0]}; the same encode "
        f"with K1-K10 plain: {plain_syncs} host syncs, stream equal: "
        f"{bs_plain == bs}")
    check(enc_launch["fft_stages"] == 4 * chunks,
          f"encode launched fft_stages {enc_launch['fft_stages']} times, "
          f"not 4 a chunk (the analysis' four layouts)")
    for name in ANALYSIS:
        check(enc_launch[name] == chunks,
              f"encode launched {name} {enc_launch[name]} times, not once "
              f"a chunk")
        check(dec_launch[name] == 0, f"decode launched {name}")
    check(enc_launch["quant_cost"] == 2 * chunks,
          f"encode launched quant_cost {enc_launch['quant_cost']} times, "
          f"not twice a chunk")
    check(enc_launch["rd_loop"] == chunks,
          f"encode launched rd_loop {enc_launch['rd_loop']} times, not once "
          f"a chunk")
    check(syncs == 0 and plain_loops[0] == 0,
          f"the card encode ran the plain RD loop ({syncs} host syncs)")
    check(bs_plain == bs, "the plain-path encode's stream differs")
    check(enc_launch["record_pack"] > 0, "encode launched no record_pack")
    want_dec = {**{k: 0 for k in KERNELS}, "fft_stages": 2 * dec_chunks,
                **{k: dec_chunks for k in SYNTHESIS}}
    check(dec_launch == want_dec,
          f"decode launched {dec_launch}, not K9 and K10 once and K1 twice "
          f"a chunk and nothing else")
    for name in SYNTHESIS:
        check(enc_launch[name] == 0, f"encode launched {name}")
    check(y.shape == x.shape and np.isfinite(y).all(),
          f"decoded shape {y.shape} or values wrong")
    kbps = len(bs) * 8 / seconds / 1000
    ssnr = segmental_snr(x[:, 0], y[:, 0])
    check(ssnr > 10.0, f"segmental SNR {ssnr:.2f} dB too low")

    def timed(fn, n=5):
        fn()                                   # warm-up
        torch.cuda.synchronize()
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    enc_ms = timed(lambda: codec.encode(xi, cfg, device=dev))
    dec_ms = timed(lambda: codec.decode(bs, device=dev, pcm_dtype="int16"))
    stats = {"encode_ms": enc_ms, "decode_ms": dec_ms,
             "encode_rtf": seconds * 1e3 / min(enc_ms),
             "decode_rtf": seconds * 1e3 / min(dec_ms),
             "kbps": kbps, "seg_snr_db": ssnr,
             "encode_peak_bytes": enc_peak, "decode_peak_bytes": dec_peak,
             "host_syncs": syncs, "plain_path_host_syncs": plain_syncs}
    log(f"[full] 30 s stereo 44.1 kHz 128 kbps int16: encode ms {enc_ms} "
        f"(RTF {stats['encode_rtf']:.2f}x best); decode ms {dec_ms} "
        f"(RTF {stats['decode_rtf']:.2f}x best); {kbps:.2f} kbps; "
        f"segSNR ch0 {ssnr:.2f} dB; peak memory encode {enc_peak} B, "
        f"decode {dec_peak} B")
    launches = {k: enc_launch[k] + dec_launch[k] for k in enc_launch}
    return launches, stats


def profile_once(fn):
    """torch.profiler (CUDA activity) over one call of fn(), the trace
    opened with fills that fn() does not launch, since a trace can miss
    a session's first launches -> (the profiler, [(event name, device ms,
    count)] of the device events fn() ran, fills left out)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad = torch.empty(1024, device="cuda")
        for _ in range(50):
            pad.fill_(1.0)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3, e.count)
            for e in prof.key_averages()]
    return prof, [r for r in rows if r[1] > 0 and "FillFunctor" not in r[0]]


def phase_breakdown(dev):
    """Where one full-size encode and decode spend their time: host-clock
    laps around each stage (each closed by a synchronize), and the card's
    busy share from torch.profiler's kernel times over one whole run."""
    import torch
    from mrcaudiocodec_tpu_torch import bitstream
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.models import codec, decoder, encoder, packing
    from mrcaudiocodec_tpu_torch.ops import device_pack, reservoir
    from mrcaudiocodec_tpu_torch.profiling import (device_ms,
                                                   kernel_device_totals)
    cfg, xi = full_clip()
    bs = codec.encode(xi, cfg, device=dev)                    # warm-up
    laps = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        laps[name] = laps.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    # the stages of encoder.encode, called one by one
    torch.cuda.synchronize()
    t = time.perf_counter()
    nf = C.frames_for_samples(xi.shape[0])
    P = encoder._padded_rows(xi, nf)
    lap("enc.pad", t)
    spans = encoder.chunk_spans(nf, P.shape[0])
    chunks = []
    for f0, s in spans:
        t = time.perf_counter()
        sl = encoder.upload_chunk(P, f0, s, dev)
        lap("enc.upload", t)
        t = time.perf_counter()
        chunks.append(encoder._analyze_chunk(sl, cfg))
        lap("enc.analyze", t)
    t = time.perf_counter()
    budgets = reservoir.allocate(torch.cat([c[3] for c in chunks], 1), cfg)
    lap("enc.budget", t)
    t = time.perf_counter()
    decisions = [encoder.decide_chunk(ch, budgets[:, f0:f0 + s], cfg)
                 for ch, (f0, s) in zip(chunks, spans)]
    lap("enc.rd+codebook", t)
    cap = device_pack.pack_cap_bytes(cfg)
    t = time.perf_counter()
    orders = [encoder.stream_order(None, cfg.channels, f0, s, P.shape[0])
              for f0, s in spans]
    order_dev = [torch.from_numpy(o).to(dev) for o, _ in orders]
    lap("enc.order", t)
    t = time.perf_counter()
    packed = [encoder.pack_chunk(d, o, cfg, cap)
              for d, o in zip(decisions, order_dev)]
    lap("enc.device_pack", t)
    t = time.perf_counter()
    down = [encoder.download_body(p) for p in packed]
    lap("enc.download", t)
    t = time.perf_counter()
    stream = encoder.header(cfg, nf, xi.shape[0]) + b"".join(
        encoder.clip_slices(*dn, c)[0] for dn, (_, c) in zip(down, orders))
    lap("enc.assemble", t)
    check(stream == bs, "the staged encode differs from codec.encode")
    # the host-pack path the last three stages replace, same decisions
    t = time.perf_counter()
    arrays = encoder.download(decisions)
    lap("host.download_decisions", t)
    t = time.perf_counter()
    packed_host = packing.pack_stream(arrays, nf, xi.shape[0], cfg)
    lap("host.pack", t)
    check(packed_host == bs, "the host-packed stream differs")
    # the stages of decoder.decode (int16 PCM), called one by one: the
    # native parse, the slabs' transposes and casts, the upload, the
    # synthesis of the chunks in order (each K10 adding the tail before it
    # and writing its slice of the clip buffer), the one download
    _, nf_dec, n_samples, _ = bitstream.read_header(bs)
    t = time.perf_counter()
    recs = decoder.parse_records(bs)
    lap("dec.parse", t)
    t = time.perf_counter()
    slabs = decoder.slabs(*recs, cfg.channels)
    lap("dec.slabs", t)
    t = time.perf_counter()
    staged = [tuple(torch.from_numpy(a).to(dev) for a in slab)
              for slab in slabs]
    lap("dec.upload", t)
    t = time.perf_counter()
    clip = torch.empty((nf_dec * C.HOP, cfg.channels), dtype=torch.int16,
                       device=dev)
    tails, f0 = [None], 0
    for sl in staged:
        s_ = sl[2].shape[1]
        tails.append(decoder._synth_chunk(
            *sl, cfg.fs, cfg.window, True, tails[-1],
            clip[f0 * C.HOP:(f0 + s_) * C.HOP])[2])
        f0 += s_
    lap("dec.synth", t)
    t = time.perf_counter()
    y = clip[C.HOP:C.HOP + n_samples].cpu().numpy()
    lap("dec.download", t)
    t = time.perf_counter()
    y_ref, _ = codec.decode(bs, device=dev, pcm_dtype="int16")
    lap("dec.total", t)
    check(np.array_equal(y, y_ref), "the staged decode differs from "
          "codec.decode")
    log("[breakdown] 30 s stereo, host-clock ms per stage: "
        + json.dumps({k: round(v, 3) for k, v in laps.items()}))
    sizes = {"decisions": sum(t.numel() * t.element_size()
                              for d in decisions for t in d),
             "body": sum(b.nbytes + n.size * 4 + 8 for b, n in down)}
    log(f"[breakdown] bytes downloaded per encode: decisions (q int16, amp "
        f"int8, gain int16, bt int8, cb int8) {sizes['decisions']}; stream "
        f"body + nbytes int32 + status {sizes['body']} "
        f"({sum(b.nbytes for b, _ in down)} + "
        f"{sum(n.size for _, n in down)} x 4 + {8 * len(down)}); the stream "
        f"{len(bs)}")

    # busy share = device time (the profiler's kernel and copy times) over
    # the best UNprofiled wall time: the profiled run's own wall time
    # includes the profiler's start-up
    for name, fn in (("encode", lambda: codec.encode(xi, cfg, device=dev)),
                     ("decode", lambda: codec.decode(bs, device=dev,
                                                     pcm_dtype="int16"))):
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof, rows = profile_once(fn)
        rows = sorted(rows, key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        if busy == 0:
            log(f"[profile] {name}: device time not measured (the profiler "
                f"recorded no kernel time)")
            continue
        log(f"[profile] {name}: best wall {min(walls):.2f} ms (unprofiled), "
            f"device time {busy:.2f} ms, busy share "
            f"{busy / min(walls):.3f}, {sum(r[2] for r in rows)} device "
            f"events")
        if name == "decode":
            copies = {k: c for k, _, c in rows if "Memcpy" in k}
            down = sum(c for k, c in copies.items() if "DtoH" in k)
            log(f"[profile] decode: copies {copies}; downloads {down} (the "
                f"PCM, already [n, channels])")
            check(down == 1, f"the decode made {down} downloads, not 1")
        for key, ms, count in rows[:8]:
            log(f"[profile] {name}:   {ms:9.3f} ms  x{count:<6} {key[:90]}")
        tot = kernel_device_totals(prof, [f"{k}_kernel" for k in KERNELS])
        log(f"[profile] {name}: " + "; ".join(
            f"K{i + 1} {k} {tot[k + '_kernel'][0]} launches, "
            f"{tot[k + '_kernel'][1]:.4f} ms device"
            for i, k in enumerate(KERNELS)))

    # the analysis of the clip's chunk alone: its device events, one
    # profiled call (each kernel's launches, every other event by name),
    # beside its best wall of 5 after a warm-up
    sl = encoder.upload_chunk(P, spans[0][0], spans[0][1], dev)
    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        encoder._analyze_chunk(sl, cfg)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    mods = kernel_modules()
    for k in mods:
        k.launches = 0
    prof, rows = profile_once(lambda: encoder._analyze_chunk(sl, cfg))
    counts = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in mods}
    events = sum(r[2] for r in rows)
    dms = sum(r[1] for r in rows)
    tot = kernel_device_totals(prof, [f"{k}_kernel" for k in KERNELS])
    named = {k: tot[f"{k}_kernel"] for k in KERNELS if tot[f"{k}_kernel"][0]}
    other = [(k[:60], c) for k, _, c in rows
             if not any(f"{n}_kernel" in k for n in KERNELS)]
    best = min(walls[1:])
    log(f"[breakdown] _analyze_chunk ({spans[0][1]} frames x "
        f"{cfg.channels} rows) on the card: {events} device events "
        f"(launch count), {dms:.4f} ms device, best wall {best:.3f} ms of "
        f"5 (ms {[round(w, 3) for w in walls[1:]]}), busy share "
        f"{dms / best:.3f}; kernels (launches, device ms) "
        f"{json.dumps(named)}; other events {other}; launch counts "
        f"{counts}")
    want = {**{k: 0 for k in KERNELS}, "fft_stages": 4,
            **{k: 1 for k in ANALYSIS}}
    check(counts == want and not other,
          f"the analysis launched {counts} and ran other device events "
          f"{other}, not K5, K6, K1 x 4, K7 and K8 alone")

    # the synthesis of each of the decode's chunks alone, the same way:
    # K9, K1 x 2 and K10 and no other device event
    for sl, tail in zip(staged, tails):
        def synth(sl=sl, tail=tail):
            return decoder._synth_chunk(*sl, cfg.fs, cfg.window, True, tail)
        walls = []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            synth()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        for k in mods:
            k.launches = 0
        prof, rows = profile_once(synth)
        counts = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in mods}
        events = sum(r[2] for r in rows)
        dms = sum(r[1] for r in rows)
        tot = kernel_device_totals(prof, [f"{k}_kernel" for k in KERNELS])
        named = {k: tot[f"{k}_kernel"] for k in KERNELS
                 if tot[f"{k}_kernel"][0]}
        other = [(k[:60], c) for k, _, c in rows
                 if not any(f"{n}_kernel" in k for n in KERNELS)]
        best = min(walls[1:])
        log(f"[breakdown] _synth_chunk ({sl[2].shape[1]} frames x "
            f"{sl[2].shape[0]} rows, int16, prev "
            f"{'null' if tail is None else 'given'}) on the card: {events} "
            f"device "
            f"events (launch count), {dms:.4f} ms device, best wall "
            f"{best:.3f} ms of 5 (ms {[round(w, 3) for w in walls[1:]]}), "
            f"busy share {dms / best:.3f}; kernels (launches, device ms) "
            f"{json.dumps(named)}; other events {other}; launch counts "
            f"{counts}")
        want = {**{k: 0 for k in KERNELS}, "fft_stages": 2,
                **{k: 1 for k in SYNTHESIS}}
        check(counts == want and not other and events == 4,
              f"the synthesis launched {counts} and ran other device "
              f"events {other}, not K9, K1 x 2 and K10 alone")

    # decide_chunk on the clip's chunk: with K4; with the loop in its
    # plain version and K2 for every sweep (the path before K4); with
    # every kernel plain. In turns, the order reversed every round
    ch, bud = chunks[0], budgets[:, spans[0][0]:spans[0][0] + spans[0][1]]
    runs = {"K4": lambda: encoder.decide_chunk(ch, bud, cfg),
            "plain RD loop": lambda: plain_path(
                lambda: encoder.decide_chunk(ch, bud, cfg), ("rd_loop",)),
            "all plain": lambda: plain_path(
                lambda: encoder.decide_chunk(ch, bud, cfg))}
    ref = runs["K4"]()
    walls = {k: [] for k in runs}
    syncs = {}
    for name, fn in runs.items():
        s0 = rd_exits()
        same = all(torch.equal(a, b) for a, b in zip(fn(), ref))
        syncs[name] = rd_exits() - s0
        check(same, f"decide_chunk ({name}) differs from K4's")
    for r in range(6):
        order = list(runs) if r % 2 else list(runs)[::-1]
        for name in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    res = {}
    for name, fn in runs.items():
        dms = device_ms(fn, 5)
        w = walls[name][1:]
        res[name] = {"wall_ms": w, "best_ms": min(w),
                     "median_ms": float(np.median(w)), "device_ms": dms,
                     "host_syncs": syncs[name]}
        log(f"[breakdown] decide_chunk ({spans[0][1]} frames x "
            f"{cfg.channels} rows) {name}: wall best {min(w):.3f} ms, "
            f"median {np.median(w):.3f} ms (5 runs after a warm-up, in "
            f"turns), device {dms} ms a call, busy share "
            f"{'not measured' if dms is None else f'{dms / min(w):.3f}'}, "
            f"{syncs[name]} host syncs a call; ms {w}")
    return res


def time_input(where, key, args):
    """Event ms, device ms, plain ms and the bound of one kernel input (and
    torch.fft.fft's times beside K1)."""
    import torch
    from mrcaudiocodec_tpu_torch.profiling import (bound_ms, device_ms,
                                                   kernel_bound)
    kernel, plain = kernel_pair(key[0])
    r = {"ms": cuda_ms(lambda: kernel(*args), 50),
         "device_ms": device_ms(lambda: kernel(*args),
                                match=f"{key[0]}_kernel"),
         "plain_ms": cuda_ms(lambda: plain(*args), 3, warmup=1)}
    b, o, rate = kernel_bound(key, args)
    t, by = bound_ms([(b, o, rate)])
    r.update(bound_ms=t, bytes=b, ops=o, bound_by=by)
    lib = ""
    if key[0] == "fft_stages":
        zc = torch.complex(args[0], args[1])
        r["library_ms"] = cuda_ms(lambda: torch.fft.fft(zc, dim=-1), 50)
        r["library_device_ms"] = device_ms(lambda: torch.fft.fft(zc, dim=-1))
        lib = (f"; torch.fft.fft {r['library_ms']:.4f} ms event, "
               f"{r['library_device_ms']} ms device")
    log(f"[times] {key[0]} {where} {key[1]}: kernel {r['ms']:.4f} ms event, "
        f"{r['device_ms']} ms device; plain {r['plain_ms']:.4f} ms; bound "
        f"{r['bound_ms']:.5f} ms ({b} bytes, {o} ops; {r['bound_by']})"
        + lib)
    return r


def k4_locate(sets):
    """Where K4's time goes, each set's device ms beside its bound (phase
    4): (a) the budget-0 pad rows of the pad set alone, which exit at once
    (set-up and the entry mask), the 30 s chunk at its own allowed noise
    and at a millionth of it (every frame at OUTER_MAX), and from those
    the time of one outer iteration of one frame, card-wide; (b) the
    OUTER_MAX set cut to 132 ... 2586 rows, one to about twenty blocks an
    SM. If 132 rows take about as long as 660, K4 waits on latency (too
    few warps in flight); if the time grows with the rows, on issue. ->
    the logged numbers."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.ops import rd
    from mrcaudiocodec_tpu_torch.ops.kernels import rd_loop
    from mrcaudiocodec_tpu_torch.profiling import (bound_ms, device_ms,
                                                   kernel_bound, rd_loop_ops)

    def cut(args, rows):
        return tuple(a[rows].contiguous() if isinstance(a, torch.Tensor)
                     else a for a in args)

    def measure(name, args):
        n = args[0].shape[0]
        ms = device_ms(lambda: rd_loop.rd_loop_kernel(*args),
                       match="rd_loop_kernel")
        b, o, rate = kernel_bound(("rd_loop", (n,)), args)
        t, by = bound_ms([(b, o, rate)])
        tq, _ = bound_ms([(b, rd_loop_ops(args, kept=False), rate)])
        outer = int(rd.loop_counts(*args)["outer"].sum())
        r = {"rows": n, "outer_iterations": outer, "device_ms": ms,
             "bound_ms": t, "bound_by": by, "bound_ms_requantize": tq}
        x = "not measured" if ms is None else f"{ms / t:.2f}, {ms / tq:.2f}"
        log(f"[k4 time] {name}: {n} rows, {outer} outer iterations, "
            f"device {ms} ms, bound {t:.5f} ms ({by}; requantizing count "
            f"{tq:.5f} ms), x bound (this count, requantizing) {x}")
        return r

    pad_set = sets["30 s chunk, every third row a silent budget-0 pad frame"]
    pads = pad_set[2] == -C.FRAME_LEN_BITS - 7
    om = sets["30 s chunk, allowed noise a millionth"]
    out = {"pad rows": measure("the pad rows alone (set-up and the entry "
                               "mask)", cut(pad_set, pads)),
           "own noise": measure("the 30 s chunk at its own allowed noise",
                                sets["30 s chunk"]),
           "OUTER_MAX": measure("the 30 s chunk, allowed noise a "
                                "millionth (every frame at OUTER_MAX)", om)}
    p, o, own = out["pad rows"], out["OUTER_MAX"], out["own noise"]
    if None not in (p["device_ms"], o["device_ms"], own["device_ms"]):
        entry = p["device_ms"] / p["rows"]
        it = (o["device_ms"] - entry * o["rows"]) / o["outer_iterations"]
        out["per_row_entry_ms"], out["per_iteration_ms"] = entry, it
        model = entry * own["rows"] + it * own["outer_iterations"]
        log(f"[k4 time] card-wide: set-up and entry {entry * 1e3:.4f} us a "
            f"row, one outer iteration {it * 1e3:.4f} us a row; so the own-"
            f"noise chunk would take {model:.4f} ms against "
            f"{own['device_ms']:.4f} measured")
    out["rows"] = {}
    for n in (132, 264, 528, 660, 1320, om[0].shape[0]):
        out["rows"][n] = measure(f"OUTER_MAX set, first {n} rows",
                                 cut(om, slice(0, n)))
    base = out["rows"][132]["device_ms"]
    if base is not None:
        log("[k4 time] OUTER_MAX set, device ms over 132 rows' as the rows "
            "grow: " + json.dumps({n: None if r["device_ms"] is None else
                                   round(r["device_ms"] / base, 3)
                                   for n, r in out["rows"].items()}))
    return out


def locate_measure(tag, name, where, args):
    """One analysis kernel's device ms on these inputs beside its bound
    (phase 4's k8_locate and k5_locate) -> the logged numbers."""
    from mrcaudiocodec_tpu_torch.profiling import (bound_ms, device_ms,
                                                   kernel_bound)
    kernel = kernel_pair(name)[0]
    ms = device_ms(lambda: kernel(*args), match=f"{name}_kernel")
    b, o, rate = kernel_bound((name,), args)
    t, by = bound_ms([(b, o, rate)])
    x = "not measured" if ms is None else f"{ms / t:.2f}"
    log(f"[{tag} time] {where}: device {ms} ms, bound {t:.5f} ms ({by}), "
        f"x bound {x}")
    return {"device_ms": ms, "bound_ms": t, "bound_by": by}


def k8_locate(inputs):
    """Where K8's time goes (phase 4): the 30 s chunk's captured inputs
    cut to 132 ... 2586 rows (a time flat below about 528 rows, where
    every frame has its own warp or block in flight, is latency); full
    psycho off against on (the spreading, flatness and the second scan's
    share); a chunk dense with SHORT frames against as many all-long rows
    of the 30 s chunk; the batch's 8192 rows. -> the logged numbers."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.models import encoder
    from mrcaudiocodec_tpu_torch.profiling import capture_inputs

    def cut(args, n):
        return tuple(a[:n].contiguous() if isinstance(a, torch.Tensor)
                     else a for a in args)

    enc = next(v for k, v in inputs["encode"].items() if k[0] == "psycho")
    out = {"rows": {}}
    for n in (132, 264, 528, 1056, enc[5].shape[0]):
        out["rows"][n] = locate_measure("k8", "psycho", f"30 s chunk, first "
                                        f"{n} rows", cut(enc, n))
    base = out["rows"][132]["device_ms"]
    if base is not None:
        log("[k8 time] 30 s chunk, device ms over 132 rows' as the rows "
            "grow: " + json.dumps({n: None if r["device_ms"] is None else
                                   round(r["device_ms"] / base, 3)
                                   for n, r in out["rows"].items()}))
    out["full psycho off"] = locate_measure(
        "k8", "psycho", "30 s chunk, full psycho off",
        enc[:7] + (False,))
    name, cfg, rows, _ = next(c for c in analysis_cases()
                              if c[0] == "transient-dense")
    audio = torch.from_numpy(np.ascontiguousarray(rows)).to("cuda")
    caps = capture_inputs(lambda: encoder._analyze_chunk(audio, cfg))
    dense = next(v for k, v in caps.items() if k[0] == "psycho")
    n = dense[5].shape[0]
    n_short = int((dense[5] == C.SHORT).sum())
    out["SHORT-dense"] = locate_measure(
        "k8", "psycho", f"{name} chunk, {n} rows, {n_short} SHORT", dense)
    out["all-long"] = locate_measure(
        "k8", "psycho", f"30 s chunk, first {n} rows, "
        f"{int((enc[5][:n] == C.SHORT).sum())} SHORT", cut(enc, n))
    out["SHORT rows"] = n_short
    bat = next(v for k, v in inputs["corpus"].items() if k[0] == "psycho")
    out["batch"] = locate_measure("k8", "psycho", f"batch chunk, "
                                  f"{bat[5].shape[0]} rows", bat)
    return out


def k5_locate(inputs):
    """Where K5's time goes (phase 4): the 30 s chunk as it comes (2
    rows), its first row alone, and the batch's chunk (128 rows x 64
    frames), each with the tile the wrapper picks. -> the logged
    numbers."""
    from mrcaudiocodec_tpu_torch.ops.kernels import transients
    enc = next(v for k, v in inputs["encode"].items()
               if k[0] == "transients")
    bat = next(v for k, v in inputs["corpus"].items()
               if k[0] == "transients")
    out = {}
    for where, args in (("30 s chunk", enc), ("30 s chunk, row 0 alone",
                                               (enc[0][:1],) + enc[1:]),
                        ("batch chunk", bat)):
        r, s = args[0].shape[0], args[0].shape[1] // 1024 - 3
        tile = transients.tile_outputs(r, s, transients._sms(0))
        out[where] = locate_measure("k5", "transients",
                                    f"{where}: {r} rows x {s} frames, "
                                    f"tiles of {tile}", args)
    return out


def k10_locate(inputs):
    """Where K10's time goes (phase 4): the decode's two chunks (2048 and
    538 frame rows, the second with the first's tail), f32 and int16 PCM,
    and the 2048-row chunk cut to 33 ... 1024 frames a row (a block a hop
    and a row pair: a time flat in the blocks is latency, one that grows
    with them throughput), each beside its bound. -> the logged
    numbers."""
    out = {}
    for key, args in inputs["decode"].items():
        if key[0] != "synth_post":
            continue
        for pcm16 in (False, True):
            where = f"{key[1][0]} rows, {'int16' if pcm16 else 'f32'}"
            out[where] = locate_measure("k10", "synth_post", where,
                                        args[:6] + (pcm16,) + args[7:])
    args = next(v for k, v in inputs["decode"].items()
                if k[0] == "synth_post")
    r, s = args[4].shape
    for n in (33, 132, 528, s):
        cut = tuple(p.reshape((r, s) + p.shape[1:])[:, :n].reshape(
            (r * n,) + p.shape[1:]).contiguous() for p in args[:4])
        out[f"{r * n} rows, f32"] = locate_measure(
            "k10", "synth_post", f"the 2048-row chunk's first {n} frames "
            f"a row ({r * n} rows, {n + 1} blocks), f32",
            cut + (args[4][:, :n].contiguous(),) + args[5:])
    return out


def phase_times(dev, inputs, rd_sets):
    """Kernel, plain and library times on the main path's own inputs
    (main_path_inputs), beside the card's bound for the same work. The
    kernels line takes the 30 s clip's encode: K1 summed over the four FFT
    layouts of its one chunk (2586 frame rows), K2 at G=32 over those rows,
    K3 on its 2586 records, K4 on its 2586 rows (its plain version with
    K2's plain payloads), K5-K8 on its 2586 rows; K9 and K10 take the
    30 s decode's first chunk (2048 frame rows). Every other captured input (K2 at G=8, the
    decode's FFTs, the 64-clip batch's chunk of 8192 frame rows) is timed
    too and kept under by_shape. Event ms hold the host's launch interval
    where a kernel is short (and K3's read of its status); device ms (the
    profiler's kernel time per launch) do not. K4 is also timed on phase
    3's corner sets (k4_locate)."""
    from mrcaudiocodec_tpu_torch.profiling import F32_OPS_PER_S, bound_ms
    out = {}
    for name in KERNELS:
        by_shape = {}
        for where, caps in inputs.items():
            for key, args in caps.items():
                if key[0] == name:
                    by_shape[f"{where} {key[1]}"] = time_input(where, key,
                                                               args)
        src = "decode" if name in SYNTHESIS else "encode"
        enc = {k: v for k, v in by_shape.items() if k.startswith(src)}
        if name == "fft_stages":
            # one encode's four launches, summed; its bound from their
            # summed bytes and ops
            t_bound, by = bound_ms([(v["bytes"], v["ops"], F32_OPS_PER_S)
                                    for v in enc.values()])
            dev_ms = [v["device_ms"] for v in enc.values()]
            lib_dev = [v["library_device_ms"] for v in enc.values()]
            line = dict(
                ms=sum(v["ms"] for v in enc.values()),
                device_ms=None if None in dev_ms else sum(dev_ms),
                plain_ms=sum(v["plain_ms"] for v in enc.values()),
                library_ms=sum(v["library_ms"] for v in enc.values()),
                library_device_ms=None if None in lib_dev else sum(lib_dev),
                bound_ms=t_bound, bound_by=by)
            log(f"[times] fft_stages, the encode's {len(enc)} layouts "
                f"summed: kernel {line['device_ms']} ms device, "
                f"torch.fft.fft {line['library_device_ms']} ms device, "
                f"bound {line['bound_ms']:.4f} ms")
        else:
            first = next(v for k, v in enc.items()
                         if name != "quant_cost" or k.endswith(", 32)"))
            line = {k: first[k] for k in ("ms", "device_ms", "plain_ms",
                                          "bound_ms", "bound_by")}
            line["library_ms"] = None
        line["by_shape"] = by_shape
        out[name] = line
    out["rd_loop"]["locate"] = k4_locate(rd_sets)
    out["psycho"]["locate"] = k8_locate(inputs)
    out["transients"]["locate"] = k5_locate(inputs)
    out["synth_post"]["locate"] = k10_locate(inputs)
    out["pad_rows"] = k11_hold_and_time(dev)
    log_instruction_mix()
    return out


def k11_bytes(pcm, clips, f0, s) -> int:
    """K11's bytes on the card: its rows written once, the samples in them
    read once, the clips' offsets and lengths."""
    from mrcaudiocodec_tpu_torch import config as C
    nch, es = pcm.shape[1], pcm.element_size()
    lo, hi = (f0 - 2) * C.HOP, (f0 + s + 1) * C.HOP
    read = sum(max(0, min(hi, n) - max(lo, 0)) for _, n in clips.tolist())
    return (clips.shape[0] * nch * (hi - lo) + read * nch) * es \
        + clips.numel() * 8


def k11_hold_and_time(dev):
    """K11 on the main path's own inputs, captured at its wrapper: one
    30 s encode (one chunk) and one 64 x 10 s batch (7 chunks of 128
    rows). Each launch's rows == upload_chunk(_padded_rows(...)) of the
    same clips (the host pad it replaced) and == its plain version, bit
    for bit; then its time at the 30 s chunk (2 rows, 2586 frame rows)
    and at the batch's first chunk (128 rows, 8192 frame rows) beside its
    byte bound; and its library's SASS audit."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch import corpus
    from mrcaudiocodec_tpu_torch.models import codec, encoder
    from mrcaudiocodec_tpu_torch.ops.kernels import build, pad_rows
    from mrcaudiocodec_tpu_torch.probes import fma_probe
    from mrcaudiocodec_tpu_torch.profiling import (HBM_BYTES_PER_S,
                                                   device_ms)
    cfg, xi = full_clip()
    caps = {"encode": [], "corpus": []}
    where = ["encode"]
    orig = pad_rows.pad_rows_kernel

    def rec(*args):
        caps[where[0]].append(args)    # the PCM is never written again
        return orig(*args)
    clips = corpus._synth_corpus(64, 10.0)
    pad_rows.pad_rows_kernel = rec
    try:
        codec.encode(xi, cfg, device=dev)
        where[0] = "corpus"
        corpus.encode_batch(clips, cfg, device=dev)
        torch.cuda.synchronize()
    finally:
        pad_rows.pad_rows_kernel = orig
    nf_batch = corpus.FRAME_BUCKET * -(-C.frames_for_samples(
        clips[0].shape[0]) // corpus.FRAME_BUCKET)
    want_launches = {
        "encode": len(encoder.chunk_spans(C.frames_for_samples(xi.shape[0]),
                                          cfg.channels)),
        "corpus": len(encoder.chunk_spans(nf_batch,
                                          cfg.channels * len(clips)))}
    out = {"launches": sum(len(c) for c in caps.values()), "by_shape": {}}
    for key, calls in caps.items():
        check(len(calls) == want_launches[key],
              f"{key}: K11 launched {len(calls)} times, not once a chunk "
              f"({want_launches[key]})")
        pcm_h = calls[0][0].cpu().numpy()
        tab = calls[0][1].cpu().tolist()
        arrs = [pcm_h[o:o + n] for o, n in tab]
        nf = max(max(f0 + s for _, _, f0, s in calls),
                 max(C.frames_for_samples(n) for _, n in tab))
        P = np.concatenate([encoder._padded_rows(a, nf) for a in arrs])
        for pcm, clips, f0, s in calls:
            got = pad_rows.pad_rows_kernel(pcm, clips, f0, s)
            plain = pad_rows.pad_rows_plain(pcm, clips, f0, s)
            torch.cuda.synchronize()
            ok = (bits_equal(got, encoder.upload_chunk(P, f0, s, "cpu"))
                  and bits_equal(got, plain))
            log(f"[kernels] pad_rows on the {key} path's own input (f0 "
                f"{f0}, s {s}, {clips.shape[0]} clips, {pcm.dtype}): "
                f"kernel == host pad == plain bitwise: {ok}")
            check(ok, f"pad_rows {key} f0={f0} s={s} differs from the host "
                  f"pad or its plain version")
        pcm, clips, f0, s = calls[0]
        run = (lambda a=calls[0]: pad_rows.pad_rows_kernel(*a))
        nbytes = k11_bytes(pcm, clips, f0, s)
        line = dict(ms=cuda_ms(run, 50), device_ms=device_ms(
                        run, 20, match="pad_rows_kernel"),
                    plain_ms=cuda_ms(lambda a=calls[0]:
                                     pad_rows.pad_rows_plain(*a), 5,
                                     warmup=1),
                    bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                    bound_by="bytes", bytes=nbytes)
        rows = clips.shape[0] * pcm.shape[1] * s
        out["by_shape"][f"{key} ({rows},)"] = line
        ratio = (line["device_ms"] / line["bound_ms"]
                 if line["device_ms"] else None)
        log(f"[times] pad_rows at the {key} chunk ({rows} frame rows, "
            f"{nbytes} B): event {line['ms']:.4f} ms, device "
            f"{line['device_ms']} ms, plain {line['plain_ms']:.4f} ms, "
            f"bound {line['bound_ms']:.5f} ms (bytes); device over bound "
            f"{ratio}")
    first = out["by_shape"][next(iter(out["by_shape"]))]
    out.update({k: first[k] for k in ("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by")},
               library_ms=None)
    audit = fma_probe.sass_counts(subprocess.run(
        [fma_probe.cuobjdump(), "-sass", build._so("pad_rows")],
        capture_output=True, text=True, timeout=120, check=True).stdout)
    ffma = sum(f["FFMA"] for f in audit.values())
    ftz = sum(f["FTZ"] for f in audit.values())
    log(f"[kernels] SASS audit libpad_rows.so: {ffma} FFMA, {ftz} .FTZ in "
        f"{len(audit)} kernels")
    check(ffma == 0 and ftz == 0, "libpad_rows.so holds FFMA or .FTZ")
    return out


# SASS mnemonics by kind of work (IMAD and MOV may issue to the f32 pipe)
MIX_CLASSES = {
    "f32": ("FADD", "FMUL", "FSETP", "FSEL", "FMNMX", "FRND", "F2I", "I2F"),
    "int": ("IADD3", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "SEL", "VIMNMX",
            "VIADD", "VIADDMNMX", "IMNMX", "FLO", "IABS", "PRMT", "MOV",
            "IADD", "SGXT"),
    "shared": ("LDS", "STS"),
    "global": ("LDG", "STG"),
    "atomic": ("ATOMS", "ATOMG", "ATOM", "RED"),
    "warp": ("SHFL", "REDUX", "MATCH", "VOTE"),
    "control": ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "CALL", "RET"),
}


def log_instruction_mix():
    """Each K1-K11 kernel's SASS instructions (cuobjdump -sass), by
    class: the static counts the device times are read against (K1's
    kernels are straight-line code, K2's gain loop is unrolled over a
    lane's 8 tuples, 32 bins, K3's over a lane's 16 pairs, twice; K4
    holds its form of K2's routine once, for the refine candidates and the
    fallback, the entry's quantize and the over-mask's tuple loop)."""
    from mrcaudiocodec_tpu_torch.ops.kernels import build
    from mrcaudiocodec_tpu_torch.probes import fma_probe
    for lib in build.MAIN:
        text = subprocess.run([fma_probe.cuobjdump(), "-sass",
                               build._so(lib)], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        for func, ops in fma_probe.sass_opcodes(text).items():
            total = sum(ops.values())
            mix = {c: sum(ops.get(o, 0) for o in names)
                   for c, names in MIX_CLASSES.items()}
            mix["other"] = total - sum(mix.values())
            top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
            log(f"[mix] {func[-48:]}: {total} instructions; {mix}; top "
                f"{dict(top)}")


# ---------------------------------------------------------------------------
# The probe path (P1-P5): the TPU probe scripts' kernels as CUDA probes
# ---------------------------------------------------------------------------

# body -> (probe module, JSON name, source, the TPU kernel it replaces)
PROBE_BODIES = {
    "mag_probe": ("quant_g32", "p1_mag_probe", "probe_quant_g32.cu",
                  "scripts/tpu_quant_g32.py:110 (mag_probe; body "
                  "_mag_kernel :85)"),
    "op_probe": ("quant_g32", "p2_op_probe", "probe_quant_g32.cu",
                 "scripts/tpu_quant_g32.py:177 (phase3; body _op_kernel "
                 ":149)"),
    "k1": ("fma_probe", "p3_k1", "probe_fma.cu",
           "scripts/tpu_fma_probe.py:82 (main; body k1 :69)"),
    "k2": ("fma_probe", "p3_k2", "probe_fma.cu",
           "scripts/tpu_fma_probe.py:82 (main; body k2 :72)"),
    "k3": ("fma_probe", "p3_k3", "probe_fma.cu",
           "scripts/tpu_fma_probe.py:82 (main; body k3 :75)"),
    "v1": ("quant_bisect", "p4_v1", "probe_quant_bisect.cu",
           "scripts/tpu_quant_bisect.py:37 (run; body v1_quantize_only :58)"),
    "v2": ("quant_bisect", "p4_v2", "probe_quant_bisect.cu",
           "scripts/tpu_quant_bisect.py:37 (run; body v2_onehot81 :78)"),
    "v3": ("quant_bisect", "p4_v3", "probe_quant_bisect.cu",
           "scripts/tpu_quant_bisect.py:37 (run; body v3_maskmm :104)"),
    "v4": ("quant_bisect", "p4_v4", "probe_quant_bisect.cu",
           "scripts/tpu_quant_bisect.py:37 (run; body v4_escpair :122)"),
    "v5": ("quant_bisect", "p4_v5", "probe_quant_bisect.cu",
           "scripts/tpu_quant_bisect.py:37 (run; body v5_escextra :133)"),
    "p0": ("primitive_probe", "p5_p0", "probe_primitives.cu",
           "scripts/tpu_primitive_probe.py:34 (run; body p0_reshape :50)"),
    "p1": ("primitive_probe", "p5_p1", "probe_primitives.cu",
           "scripts/tpu_primitive_probe.py:34 (run; body p1_strided :58)"),
    "p2": ("primitive_probe", "p5_p2", "probe_primitives.cu",
           "scripts/tpu_primitive_probe.py:34 (run; body p2_roll :66)"),
    "p3": ("primitive_probe", "p5_p3", "probe_primitives.cu",
           "scripts/tpu_primitive_probe.py:34 (run; body p3_deint_mm :75)"),
    "p4": ("primitive_probe", "p5_p4", "probe_primitives.cu",
           "scripts/tpu_primitive_probe.py:34 (run; body p4_evenmask :87)"),
}
V1_TOL = 4      # |diff| allowed per [frame, gain] if exp2f/powf differ


def probe_ops(body, args):
    """(f32 ops, int32 ops) the body does on these inputs, counting each
    source-level op once (a divide, sqrt, exp2 or pow as one)."""
    rows = args[0].shape[0]
    n = args[0].numel()
    if body == "mag_probe":
        return 9 * n, 11 * n
    if body == "op_probe":
        return 5 * n, 0
    if body in ("k1", "k2", "k3"):
        return (2 if body == "k1" else 3) * n, 0
    if body in ("v1", "v2"):
        gn = n * args[2].shape[1]
        return 9 * gn, (4 if body == "v1" else 10) * gn
    if body == "v3":
        nb = args[2].shape[2]
        return rows * (512 * 3 + 512 * nb * 2 + nb), 0
    if body == "v4":
        return 2 * n, 3 * n
    if body == "v5":
        return 3 * n, 22 * n
    if body in ("p0", "p1"):
        return rows * (512 + 511), 0
    if body == "p2":
        return rows * (512 + 1023), n
    if body == "p3":
        return rows * (2 * 1024 * 512 * 2 + 512 + 511), 0
    return rows * (1024 + 1023), 6 * n                      # p4


def probe_bound(body, args, out):
    """Least time (ms) and what bounds it: each tensor read and written
    once over HBM, or the ops over the f32 and int32 instruction rates."""
    import torch
    from mrcaudiocodec_tpu_torch.profiling import (F32_OPS_PER_S,
                                                   INT32_OPS_PER_S, bound_ms)
    outs = out if isinstance(out, tuple) else (out,)
    b = sum(t.numel() * t.element_size() for t in args + outs
            if isinstance(t, torch.Tensor))
    f, i = probe_ops(body, args)
    return bound_ms([(b, f, F32_OPS_PER_S), (0, i, INT32_OPS_PER_S)])


def probe_compare(body, got, want):
    """-> (max |err|, ok, note): bitwise, except v1 (see V1_TOL)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(max_abs_err(g, w) for g, w in zip(got, want))
    same = all(bits_equal(g, w) for g, w in zip(got, want))
    if same or body != "v1":
        return err, same, "bitwise" if same else "DIFFERS"
    n = int((got[0].cpu() != want[0].cpu()).sum())
    return err, err <= V1_TOL, f"{n} entries differ (|diff| <= {V1_TOL})"


def probe_device_ms(timed, iters: int = 20):
    """{body: mean device ms per launch} of each (body, kernel, args) from
    torch.profiler's kernel times (None where it recorded none)."""
    from mrcaudiocodec_tpu_torch.profiling import device_ms
    out = {body: device_ms(lambda: kernel(*args), iters,
                           match=f"{body}_kernel")
           for body, kernel, args in timed}
    log(f"[times] device ms per launch (torch.profiler): {json.dumps(out)}")
    return out


def phase_probes(dev):
    """Build the probe libraries, drive the probe path (each probe
    module's run on the card) with the launch counts, hold each of the 15
    bodies against its plain version, print the SASS audit, and time each
    body beside its plain version, its bound and a library call."""
    import torch
    from mrcaudiocodec_tpu_torch.ops.kernels import build
    from mrcaudiocodec_tpu_torch.probes import (fma_probe, primitive_probe,
                                                quant_bisect, quant_g32)
    mods = {"fma_probe": fma_probe, "quant_g32": quant_g32,
            "quant_bisect": quant_bisect, "primitive_probe": primitive_probe}
    t0 = time.perf_counter()
    logs = build.build(build.PROBES, force=True)
    log(f"[probes] built {len(logs)} libraries in "
        f"{time.perf_counter() - t0:.1f} s (probe_fma_contract: --fmad=true)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                log(f"[probes] {name}: {line.strip()}")

    # the probe path, counted
    torch.cuda.synchronize()
    for m in mods.values():
        for k in m.launches:
            m.launches[k] = 0
    results = {}
    for name, m in mods.items():
        log(f"[probes] -- {name}.run('cuda')")
        results[name] = m.run(dev)
    torch.cuda.synchronize()
    launches = {b: mods[meta[0]].launches[b] for b, meta in
                PROBE_BODIES.items()}
    log(f"[probes] launches on the probe path: {launches}")
    for b, n in launches.items():
        check(n > 0, f"probe body {b} was not launched on the probe path")

    fr = results["fma_probe"]
    cls = fr["classes"]
    log(f"[probes] P3 classifications: {json.dumps(cls)}")
    for row, matches in cls.items():
        if row.startswith(("torch eager", "port ")):
            check("plain" in matches, f"P3 {row}: {matches}, not plain")
    check("fma" in cls["control k1 a*b-c (--fmad=true)"],
          "the --fmad=true control's k1 shows no contraction")
    check(not fr["audit_failures"], f"SASS audit: {fr['audit_failures']}")
    for lib in SYNTHESIS:
        a = fr["audit"][lib]
        log(f"[probes] SASS audit lib{lib}.so: {a['FFMA']} FFMA, {a['FTZ']} "
            f".FTZ in {len(a['functions'])} kernels")
        check(a["FFMA"] == 0 and a["FTZ"] == 0,
              f"lib{lib}.so holds FFMA or .FTZ")
    g32 = results["quant_g32"]
    log(f"[probes] P1 phase 1 (K2 vs plain) mismatches {g32['phase1']}; "
        f"phase 2 (native IEEE vs rev 4) mismatches {g32['phase2']}; "
        f"P2 phase 3 (probe vs torch eager) mismatches {g32['phase3']}")
    check(not any(g32["phase1"].values()), "K2 differs from its plain "
          "version in P1 phase 1")
    check(not any(c["plain on the CPU"] for c in g32["phase3"].values()),
          "P2 on the card differs from its plain version on the CPU")
    prim = results["primitive_probe"]
    want = primitive_probe.make_x("cpu").double().sum(1).numpy()
    for b in ("p0", "p1", "p2", "p3"):
        check(np.abs(prim[b][:, 0] - want).max() < 1e-2,
              f"P5 {b} row sums far from the float64 row sums")

    # each body against its plain version, then times
    stats, timed = {}, []
    log("[probes] tolerance 0 (bitwise) for every body; v1 allows "
        f"|diff| <= {V1_TOL} per entry if exp2f/powf differ from torch's")
    for name, m in mods.items():
        for body, args in m.body_inputs(dev).items():
            kernel, plain = m.BODIES[body]
            timed.append((body, kernel, args))
            got, ref = kernel(*args), plain(*args)
            torch.cuda.synchronize()
            err, ok, note = probe_compare(body, got, ref)
            log(f"[probes] {body} kernel vs plain at "
                f"{[tuple(a.shape) for a in args]}: {note}, max |err| {err}")
            check(ok, f"probe body {body} differs from its plain version")
            km = cuda_ms(lambda: kernel(*args), 50)
            pm = cuda_ms(lambda: plain(*args), 5, warmup=1)
            # one PyTorch call computing the same function: p0-p3 are
            # row sums of x; no other body has one
            lm = (cuda_ms(lambda: args[0].sum(1), 50)
                  if body in ("p0", "p1", "p2", "p3") else None)
            bound, by = probe_bound(body, args, got)
            stats[body] = dict(max_abs_err=err, ms=km, plain_ms=pm,
                               bound_ms=bound, bound_by=by, library_ms=lm)
            log(f"[times] {body}: kernel {km:.4f} ms, plain {pm:.4f} ms, "
                f"bound {bound:.4f} ms ({by})"
                + (f", x.sum(1) {lm:.4f} ms" if lm is not None else ""))
    # device time per launch from the profiler: at these sizes the CUDA
    # event time above is the host's launch interval, not the kernel's
    for body, ms in probe_device_ms(timed).items():
        stats[body]["device_ms"] = ms
    # P1 and P4 at one encode chunk's 2048 rows, beside K2's rows
    timed = []
    for name in ("quant_g32", "quant_bisect"):
        m = mods[name]
        for body, args in m.body_inputs(dev, rows=2048).items():
            if body == "op_probe":
                continue
            kernel, plain = m.BODIES[body]
            timed.append((body, kernel, args))
            got = kernel(*args)
            err, ok, note = probe_compare(body, got, plain(*args))
            check(ok, f"probe body {body} at 2048 rows differs")
            km = cuda_ms(lambda: kernel(*args), 20)
            bound, by = probe_bound(body, args, got)
            stats[body]["ms_2048_rows"] = km
            log(f"[times] {body} at [2048, 1024]: kernel {km:.4f} ms, "
                f"bound {bound:.4f} ms ({by}), {note}")
    for body, ms in probe_device_ms(timed).items():
        stats[body]["device_ms_2048_rows"] = ms
    log(f"[probes] phase done in {time.perf_counter() - t0:.1f} s")
    return launches, stats


def phase_corpus(dev):
    """The corpus path at its bench size: 64 clips x 10 s stereo 128 kbps
    fused on the card, the launch counts of that run, each stream against
    the clip's single-clip encode, a mixed-length bucket, then timings.
    -> (launches, stats)."""
    import torch
    from mrcaudiocodec_tpu_torch import corpus
    from mrcaudiocodec_tpu_torch.config import CodecConfig, frames_for_samples
    from mrcaudiocodec_tpu_torch.models import codec
    from mrcaudiocodec_tpu_torch.profiling import kernel_device_totals
    n_clips, seconds = 64, 10.0
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    clips = corpus._synth_corpus(n_clips, seconds)
    kernels = kernel_modules()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    outs = corpus.encode_batch(clips, cfg, device=dev)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    log(f"[corpus] {n_clips} x {seconds:g} s stereo 128 kbps fused on the "
        f"card: first run {first_ms:.1f} ms, launches {launches}, peak "
        f"device memory {peak} B")
    for name, n in launches.items():
        check((n > 0) != (name in SYNTHESIS),
              f"the corpus batch launched {name} {n} times")
    same = [o == codec.encode(x, cfg, device=dev) for o, x in zip(outs, clips)]
    log(f"[corpus] streams equal to single-clip card encodes: "
        f"{sum(same)}/{len(clips)}")
    check(all(same), "a fused corpus stream differs from its clip's encode")
    mixed = [corpus._synth_corpus(1, sec, seed=100 + i)[0]
             for i, sec in enumerate([0.25, 0.33, 0.41, 0.5, 0.62])]
    mo = corpus.encode_batch(mixed, cfg, device=dev)
    ok = all(mo[i] == codec.encode(x, cfg, device=dev)
             for i, x in enumerate(mixed))
    log(f"[corpus] mixed-length bucket (0.25-0.62 s, 5 clips) == per-clip "
        f"encodes: {ok}")
    check(ok, "a mixed-length bucket stream differs from per-clip encodes")

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        corpus.encode_batch(clips, cfg, device=dev)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    prof, rows = profile_once(
        lambda: corpus.encode_batch(clips, cfg, device=dev))
    busy = sum(r[1] for r in rows)
    tot = kernel_device_totals(prof, [f"{k}_kernel" for k in KERNELS])
    audio = sum(x.shape[0] for x in clips) / cfg.fs
    frames = sum(frames_for_samples(x.shape[0]) for x in clips) * cfg.channels
    best = min(walls)
    stats = {"clips": len(clips), "audio_seconds": audio, "wall_ms": walls,
             "best_ms": best, "median_ms": float(np.median(walls)),
             "realtime_factor": audio * 1e3 / best,
             "frames_per_second": frames * 1e3 / best,
             "peak_bytes": peak, "device_ms": busy,
             "busy_share": busy / best if busy else None,
             "launches": launches,
             "kernel_device": {k: tot[f"{k}_kernel"] for k in KERNELS}}
    kern = sum(ms for _, ms in stats["kernel_device"].values())
    stats["outside_kernels_ms"] = busy - kern
    log(f"[corpus] device time outside K1-K10: {busy - kern:.2f} ms of "
        f"{busy:.2f} ({(busy - kern) / busy:.3f} of it); K1-K10 "
        f"{kern:.2f} ms")
    log(f"[corpus] wall ms {walls} (best {best:.1f}, median "
        f"{stats['median_ms']:.1f}); RTF {stats['realtime_factor']:.1f}x; "
        f"{stats['frames_per_second']:.0f} frames/s; device time "
        f"{busy:.2f} ms in one profiled batch, busy share "
        f"{stats['busy_share']}; " + ", ".join(
            f"K{i + 1} {tot[k + '_kernel']}" for i, k in enumerate(KERNELS))
        + " (launches, device ms)")
    return launches, stats, outs


def phase_cli(dev):
    """The port's CLI in subprocesses: encode, info, decode a 3 s stereo
    WAV; the .mrc equals codec.encode's and the WAV codec.decode's."""
    import os
    import tempfile
    from mrcaudiocodec_tpu_torch import audiofile
    from mrcaudiocodec_tpu_torch.bench import make_clip
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        wav, mrc, out = (os.path.join(tmp, f) for f in
                         ("in.wav", "a.mrc", "out.wav"))
        audiofile.write_wav(wav, make_clip(44100, 3.0, 2, seed=3), 44100)
        for argv in (["encode", wav, mrc, "--bitrate", "128", "--device",
                      dev], ["info", mrc], ["decode", mrc, out, "--device",
                                            dev]):
            res = subprocess.run(
                [sys.executable, "-m", "mrcaudiocodec_tpu_torch.cli", *argv],
                cwd=root, capture_output=True, text=True, timeout=300)
            log(f"[cli] {argv[0]}: exit {res.returncode}; "
                + " | ".join(res.stdout.strip().splitlines()))
            check(res.returncode == 0, f"cli {argv[0]} failed: {res.stderr}")
        xi, fs = audiofile.read_wav(wav, raw_int16=True)
        with open(mrc, "rb") as f:
            data = f.read()
        bs = codec.encode(xi, CodecConfig(fs=fs, channels=2, bitrate=128000),
                          device=dev)
        y, _ = audiofile.read_wav(out, raw_int16=True)
        want, _ = codec.decode(bs, device=dev, pcm_dtype="int16")
        log(f"[cli] .mrc == codec.encode on the card: {data == bs}; WAV == "
            f"codec.decode on the card: {bits_equal(y, want)}")
        check(data == bs, "the CLI's stream differs from codec.encode's")
        check(bits_equal(y, want), "the CLI's WAV differs from codec.decode")


# ---------------------------------------------------------------------------
# The parallel path (parallel/)
# ---------------------------------------------------------------------------


def parallel_clips():
    """The clips of the two-process GroupShards encode: the benchmark clip
    and a 7.3 s stereo int16 clip (one dtype, mixed lengths)."""
    from mrcaudiocodec_tpu_torch.bench import make_clip, to_i16
    cfg, xi = full_clip()
    return cfg, [xi, to_i16(make_clip(44100, 7.3, 2, seed=9))]


def group_shards_worker(rank, world, port, out_dir):
    """One of `world` processes on card 0 under gloo: its seq shard of the
    sharded encode of parallel_clips() at (data, seq) = (1, world). Writes
    the streams it holds, what its exchange was, and the host-clock ms of
    each exchange and of the whole encode in a second (warm) run."""
    import os
    import torch
    import torch.distributed as dist
    from mrcaudiocodec_tpu_torch.parallel import mesh, sharded
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        cfg, clips = parallel_clips()
        grid = mesh.make_grid(1, world)
        ex = sharded.GroupShards(grid, "cuda")
        # host-clock ms of each exchange (the shard layers of PERF.md §3),
        # each closed by a synchronize
        laps = {}
        for name in ("halo", "seq_sum", "seq_all_gather",
                     "seq_gather_bytes"):
            def timed(*a, _f=getattr(ex, name), _n=name):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _f(*a)
                torch.cuda.synchronize()
                laps[_n] = laps.get(_n, 0.0) + (time.perf_counter() - t0) * 1e3
                return out
            setattr(ex, name, timed)
        rows, nf_row, n_samples = sharded.pad_rows(clips, world)
        for _ in range(2):                 # the second run is the warm one
            laps.clear()
            t0 = time.perf_counter()
            streams = sharded.sharded_encode(rows, nf_row, cfg, grid, ex,
                                             n_samples=n_samples)
            laps["encode"] = (time.perf_counter() - t0) * 1e3
        for j, st in enumerate(streams):
            if st is not None:
                with open(os.path.join(out_dir, f"r{rank}_c{j}.mrc"),
                          "wb") as f:
                    f.write(st)
        with open(os.path.join(out_dir, f"r{rank}.json"), "w") as f:
            json.dump({"coords": ex.local[0], "device": str(ex.device),
                       "staged": ex.staged, "ms": laps}, f)
    finally:
        dist.destroy_process_group()


def phase_parallel(dev, corpus_streams, err):
    """The parallel path on the card (phase 12 of the module docstring).
    corpus_streams: phase 10's 64 fused streams; err: max |err| by kernel,
    updated with this path's own inputs held to the plain versions.
    -> stats."""
    import os
    import tempfile
    import torch
    import torch.multiprocessing as mp
    from mrcaudiocodec_tpu_torch import audiofile, corpus
    from mrcaudiocodec_tpu_torch.config import CodecConfig, frames_for_samples
    from mrcaudiocodec_tpu_torch.models import codec
    from mrcaudiocodec_tpu_torch.bench import make_clip
    from mrcaudiocodec_tpu_torch.parallel import launch, mesh, sharded
    from mrcaudiocodec_tpu_torch.profiling import capture_inputs
    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    kernels = kernel_modules()

    def zero_counts():
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0

    def read_counts():
        torch.cuda.synchronize()
        return {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}

    def encode(clips, cfg, n_data, n_seq):
        grid = mesh.make_grid(n_data, n_seq)
        rows, nf_row, n_samples = sharded.pad_rows(clips, n_seq)
        return sharded.sharded_encode(rows, nf_row, cfg, grid,
                                      sharded.LocalShards(grid, dev),
                                      n_samples=n_samples)

    def decode(data, n_data, n_seq):
        grid = mesh.make_grid(n_data, n_seq)
        return sharded.sharded_decode(data, grid,
                                      sharded.LocalShards(grid, dev))[0]

    # the unsharded references first: the counts below are the sharded runs'
    cfg, xi = full_clip()
    want = codec.encode(xi, cfg, device=dev)
    y_want, _ = codec.decode(want, device=dev, pcm_dtype="float32")
    cfg3 = CodecConfig(fs=48000, channels=2, bitrate=192000,
                       full_psycho=True, reservoir=True)
    x3 = make_clip(48000, 300.0, 2, seed=3)
    t0 = time.perf_counter()
    want3 = codec.encode(x3, cfg3, device=dev)
    t_un3 = time.perf_counter() - t0
    # config 3's card stream held to the card encode with every kernel
    # replaced by its plain version
    t0 = time.perf_counter()
    plain3 = plain_path(lambda: codec.encode(x3, cfg3, device=dev))
    log(f"[parallel] config 3 card stream == the card encode through the "
        f"plain versions of K1-K10: {want3 == plain3} (plain run "
        f"{time.perf_counter() - t0:.2f} s host clock)")
    check(want3 == plain3, "config 3's card stream differs from its plain "
          "encode")
    del plain3
    # and its card decode held to the decode with K9 and K10 swapped for
    # their plain versions (K1 stays the kernel)
    t0 = time.perf_counter()
    y3 = codec.decode(want3, device=dev)[0]
    t_dec3 = time.perf_counter() - t0
    y3_plain = plain_path(lambda: codec.decode(want3, device=dev)[0],
                          SYNTHESIS)
    same = bits_equal(y3, y3_plain)
    log(f"[parallel] config 3 card decode ({y3.shape[0]} samples x "
        f"{y3.shape[1]}, {t_dec3:.2f} s host clock, first run) == the card "
        f"decode through the plain versions of K9 and K10, bitwise: {same}")
    check(same, "config 3's card decode differs from its plain decode")
    del y3, y3_plain
    clips = corpus._synth_corpus(64, 10.0)

    caps = {}

    def captured(where, fn):
        """fn() with its kernel inputs captured into caps[where]: the first
        8 calls of each kernel and shape, so every shard's analysis, first
        RD passes and pack."""
        box = []
        caps[where] = capture_inputs(lambda: box.append(fn()), 8)
        return box[0]

    # (a) sharded encode, every shard in turn on this card
    zero_counts()
    for n_data, n_seq in ((1, 4), (2, 2), (2, 1)):
        if (n_data, n_seq) == (1, 4):
            got = captured("sharded 30 s (1, 4) encode",
                           lambda: encode([xi], cfg, 1, 4)[0])
        else:
            got = encode([xi], cfg, n_data, n_seq)[0]
        log(f"[parallel] (a) 30 s stereo int16 at (data, seq) = ({n_data}, "
            f"{n_seq}): stream == codec.encode on the card: {got == want} "
            f"({len(got)} bytes)")
        check(got == want, f"sharded encode ({n_data}, {n_seq}) differs")
    t0 = time.perf_counter()
    got3 = captured("sharded config 3 (1, 4) encode",
                    lambda: encode([x3], cfg3, 1, 4)[0])
    t_sh3 = time.perf_counter() - t0
    log(f"[parallel] (a) config 3 (5 min 48 kHz stereo 192 kbps, full "
        f"psycho, reservoir; {frames_for_samples(x3.shape[0])} frames a "
        f"channel) at (1, 4): stream == its unsharded card encode: "
        f"{got3 == want3} ({len(want3)} bytes, sha256 "
        f"{hashlib.sha256(want3).hexdigest()}; first runs: unsharded "
        f"{t_un3:.2f} s, sharded with its inputs captured {t_sh3:.2f} s "
        f"host clock)")
    check(got3 == want3, "config 3 sharded at (1, 4) differs")
    outs = encode(clips, cfg, 4, 2)
    same = sum(o == w for o, w in zip(outs, corpus_streams))
    log(f"[parallel] (a) 64 x 10 s batch at (4, 2): streams == phase 10's "
        f"fused streams: {same}/{len(clips)}")
    check(same == len(clips), "a sharded corpus stream differs")
    enc_launch = read_counts()
    log(f"[parallel] (a) launches in the sharded encodes: {enc_launch}")
    for name, n in enc_launch.items():
        check((n > 0) != (name in SYNTHESIS),
              f"the sharded encodes launched {name} {n} times")

    # (b) sharded decode
    zero_counts()
    for n_data, n_seq in ((1, 4), (2, 2)):
        if (n_data, n_seq) == (1, 4):
            y = captured("sharded 30 s (1, 4) decode",
                         lambda: decode(want, 1, 4))
        else:
            y = decode(want, n_data, n_seq)
        same = bits_equal(y, y_want)
        log(f"[parallel] (b) decode of the 30 s stream at ({n_data}, "
            f"{n_seq}): PCM == codec.decode float32 bitwise: {same}")
        check(same, f"sharded decode ({n_data}, {n_seq}) differs")
    dec_launch = read_counts()
    log(f"[parallel] (b) launches in the sharded decodes: {dec_launch} "
        f"(a decode runs K9, K1 and K10 only)")
    for name in KERNELS:
        used = name in SYNTHESIS or name == "fft_stages"
        check((dec_launch[name] > 0) == used,
              f"the sharded decodes launched {name} {dec_launch[name]} "
              f"times")
    check(dec_launch["synth_pre"] == dec_launch["synth_post"]
          == dec_launch["fft_stages"] // 2,
          "the sharded decodes did not run K9, K1 x 2, K10 a shard")

    # the kernels on this path's own inputs (shard chunks of 648 and 7032
    # frame rows, stream orders from f0 > 0, 48 kHz at 192 kbps)
    for where, c in caps.items():
        log(f"[parallel] {where}: {len(c)} kernel inputs captured")
        hold_to_plain(c, where, err)
        for key, args in c.items():
            if key[0] == "rd_loop":
                log_rd_corners(f"{where} {key[1:]}", args)
    del caps
    torch.cuda.empty_cache()

    # walls: S shards in turn on one card, beside the unsharded encode
    walls = {"unsharded": [], "sharded_1x4": []}
    runs = {"unsharded": lambda: codec.encode(xi, cfg, device=dev),
            "sharded_1x4": lambda: encode([xi], cfg, 1, 4)}
    for _ in range(6):                   # the first round is a warm-up
        for name, fn in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    stats = {k: {"ms": v[1:], "best_ms": min(v[1:]),
                 "median_ms": float(np.median(v[1:]))}
             for k, v in walls.items()}
    log(f"[parallel] walls of a 30 s stereo encode, 5 runs after a warm-up, "
        f"in turns; S shards in turn on one card (an overhead, not "
        f"scaling): unsharded best {stats['unsharded']['best_ms']:.2f} ms, "
        f"median {stats['unsharded']['median_ms']:.2f}; (1, 4) best "
        f"{stats['sharded_1x4']['best_ms']:.2f} ms, median "
        f"{stats['sharded_1x4']['median_ms']:.2f}; ms "
        f"{json.dumps({k: v['ms'] for k, v in stats.items()})}")

    # (c) the data axis over two devices (both card 0, a host thread each),
    # and its walls beside the one-device batch, in turns
    two = corpus.encode_batch(clips, cfg, devices=["cuda:0", "cuda:0"])
    same = sum(a == b for a, b in zip(two, corpus_streams))
    log(f"[parallel] (c) encode_batch over devices ['cuda:0', 'cuda:0'] == "
        f"the one-device batch: {same}/{len(clips)}")
    check(same == len(clips), "the two-device batch differs")
    del outs, two
    batch_ms = {"one": [], "two": []}
    for _ in range(3):
        for name, devs in (("one", ["cuda:0"]), ("two", ["cuda:0"] * 2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            corpus.encode_batch(clips, cfg, devices=devs)
            batch_ms[name].append((time.perf_counter() - t0) * 1e3)
    log(f"[parallel] (c) 64 x 10 s batch walls, 3 runs each in turns, ms: "
        f"one device {batch_ms['one']}, two blocks on card 0 in two host "
        f"threads {batch_ms['two']} (one card: the threads share it)")
    stats["batch_ms"] = batch_ms
    del clips

    # (d) launch scaling, NCCL at world size 1
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mrcaudiocodec_tpu_torch.parallel.launch",
         "scaling", "--backend", "nccl"], cwd=root, capture_output=True,
        text=True, timeout=300)
    log(f"[parallel] (d) launch scaling --backend nccl: exit "
        f"{res.returncode} in {time.perf_counter() - t0:.1f} s; stderr: "
        + " | ".join(res.stderr.strip().splitlines()[-3:]))
    check(res.returncode == 0, f"launch scaling failed: {res.stderr}")
    scaling = json.loads(res.stdout.strip().splitlines()[-1])
    log(f"[parallel] (d) {json.dumps(scaling)}")
    check(scaling["backend"] == "nccl" and scaling["world_size"] == 1,
          "launch scaling did not run NCCL at world size 1")

    # (e) two processes on the one card, gloo
    with tempfile.TemporaryDirectory() as tmp:
        indir, outdir, gdir = (os.path.join(tmp, d)
                               for d in ("in", "out", "group"))
        os.makedirs(indir)
        os.makedirs(gdir)
        paths = []
        for i in range(10):
            p = os.path.join(indir, f"clip{i:02d}.wav")
            audiofile.write_wav(p, corpus._synth_corpus(
                1, 0.6 * (1.0 + 0.3 * (i % 3)), seed=50 + i)[0], 44100)
            paths.append(p)
        # the corpus pair runs while the GroupShards pair below runs
        port = launch.free_port()
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mrcaudiocodec_tpu_torch.parallel.launch",
             "corpus", "--coordinator", f"localhost:{port}", "--num-hosts",
             "2", "--host-id", str(h), "--indir", indir, "--outdir", outdir,
             "--backend", "gloo"], cwd=root, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for h in range(2)]
        mp.spawn(group_shards_worker, args=(2, launch.free_port(), gdir),
                 nprocs=2, join=True)
        t_group = time.perf_counter() - t0
        done = [p.communicate(timeout=300) for p in procs]
        t_corpus = time.perf_counter() - t0
        for h, (p, (out, err)) in enumerate(zip(procs, done)):
            log(f"[parallel] (e) launch corpus host {h}: exit {p.returncode}; "
                f"stderr: {' | '.join(err.strip().splitlines()[-2:])}; "
                f"stdout: {out.strip()}")
            check(p.returncode == 0, f"launch corpus host {h} failed: {err}")
            check("staged through host memory" in err,
                  "the gloo run on the card does not say it stages")
        srcs = []
        for h in range(2):
            with open(os.path.join(outdir, f"manifest_h{h}.jsonl")) as f:
                srcs.append({json.loads(line)["src"] for line in f})
        split = srcs == [set(paths[0::2]), set(paths[1::2])]
        same = 0
        for p in paths:
            x, _ = audiofile.read_wav(p, raw_int16=True)
            with open(os.path.join(outdir, os.path.basename(p)[:-4]
                                   + ".mrc"), "rb") as f:
                same += f.read() == codec.encode(x, cfg, device=dev)
        log(f"[parallel] (e) launch corpus, 2 processes, done "
            f"{t_corpus:.1f} s after their start: "
            f"manifests partition the corpus round-robin: {split}; .mrc == "
            f"codec.encode on the card: {same}/{len(paths)}")
        check(split, "the manifests do not partition the corpus")
        check(same == len(paths), "a launch corpus stream differs")

        _, pclips = parallel_clips()
        wants = [codec.encode(x, cfg, device=dev) for x in pclips]
        held = sorted(n for n in os.listdir(gdir) if n.endswith(".mrc"))
        check(held == [f"r0_c{j}.mrc" for j in range(len(wants))],
              f"the first seq rank does not hold every stream: {held}")
        same = 0
        for j, w in enumerate(wants):
            with open(os.path.join(gdir, f"r0_c{j}.mrc"), "rb") as f:
                same += f.read() == w
        info = []
        for r in range(2):
            with open(os.path.join(gdir, f"r{r}.json")) as f:
                info.append(json.load(f))
        log(f"[parallel] (e) GroupShards at (1, 2), a seq shard in each of 2 "
            f"processes on card 0 (gloo), beside the corpus pair, in "
            f"{t_group:.1f} s: {info}; streams "
            f"held {held}; == codec.encode on the card: {same}/{len(wants)}")
        check(same == len(wants), "a GroupShards stream differs")
        check(all(i["staged"] for i in info), "gloo on the card not staged")

    stats.update(launches_encode=enc_launch, launches_decode=dec_launch,
                 config3_bytes=len(want3), scaling=scaling,
                 corpus_2proc_s=t_corpus, group_2proc_s=t_group,
                 phase_s=time.perf_counter() - t_phase)
    log(f"[parallel] phase done in {stats['phase_s']:.1f} s")
    return stats


BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "seg_snr_db",
              "seg_snr_spec_db", "seg_snr_vs_spec_db", "psnr_db",
              "psnr_spec_db", "device_resident_rtf", "stream_matches_spec"}


def phase_bench(smi):
    """The port's bench on the card (phase 13 of the module docstring);
    its stderr is logged here line by line. -> (launches, JSON result)."""
    import contextlib
    import io
    import torch
    from mrcaudiocodec_tpu_torch import bench
    from mrcaudiocodec_tpu_torch.ops import device_pack, rd
    kernels = kernel_modules()
    fft_stages, quant_cost = kernels[:2]
    plains = ((fft_stages, "fft_plain"), (quant_cost, "payload_bits_plain"),
              (device_pack, "pack_stream_plain"), (rd, "rd_loop_plain"),
              *((m, f"{n}_plain") for m, n in zip(kernels[4:8], ANALYSIS)),
              *((m, f"{n}_plain") for m, n in zip(kernels[8:], SYNTHESIS)))
    plain_calls = {attr: 0 for _, attr in plains}
    saved = [getattr(mod, attr) for mod, attr in plains]
    for (mod, attr), orig in zip(plains, saved):
        def counted(*a, _orig=orig, _attr=attr):
            plain_calls[_attr] += 1
            return _orig(*a)
        setattr(mod, attr, counted)
    out, err = io.StringIO(), io.StringIO()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = bench.main(["--full", "--kernels"])
            torch.cuda.synchronize()
    finally:
        for (mod, attr), orig in zip(plains, saved):
            setattr(mod, attr, orig)
        for line in err.getvalue().splitlines():
            log(f"[bench] {line}")
    dt = time.perf_counter() - t0
    launches = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    lines = out.getvalue().strip().splitlines()
    log(f"[bench] bench.main(['--full', '--kernels']): exit {rc} in "
        f"{dt:.1f} s; K1-K10 launches {launches}; plain versions called "
        f"{plain_calls}; stdout {lines}")
    check(rc == 0 and len(lines) == 1, "the bench did not print one line")
    res = json.loads(lines[0])
    log(f"[bench] {smi}: " + "; ".join(f"{k} {v}" for k, v in res.items()))
    check(set(res) == BENCH_KEYS, f"bench keys {sorted(res)}")
    check(res["stream_matches_spec"] is True,
          "the bench's stream differs from the spec's")
    check(res["seg_snr_vs_spec_db"] == 0.0
          and res["psnr_db"] == res["psnr_spec_db"],
          "the bench's quality differs from the spec's")
    for name, n in launches.items():
        check(n > 0, f"the bench launched no {name}")
    check(not any(plain_calls.values()),
          f"a plain version ran on the bench's path: {plain_calls}")
    dec = [line for line in err.getvalue().splitlines()
           if line.startswith("device-resident decode launches: ")]
    check(len(dec) == 1, "the bench logged no device-resident decode "
          "launches")
    got = json.loads(dec[0].split(": ", 1)[1])
    slabs = got.pop("slabs")
    want = {**{k: 0 for k in KERNELS}, "fft_stages": 2 * slabs,
            **{k: slabs for k in SYNTHESIS}}
    check(got == want, f"the bench's device-resident decode launched {got}, "
          f"not K9, K1 x 2 and K10 a slab")
    return launches, res


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    try:
        import mrcaudiocodec_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the repository root (the port package "
              "mrcaudiocodec_tpu_torch is missing)", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    dev = "cuda"
    smi = phase_card()
    phase_build()
    errs, inputs, rd_sets = phase_kernels(dev)
    times = phase_times(dev, inputs, rd_sets)
    del inputs, rd_sets         # out of the peak memory of later phases
    torch.cuda.empty_cache()
    phase_goldens(dev)
    phase_card_vs_cpu(dev)
    launches, stats = phase_full(dev)
    stats["decide"] = phase_breakdown(dev)
    probe_launches, probe_stats = phase_probes(dev)
    _, corpus_stats, corpus_streams = phase_corpus(dev)
    phase_cli(dev)
    parallel_stats = phase_parallel(dev, corpus_streams, errs)
    del corpus_streams
    torch.cuda.empty_cache()
    _, bench_res = phase_bench(smi)
    meta = {
        "fft_stages": ("cuda", "mrcaudiocodec_tpu_torch/csrc/fft_stages.cu",
                       "mrcaudiocodec_tpu/ops/pallas/xmath_kernel.py:93"),
        "quant_cost": ("cuda", "mrcaudiocodec_tpu_torch/csrc/quant_cost.cu",
                       "mrcaudiocodec_tpu/ops/pallas/quant_kernel.py:235"),
        "record_pack": ("cuda", "mrcaudiocodec_tpu_torch/csrc/record_pack.cu",
                        "mrcaudiocodec_tpu/ops/device_pack.py:181 "
                        "(pack_records_device, XLA; no pallas_call)"),
        "rd_loop": ("cuda", "mrcaudiocodec_tpu_torch/csrc/rd_loop.cu",
                    "mrcaudiocodec_tpu/ops/rd.py:189, :200, :255-269 "
                    "(refine lax.while_loop, fallback lax.cond, outer "
                    "lax.while_loop; XLA, no pallas_call)"),
        "transients": ("cuda", "mrcaudiocodec_tpu_torch/csrc/transients.cu",
                       "mrcaudiocodec_tpu/models/encoder.py:65-120 (jit A: "
                       "framing :93-104, dsp.detect_transients :105, "
                       "_block_types_dev :51; XLA, no pallas_call)"),
        "analysis_pre": ("cuda",
                         "mrcaudiocodec_tpu_torch/csrc/analysis_pre.cu",
                         "mrcaudiocodec_tpu/models/encoder.py:65-120 (jit A; "
                         "native/xmath_ffi.cpp mode 1 and "
                         "native/xpsy_ffi.cpp modes 0-1, before the FFT; "
                         "no pallas_call)"),
        "mdct_post": ("cuda", "mrcaudiocodec_tpu_torch/csrc/mdct_post.cu",
                      "mrcaudiocodec_tpu/models/encoder.py:65-120 (jit A; "
                      "native/xmath_ffi.cpp mode 1 after the FFT, "
                      "dsp.analyze's select; no pallas_call)"),
        "psycho": ("cuda", "mrcaudiocodec_tpu_torch/csrc/psycho.cu",
                   "mrcaudiocodec_tpu/models/encoder.py:65-120 (jit A; "
                   "ops/psycho.py:186 analyze after the FFTs, "
                   "native/xpsy_ffi.cpp modes 0-2; no pallas_call)"),
        "synth_pre": ("cuda", "mrcaudiocodec_tpu_torch/csrc/synth_pre.cu",
                      "mrcaudiocodec_tpu/models/decoder.py:64-102 (the "
                      "decoder jit: e_bin :85, dequantize :90; "
                      "native/xpsy_ffi.cpp mode 5 and native/xmath_ffi.cpp "
                      "mode 2 before the FFT; no pallas_call)"),
        "synth_post": ("cuda", "mrcaudiocodec_tpu_torch/csrc/synth_post.cu",
                       "mrcaudiocodec_tpu/models/decoder.py:64-102 (the "
                       "decoder jit :91-101: dsp.synthesize, "
                       "ops/dsp.py:274-291, native/xmath_ffi.cpp mode 2 "
                       "after the FFT, overlap-add, int16; native/"
                       "xpsy_ffi.cpp mode 5 feeds it; no pallas_call)"),
        "pad_rows": ("cuda", "mrcaudiocodec_tpu_torch/csrc/pad_rows.cu",
                     "none: the host pad, mrcaudiocodec_tpu/models/"
                     "encoder.py:181 (_padded_rows, numpy; no "
                     "pallas_call)"),
    }
    launches["pad_rows"] = times["pad_rows"].pop("launches")
    errs["pad_rows"] = 0.0
    kernels = []
    for name, (route, source, replaces) in meta.items():
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": errs[name], "checked": True,
                        **times[name]})
    for body, (_, name, source, replaces) in PROBE_BODIES.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": f"mrcaudiocodec_tpu_torch/csrc/{source}",
                        "replaces": replaces,
                        "launches": probe_launches[body], "checked": True,
                        **probe_stats[body]})
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"stats {json.dumps(stats)}; corpus {json.dumps(corpus_stats)}; "
        f"parallel {json.dumps(parallel_stats)}; bench "
        f"{json.dumps(bench_res)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
