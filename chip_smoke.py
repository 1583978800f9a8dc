#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failure raises, so the exit code is non-zero:
  1. card: name and power limit (nvidia-smi), CUDA version, capability 9.0
  2. build: both CUDA kernels from csrc/ (nvcc, -Xptxas -v per kernel)
  3. kernels against their plain PyTorch versions, bitwise:
     K1 fft_stages at all four FFT sizes (card kernel vs plain on the card
     and on the CPU); K2 quant_cost at G in {32, 8, 4, 1}, zero and random
     amplification, all block types, fs 44100/48000/32000
  4. goldens g1-g6 encoded on the card against their SHA-256 digests;
     each decoded on the card and on the CPU, PCM bitwise equal
  5. a 4 s stereo 128 kbps clip: card stream == CPU stream, decodes equal
  6. full size: the benchmark clip (30 s stereo 44.1 kHz 128 kbps, int16)
     encoded and decoded on the card, kernel launch counts of that run,
     then one warm-up and 5 timed runs of each
  7. where the time goes: host-clock ms per encode/decode stage, and the
     card's busy share with the top kernels (torch.profiler), with K1's
     and K2's launches and device ms in one encode and one decode
  8. at the main path's shapes, each kernel again against its plain
     version (bitwise), then its time (CUDA events, and the profiler's
     device time per launch: K1 per FFT layout, K2 per G) beside the
     plain version's, one PyTorch library call where one exists
     (torch.fft.fft for K1, events and device time), and the card's bound
  9. the probe path (P1-P5, mrcaudiocodec_tpu_torch/probes/): builds the
     four probe libraries and the --fmad=true control, runs each probe
     module on the card with the launch counts, asserts P3's
     classifications and the SASS audit (no FFMA, no .FTZ where the
     sources allow none; FFMA in the control), holds each of the 15 probe
     bodies against its plain version (bitwise; v1 within 4 if exp2f/powf
     differ), and times each beside its plain version, its bound and a
     library call; P1 and P4 again at 2048 rows
 10. one JSON line listing the kernels
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

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
# H100 SXM f32 outside the tensor cores is 67e12 FLOP/s (data sheet), which
# counts one FMA as two operations. The kernels are built with --fmad=false
# and every counted op is its own instruction (an add, a multiply, a
# compare), so they issue at half that: 132 SMs x 128 lanes x ~1.98 GHz.
F32_OPS_PER_S = 67e12 / 2

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


def make_clip(fs: int, seconds: float, channels: int, seed=0):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = np.zeros(n, np.float32)
    for f0, a in [(220, 0.3), (440, 0.2), (1320, 0.12), (3520, 0.07)]:
        x += (a * np.sin(2 * np.pi * f0 * t + 0.1 * np.sin(2 * np.pi * 0.5 * t))
              ).astype(np.float32)
    x += (0.02 * rng.standard_normal(n)).astype(np.float32)
    for pos in range(fs // 2, n - 300, int(0.7 * fs)):
        x[pos:pos + 96] += (0.5 * rng.standard_normal(96)).astype(np.float32)
    x = np.clip(x, -1, 1)
    if channels == 2:
        return np.stack([x, np.roll(x, 11) * 0.9], axis=1)
    return x[:, None]


def to_i16(xf):
    return np.clip(np.round(xf * 32768.0), -32768, 32767).astype(np.int16)


def segmental_snr(x, y, seg=1024):
    n = (len(x) // seg) * seg
    xs = x[:n].reshape(-1, seg)
    ys = y[:n].reshape(-1, seg)
    num = (xs ** 2).mean(axis=1)
    den = ((xs - ys) ** 2).mean(axis=1)
    keep = num > 1e-8
    return float(np.mean(10 * np.log10((num[keep] + 1e-30)
                                       / (den[keep] + 1e-30))))


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
    return float((a.double().cpu() - b.double().cpu()).abs().max())


def device_ms(fn, iters: int = 20, match=None):
    """Mean device ms per call of fn() from torch.profiler's kernel times:
    the kernels whose name holds `match`, or (match None) every kernel fn
    launched. None if the profiler recorded no kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can miss the first launches of a session: open it with
        # fills, which no measured function launches, and leave them out
        pad = torch.empty(1024, device="cuda")
        for _ in range(50):
            pad.fill_(1.0)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if t > 0 and "FillFunctor" not in e.key and (
                match is None or match in e.key):
            total += t
    return total / 1e3 / iters if total > 0 else None


def kernel_device_totals(prof, names):
    """{name: (launches, device ms)} summed over the profiled run's
    kernels whose name holds `name`."""
    out = {n: (0, 0.0) for n in names}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        for n in names:
            if n in e.key and t > 0:
                c, ms = out[n]
                out[n] = (c + e.count, ms + t / 1e3)
    return out


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


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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
        "(1 frame at G >= 4, 4 / G below), set at launch")


def phase_kernels(dev):
    """Each kernel against its plain version, bitwise. -> max |err| each."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch import tables as T
    from mrcaudiocodec_tpu_torch.ops.kernels import fft_stages, quant_cost
    rng = np.random.default_rng(2024)
    log("[kernels] tolerance 0: kernel and plain outputs must be equal bit "
        "for bit (f32 compared as int32 patterns)")
    err = {"fft_stages": 0.0, "quant_cost": 0.0}
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
    return err


def phase_goldens(dev):
    import torch
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec
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


def phase_card_vs_cpu(dev):
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    x = make_clip(44100, 4.0, 2, seed=4)
    t0 = time.perf_counter()
    bs_card = codec.encode(x, cfg, device=dev)
    t1 = time.perf_counter()
    bs_cpu = codec.encode(x, cfg, device="cpu")
    t2 = time.perf_counter()
    y_card, _ = codec.decode(bs_card, device=dev)
    y_cpu, _ = codec.decode(bs_cpu, device="cpu")
    same_pcm = bits_equal(y_card, y_cpu)
    log(f"[card-vs-cpu] 4 s stereo: streams equal {bs_card == bs_cpu} "
        f"({len(bs_card)} bytes; card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s "
        f"host clock); decodes bitwise equal {same_pcm}")
    check(bs_card == bs_cpu, "card and CPU streams differ")
    check(same_pcm, "card and CPU decodes differ")


def phase_full(dev):
    """Main path at full size; returns (launch counts, stats)."""
    import torch
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec
    from mrcaudiocodec_tpu_torch.ops import rd
    from mrcaudiocodec_tpu_torch.ops.kernels import fft_stages, quant_cost
    seconds = 30.0
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    xi = to_i16(make_clip(44100, seconds, 2))
    x = xi.astype(np.float32) / np.float32(32768.0)

    kernels = (fft_stages, quant_cost)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    rd.host_syncs = 0
    bs = codec.encode(xi, cfg, device=dev)
    torch.cuda.synchronize()
    enc_launch = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    syncs = rd.host_syncs
    enc_peak = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    y, _ = codec.decode(bs, device=dev)
    torch.cuda.synchronize()
    dec_launch = {k.__name__.rsplit(".", 1)[-1]: k.launches for k in kernels}
    dec_peak = torch.cuda.max_memory_allocated()
    log(f"[full] launches in one encode: {enc_launch}; in one decode: "
        f"{dec_launch}; RD loop-exit host syncs in the encode: {syncs}")
    check(enc_launch["fft_stages"] > 0, "encode launched no fft_stages")
    check(enc_launch["quant_cost"] > 0, "encode launched no quant_cost")
    check(dec_launch["fft_stages"] > 0, "decode launched no fft_stages")
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
             "host_syncs": syncs}
    log(f"[full] 30 s stereo 44.1 kHz 128 kbps int16: encode ms {enc_ms} "
        f"(RTF {stats['encode_rtf']:.2f}x best); decode ms {dec_ms} "
        f"(RTF {stats['decode_rtf']:.2f}x best); {kbps:.2f} kbps; "
        f"segSNR ch0 {ssnr:.2f} dB; peak memory encode {enc_peak} B, "
        f"decode {dec_peak} B")
    launches = {k: enc_launch[k] + dec_launch[k] for k in enc_launch}
    return launches, stats


def phase_breakdown(dev):
    """Where one full-size encode and decode spend their time: host-clock
    laps around each stage (each closed by a synchronize), and the card's
    busy share from torch.profiler's kernel times over one whole run."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch.config import CodecConfig
    from mrcaudiocodec_tpu_torch.models import codec, decoder, encoder, packing
    from mrcaudiocodec_tpu_torch.ops import reservoir
    seconds = 30.0
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    xi = to_i16(make_clip(44100, seconds, 2))
    bs = codec.encode(xi, cfg, device=dev)                    # warm-up
    laps = {}

    def lap(name, t0):
        torch.cuda.synchronize()
        laps[name] = laps.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

    # the stages of encoder.encode_arrays, called one by one
    torch.cuda.synchronize()
    t = time.perf_counter()
    nf = C.frames_for_samples(xi.shape[0])
    P = encoder._padded_rows(xi, nf)
    lap("enc.pad", t)
    spans = encoder.chunk_spans(nf)
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
    t = time.perf_counter()
    arrays = encoder.download(decisions)
    lap("enc.download", t)
    t = time.perf_counter()
    packed = packing.pack_stream(arrays, nf, xi.shape[0], cfg)
    lap("enc.pack", t)
    check(packed == bs, "the staged encode differs from codec.encode")
    t = time.perf_counter()
    decoder.parse_records(bs)
    lap("dec.parse", t)
    t = time.perf_counter()
    codec.decode(bs, device=dev, pcm_dtype="int16")
    lap("dec.total", t)
    log("[breakdown] 30 s stereo, host-clock ms per stage: "
        + json.dumps({k: round(v, 3) for k, v in laps.items()}))

    # busy share = device time (the profiler's kernel and copy times) over
    # the best UNprofiled wall time: the profiled run's own wall time
    # includes the profiler's start-up
    from torch.profiler import ProfilerActivity, profile
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
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [(e.key, getattr(e, "self_device_time_total", 0) / 1e3,
                 e.count) for e in prof.key_averages()]
        rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        if busy == 0:
            log(f"[profile] {name}: device time not measured (the profiler "
                f"recorded no kernel time)")
            continue
        log(f"[profile] {name}: best wall {min(walls):.2f} ms (unprofiled), "
            f"device time {busy:.2f} ms, busy share "
            f"{busy / min(walls):.3f}, {sum(r[2] for r in rows)} device "
            f"events")
        for key, ms, count in rows[:8]:
            log(f"[profile] {name}:   {ms:9.3f} ms  x{count:<6} {key[:90]}")
        tot = kernel_device_totals(prof, ("fft_stages_kernel",
                                          "quant_cost_kernel"))
        log(f"[profile] {name}: K1 fft_stages {tot['fft_stages_kernel'][0]} "
            f"launches, {tot['fft_stages_kernel'][1]:.4f} ms device; K2 "
            f"quant_cost {tot['quant_cost_kernel'][0]} launches, "
            f"{tot['quant_cost_kernel'][1]:.4f} ms device")


def phase_times(dev):
    """Kernel, plain and library times at the main path's shapes, and the
    card's bound for the same work. Shapes: one encode chunk of 1024
    frames x 2 channels = 2048 frame rows."""
    import torch
    from mrcaudiocodec_tpu_torch import config as C
    from mrcaudiocodec_tpu_torch import tables as T
    from mrcaudiocodec_tpu_torch.ops.kernels import fft_stages, quant_cost
    rng = np.random.default_rng(7)
    rows = 2048
    out = {}

    # K1: the four FFT layouts one analyze chunk runs (MDCT long/short,
    # psycho long/short), each over 2048 frame rows. Event ms hold the
    # host's launch interval where a kernel is short; device ms (the
    # profiler's kernel time per launch) do not.
    k_ms = p_ms = l_ms = kd_ms = ld_ms = bytes_ = ops = 0.0
    by_shape = {}
    for n in fft_stages.FFT_SIZES:
        shape = (rows, n) if n >= 512 else (rows, 8, n)
        zr = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                              ).to(dev)
        zi = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                              ).to(dev)
        zc = torch.complex(zr, zi)
        kr, ki = fft_stages.fft_kernel(zr, zi)
        pr, pi = fft_stages.fft_plain(zr, zi)
        check(bits_equal(kr, pr) and bits_equal(ki, pi),
              f"fft_stages n={n} {shape} differs from its plain version")
        km = cuda_ms(lambda: fft_stages.fft_kernel(zr, zi), 50)
        pm = cuda_ms(lambda: fft_stages.fft_plain(zr, zi), 10)
        lm = cuda_ms(lambda: torch.fft.fft(zc, dim=-1), 50)
        kd = device_ms(lambda: fft_stages.fft_kernel(zr, zi),
                       match="fft_stages_kernel")
        ld = device_ms(lambda: torch.fft.fft(zc, dim=-1))
        points = zr.numel()
        stages = n.bit_length() - 1
        # each point read and written once, plus the compact twiddle table
        b = points * 16 + (n - 1) * 8
        o = points // 2 * stages * 10
        bound = max(b / HBM_BYTES_PER_S, o / F32_OPS_PER_S) * 1e3
        log(f"[times] fft_stages n={n} {shape} (kernel == plain bitwise): "
            f"kernel {km:.4f} ms event, {kd} ms device; plain "
            f"{pm:.4f} ms; torch.fft.fft {lm:.4f} ms event, {ld} ms device; "
            f"bound {bound:.4f} ms")
        by_shape[f"n={n}"] = dict(ms=km, device_ms=kd, library_ms=lm,
                                  library_device_ms=ld, bound_ms=bound)
        k_ms += km
        p_ms += pm
        l_ms += lm
        kd_ms += kd or 0.0
        ld_ms += ld or 0.0
        bytes_ += b
        ops += o
    t_b, t_o = bytes_ / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    out["fft_stages"] = dict(ms=k_ms, device_ms=kd_ms, plain_ms=p_ms,
                             library_ms=l_ms, library_device_ms=ld_ms,
                             bound_ms=max(t_b, t_o),
                             bound_by="bytes" if t_b >= t_o else "operations",
                             by_shape=by_shape)
    log(f"[times] fft_stages, the four layouts summed: kernel {kd_ms:.4f} ms "
        f"device, torch.fft.fft {ld_ms:.4f} ms device, bound "
        f"{max(t_b, t_o):.4f} ms")

    # K2: the coarse G=32 sweep over 2048 frames (the dominant call), then
    # the fine (G=8, amp 0), refine (G=4) and fallback (G=1) widths, the
    # last two with amplified scale factors as in outer iterations 2+
    fs = 44100
    lay = T.unified_layout(fs)
    bt_np = (np.arange(rows) % C.N_BLOCK_TYPES).astype(np.int32)
    amp = rng.integers(0, C.AMP_MAX + 1, (rows, lay["nb"]))
    amp_bins = {0: np.zeros((rows, C.LONG_COEFFS), np.int32),
                1: np.take_along_axis(amp, lay["bin_band"][bt_np], 1
                                      ).astype(np.int32)}
    x = torch.from_numpy((rng.standard_normal((rows, C.LONG_COEFFS))
                          * 10.0 ** rng.uniform(-2, 2, (rows, 1))
                          ).astype(np.float32)).to(dev)
    bt = torch.from_numpy(bt_np).to(dev)
    by_g = {}
    for g in (32, 8, 4, 1):
        amp_bin = torch.from_numpy(amp_bins[int(g < 8)]).to(dev)
        gains = torch.from_numpy(np.broadcast_to(
            np.arange(0, 256, 256 // g, dtype=np.int32)[:g], (rows, g)
        ).copy()).to(dev)
        check(bits_equal(quant_cost.payload_bits_kernel(x, amp_bin, gains, bt,
                                                        fs),
                         quant_cost.payload_bits_plain(x, amp_bin, gains, bt,
                                                       fs)),
              f"quant_cost G={g} [{rows}, {g}] differs from its plain version")
        km = cuda_ms(lambda: quant_cost.payload_bits_kernel(
            x, amp_bin, gains, bt, fs), 20)
        pm = cuda_ms(lambda: quant_cost.payload_bits_plain(
            x, amp_bin, gains, bt, fs), 3, warmup=1)
        kd = device_ms(lambda: quant_cost.payload_bits_kernel(
            x, amp_bin, gains, bt, fs), match="quant_cost_kernel")
        b = rows * C.LONG_COEFFS * 8 + rows * (2 * g + 1) * 4
        o = rows * g * C.LONG_COEFFS * 54
        t_b, t_o = b / HBM_BYTES_PER_S * 1e3, o / F32_OPS_PER_S * 1e3
        log(f"[times] quant_cost G={g} [{rows}, {g}] (kernel == plain "
            f"bitwise): kernel {km:.4f} ms event, {kd} ms device; "
            f"plain {pm:.4f} ms, bound {max(t_b, t_o):.4f} ms "
            f"({'bytes' if t_b >= t_o else 'operations'})")
        by_g[f"G={g}"] = dict(ms=km, device_ms=kd, bound_ms=max(t_b, t_o))
        if g == 32:
            out["quant_cost"] = dict(
                ms=km, device_ms=kd, plain_ms=pm, library_ms=None,
                bound_ms=max(t_b, t_o),
                bound_by="bytes" if t_b >= t_o else "operations")
    out["quant_cost"]["by_g"] = by_g
    log_instruction_mix()
    return out


# SASS mnemonics by kind of work (IMAD and MOV may issue to the f32 pipe)
MIX_CLASSES = {
    "f32": ("FADD", "FMUL", "FSETP", "FSEL", "FMNMX", "FRND", "F2I", "I2F"),
    "int": ("IADD3", "IMAD", "LOP3", "SHF", "LEA", "ISETP", "SEL", "VIMNMX",
            "VIADD", "VIADDMNMX", "IMNMX", "FLO", "IABS", "PRMT", "MOV",
            "IADD", "SGXT"),
    "shared": ("LDS", "STS"),
    "global": ("LDG", "STG"),
    "warp": ("SHFL", "REDUX", "MATCH", "VOTE"),
    "control": ("BRA", "BSSY", "BSYNC", "BAR", "EXIT", "CALL", "RET"),
}


def log_instruction_mix():
    """Each K1/K2 kernel's SASS instructions (cuobjdump -sass), by class:
    the static counts the device times are read against (K1's kernels are
    straight-line code, K2's gain loop is unrolled over a lane's 8 tuples,
    32 bins)."""
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
# H100 SXM: 64 INT32 lanes per SM against 128 FP32 (Hopper white paper)
INT32_OPS_PER_S = F32_OPS_PER_S / 2
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
    outs = out if isinstance(out, tuple) else (out,)
    b = sum(t.numel() * t.element_size() for t in args + outs
            if isinstance(t, torch.Tensor))
    f, i = probe_ops(body, args)
    t_b = b / HBM_BYTES_PER_S * 1e3
    t_o = (f / F32_OPS_PER_S + i / INT32_OPS_PER_S) * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


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
    errs = phase_kernels(dev)
    phase_goldens(dev)
    phase_card_vs_cpu(dev)
    launches, stats = phase_full(dev)
    phase_breakdown(dev)
    times = phase_times(dev)
    probe_launches, probe_stats = phase_probes(dev)
    meta = {
        "fft_stages": ("cuda", "mrcaudiocodec_tpu_torch/csrc/fft_stages.cu",
                       "mrcaudiocodec_tpu/ops/pallas/xmath_kernel.py:93"),
        "quant_cost": ("cuda", "mrcaudiocodec_tpu_torch/csrc/quant_cost.cu",
                       "mrcaudiocodec_tpu/ops/pallas/quant_kernel.py:235"),
    }
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
        f"stats {json.dumps(stats)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
