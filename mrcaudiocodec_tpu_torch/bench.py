"""The port's benchmark harness: the repository's `bench.py` on the
PyTorch port, with the port's own NumPy spec codec (`spec/`).

    python -m mrcaudiocodec_tpu_torch.bench [--full] [--kernels]
        [--seconds 30] [--spec-seconds 4] [--device cuda|cpu]

It measures the headline metric, the encode realtime factor per card at
128 kbps stereo 44.1 kHz (int16 input), and `vs_baseline`: that over the
realtime factor of the normative NumPy spec codec, which runs on the
host's CPU (a host number, not the card's). It prints ONE JSON line with
the root bench.py's keys (metric, value, unit, vs_baseline, seg_snr_db,
seg_snr_spec_db, seg_snr_vs_spec_db, psnr_db, psnr_spec_db,
device_resident_rtf, stream_matches_spec) and logs on stderr:

  - spec RTF: `spec.codec.encode` of the --spec-seconds clip, best of
    SPEC_TRIALS after a warm-up on its first second;
  - encode RTF: `models.codec.encode` of the --seconds clip, best of
    ENCODE_TRIALS after a warm-up (which builds the CUDA kernels), each
    trial closed by the encode's return (its body download); quartiles and
    worst logged beside the best;
  - device_resident_rtf: the audio chunks and stream orders staged on the
    device before the clock; `encoder.encode_chunks` (analysis, budgets,
    RD + codebooks with K2 and K4, record pack with K3 and its status
    read), then a synchronize; no body download. Best of RESIDENT_TRIALS;
  - quality: the --spec-seconds clip encoded and decoded by the port and
    by the spec: segmental SNR (channel 0), PSNR, equal stream bytes;
  - --full: decode RTF (`decode(bs, pcm_dtype="int16")`, a warm-up and one
    timed run), then the device-resident decode: records parsed and staged
    in slabs of DEC_CHUNK frames before the clock, `decoder._synth_chunk`
    per slab (K9, K1 x 2, K10), each taking the slab before's tail, a
    synchronize; best of RESIDENT_TRIALS;
    on the card one more run's launch counts are logged as JSON
    ("device-resident decode launches: ...");
  - --kernels (card only; run last, so that no profiler session precedes
    the timings above): on the --seconds clip's first chunk, staged on
    the card, the wall and profiler device ms per call of the encoder's
    analysis, RD + codebook and pack stages, K1-K8's device ms in them
    against the card's bound, and K1 beside torch.fft.fft with their
    inputs in L2 and evicted from it.

It runs on the card unless --device cpu is given; --device cuda without a
card exits non-zero, and nothing falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .profiling import log

ENCODE_TRIALS = 16          # timed encodes after the warm-up
SPEC_TRIALS = 3             # timed spec encodes after the warm-up
RESIDENT_TRIALS = 4         # timed device-resident encodes and decodes
KERNEL_CALLS = 10           # calls per stage in --kernels
EVICT_BYTES = 128 << 20     # written before each evicted launch: > 2x L2


def make_clip(fs: int, seconds: float, channels: int, seed=0):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = np.zeros(n, np.float32)
    # music-like: evolving tone stack + noise floor + periodic transients
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


def psnr(x, y):
    """Peak SNR of decoded PCM (full-scale peak = 1.0)."""
    mse = float(np.mean((np.asarray(x, np.float64) - y) ** 2))
    return 10 * np.log10(1.0 / (mse + 1e-30))


def segmental_snr(x, y, seg=1024):
    n = (len(x) // seg) * seg
    xs = x[:n].reshape(-1, seg)
    ys = y[:n].reshape(-1, seg)
    num = (xs ** 2).mean(axis=1)
    den = ((xs - ys) ** 2).mean(axis=1)
    keep = num > 1e-8
    return float(np.mean(10 * np.log10((num[keep] + 1e-30)
                                       / (den[keep] + 1e-30))))


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best(fn, trials: int) -> float:
    """Best host-clock seconds of `trials` calls of fn() (each closes its
    own work), after one warm-up call."""
    fn()
    best = 1e30
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def kernel_report(dev, cfg, xi):
    """--kernels: the encoder's stages on the clip's first chunk, staged on
    the card; stderr only."""
    import torch
    from . import profiling as P
    from .models import encoder
    from .ops import device_pack, reservoir
    from .ops.kernels import fft_stages
    nch = cfg.channels
    nf = cfg.frames_for_samples(xi.shape[0])
    rows = encoder._padded_rows(xi, nf)
    f0, s = encoder.chunk_spans(nf, nch)[0]
    audio = encoder.upload_chunk(rows, f0, s, dev)
    order = torch.from_numpy(
        encoder.stream_order(None, nch, f0, s, nch)[0]).to(dev)
    cap = device_pack.pack_cap_bytes(cfg)
    chunk = encoder._analyze_chunk(audio, cfg)
    budgets = reservoir.allocate(chunk[3], cfg)
    decisions = encoder.decide_chunk(chunk, budgets, cfg)
    frames = nch * s
    log(f"[kernels] the {xi.shape[0] / cfg.fs:g} s clip's first chunk: "
        f"{frames} frame rows ({nch} x {s} frames); bound = max(bytes / "
        f"{P.HBM_BYTES_PER_S:.3g} B/s, f32 ops / {P.F32_OPS_PER_S:.3g} + "
        f"int32 ops / {P.INT32_OPS_PER_S:.3g} per s), H100 SXM at 700 W")
    stages = (("analyze", lambda: encoder._analyze_chunk(audio, cfg)),
              ("decide", lambda: encoder.decide_chunk(chunk, budgets, cfg)),
              ("pack", lambda: encoder.pack_chunk(decisions, order, cfg,
                                                  cap)))
    k1_inputs = {}
    for name, fn in stages:
        fn()
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(KERNEL_CALLS):
            fn()
        _sync(dev)
        wall = (time.perf_counter() - t0) / KERNEL_CALLS * 1e3
        busy = P.device_ms(fn, KERNEL_CALLS)
        share = "not measured" if busy is None else f"{busy / wall:.3f}"
        log(f"[kernels] {name}: {wall:.3f} ms wall a call, {busy} ms device "
            f"(busy share {share}), {frames / wall * 1e3:.0f} frames/s")
        caps = P.capture_inputs(fn, per_key=1 << 10)
        for k in P.KERNEL_NAMES:
            mine = [(key, a) for key, a in caps.items() if key[0] == k]
            if not mine:
                continue
            ms = P.device_ms(fn, KERNEL_CALLS, match=f"{k}_kernel",
                             per_call=len(mine))
            bound, by = P.bound_ms([P.kernel_bound(key, a)
                                    for key, a in mine])
            per = "not measured" if ms is None else f"{ms / len(mine):.5f}"
            ratio = "" if ms is None else f", {ms / bound:.2f}x the bound"
            log(f"[kernels] {name}: {k} {len(mine)} launches "
                f"{sorted({key[1] for key, _ in mine})}, {ms} ms device a "
                f"call ({per} a launch), bound {bound:.5f} ms ({by}){ratio}")
            if k == "fft_stages":
                k1_inputs.update(mine)
    # K1 beside torch.fft.fft on the analysis' own FFT inputs, once with
    # them in L2 (back to back) and once evicted (EVICT_BYTES written
    # before each launch; the fill is left out of the device time)
    flush = torch.empty(EVICT_BYTES // 4, device=dev)
    times = {}
    for key, (re, im) in k1_inputs.items():
        zc = torch.complex(re, im)
        runs = {"K1": lambda: fft_stages.fft_kernel(re, im),
                "torch.fft.fft": lambda: torch.fft.fft(zc, dim=-1)}
        got = {}
        for lib, fn in runs.items():
            match = "fft_stages_kernel" if lib == "K1" else None
            got[lib, "warm"] = P.device_ms(fn, KERNEL_CALLS, match=match)
            got[lib, "evicted"] = P.device_ms(
                lambda: (flush.fill_(1.0), fn()), KERNEL_CALLS, match=match)
        for k, v in got.items():
            times.setdefault(k, []).append(v)
        log(f"[kernels] fft {key[1]}: device ms K1 warm {got['K1', 'warm']}, "
            f"evicted {got['K1', 'evicted']}; torch.fft.fft warm "
            f"{got['torch.fft.fft', 'warm']}, evicted "
            f"{got['torch.fft.fft', 'evicted']}")
    sums = {k: None if None in v else sum(v) for k, v in times.items()}
    log(f"[kernels] fft, the {len(k1_inputs)} layouts summed, device ms: K1 "
        f"warm {sums['K1', 'warm']}, evicted {sums['K1', 'evicted']}; "
        f"torch.fft.fft warm {sums['torch.fft.fft', 'warm']}, evicted "
        f"{sums['torch.fft.fft', 'evicted']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mrcaudiocodec_tpu_torch.bench")
    ap.add_argument("--full", action="store_true",
                    help="decode RTF and the device-resident decode on stderr")
    ap.add_argument("--kernels", action="store_true",
                    help="per-stage and per-kernel device times on stderr "
                         "(card only)")
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--spec-seconds", type=float, default=4.0,
                    help="clip length for the (slow) spec baseline")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if args.kernels and args.device != "cuda":
        ap.error("--kernels times the CUDA kernels: it needs --device cuda")

    import torch
    from . import bitstream, profiling
    from .config import CodecConfig
    from .models import codec, decoder, encoder
    from .ops import device_pack
    from .spec import codec as scodec
    try:
        dev = encoder.device_for(args.device)
    except RuntimeError:
        raise SystemExit("error: no CUDA card is available; run with "
                         "--device cpu") from None
    if dev.type == "cuda":
        log(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: "
            f"{profiling.card_line()}; torch {torch.__version__} CUDA "
            f"{torch.version.cuda}")
    else:
        log(f"device: cpu (torch {torch.__version__}); no card number below")

    fs, channels, bitrate = 44100, 2, 128000
    cfg = CodecConfig(fs=fs, channels=channels, bitrate=bitrate)
    xi = to_i16(make_clip(fs, args.seconds, channels))

    # --- spec baseline RTF (the denominator). Both codecs see 16-bit
    # source material: the spec takes the float view x/32768, the port the
    # raw int16 (bit-identical values).
    xi_spec = to_i16(make_clip(fs, args.spec_seconds, channels))
    x_spec = xi_spec.astype(np.float32) / np.float32(32768.0)
    scodec.encode(x_spec[:fs], cfg)      # steady state: build table caches
    spec_dt = 1e30
    for _ in range(SPEC_TRIALS):
        t0 = time.perf_counter()
        bs_spec = scodec.encode(x_spec, cfg)
        spec_dt = min(spec_dt, time.perf_counter() - t0)
    spec_rtf = args.spec_seconds / spec_dt
    log(f"spec encode (NumPy on the host CPU, not a card number): "
        f"{spec_dt:.3f} s for {args.spec_seconds} s -> RTF {spec_rtf:.3f}x "
        f"(best of {SPEC_TRIALS})")

    # --- encode RTF (the warm-up builds the kernels)
    t0 = time.perf_counter()
    codec.encode(xi, cfg, device=dev)
    log(f"encode warm-up (on the card it builds the kernels): "
        f"{time.perf_counter() - t0:.2f} s")
    trials = []
    for _ in range(ENCODE_TRIALS):
        t0 = time.perf_counter()
        bs = codec.encode(xi, cfg, device=dev)
        trials.append(time.perf_counter() - t0)
    enc_dt = min(trials)
    q1, med, q3 = np.percentile(trials, [25, 50, 75])
    log(f"encode trials ({len(trials)}) ms: best {enc_dt * 1e3:.2f}, q1 "
        f"{q1 * 1e3:.2f}, median {med * 1e3:.2f}, q3 {q3 * 1e3:.2f}, worst "
        f"{max(trials) * 1e3:.2f}")
    enc_rtf = args.seconds / enc_dt
    nf = cfg.frames_for_samples(xi.shape[0])
    log(f"encode: {enc_dt:.4f} s for {args.seconds} s stereo -> RTF "
        f"{enc_rtf:.1f}x ({nf * channels / enc_dt:.0f} frames/s), rate "
        f"{len(bs) * 8 / args.seconds / 1000:.1f} kbps")

    # --- device-resident encode: audio and stream orders staged first
    rows = encoder._padded_rows(xi, nf)
    spans = encoder.chunk_spans(nf, rows.shape[0])
    audio = [encoder.upload_chunk(rows, f0, s, dev) for f0, s in spans]
    orders = [torch.from_numpy(encoder.stream_order(
        None, channels, f0, s, rows.shape[0])[0]).to(dev) for f0, s in spans]
    cap = device_pack.pack_cap_bytes(cfg)

    def run_resident():
        for _ in encoder.encode_chunks(audio, orders, spans, None, cfg, cap):
            pass
        _sync(dev)

    dev_dt = _best(run_resident, RESIDENT_TRIALS)
    dev_rtf = args.seconds / dev_dt
    log(f"device-resident encode (audio and orders staged): "
        f"{dev_dt * 1e3:.2f} ms -> RTF {dev_rtf:.1f}x")
    del audio, orders

    # --- quality against the spec: the same clip through both codecs,
    # each decoding its own stream
    bs_port_q = codec.encode(xi_spec, cfg, device=dev)
    y_port_q, _ = codec.decode(bs_port_q, device=dev)
    y_spec_q, _ = scodec.decode(bs_spec)
    ssnr_port = segmental_snr(x_spec[:, 0], y_port_q[:, 0])
    ssnr_spec = segmental_snr(x_spec[:, 0], y_spec_q[:, 0])
    psnr_port = psnr(x_spec, y_port_q)
    psnr_spec = psnr(x_spec, y_spec_q)
    same_stream = bs_port_q == bs_spec
    log(f"quality ({args.spec_seconds} s clip @128 kbps): segSNR port "
        f"{ssnr_port:.4f} dB vs spec {ssnr_spec:.4f} dB; PSNR port "
        f"{psnr_port:.4f} dB vs spec {psnr_spec:.4f} dB; streams "
        f"{'byte-identical' if same_stream else 'differ'}")

    if args.full:
        dec_dt = _best(lambda: codec.decode(bs, device=dev,
                                            pcm_dtype="int16"), 1)
        log(f"decode: {dec_dt * 1e3:.2f} ms -> RTF "
            f"{args.seconds / dec_dt:.1f}x")
        dcfg = bitstream.read_header(bs)[0]
        slabs = [tuple(torch.from_numpy(a).to(dev) for a in slab)
                 for slab in decoder.record_slabs(bs)]

        def run_dec():
            tail = None
            for q, e, b in slabs:
                _, _, tail = decoder._synth_chunk(q, e, b, dcfg.fs,
                                                  dcfg.window, True, tail)
            _sync(dev)

        ddt = _best(run_dec, RESIDENT_TRIALS)
        log(f"device-resident decode (records staged, {len(slabs)} slabs of "
            f"<= {decoder.DEC_CHUNK} frames): {ddt * 1e3:.2f} ms -> RTF "
            f"{args.seconds / ddt:.1f}x")
        if dev != "cpu":
            mods = profiling.kernel_modules()
            for m in mods:
                m.launches = 0
            run_dec()
            log("device-resident decode launches: " + json.dumps(
                {"slabs": len(slabs), **{n: m.launches for n, m in zip(
                    profiling.KERNEL_NAMES, mods)}}))
    if args.kernels:
        # last: the profiler's sessions stay out of the timings above
        t0 = time.perf_counter()
        kernel_report(dev, cfg, xi)
        log(f"[kernels] done in {time.perf_counter() - t0:.1f} s")
    log(f"bench done in {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({
        "metric": "encode_realtime_factor_per_chip_128kbps_stereo",
        "value": round(enc_rtf, 2),
        "unit": "x_realtime",
        "vs_baseline": round(enc_rtf / spec_rtf, 2),
        "seg_snr_db": round(ssnr_port, 2),
        "seg_snr_spec_db": round(ssnr_spec, 2),
        "seg_snr_vs_spec_db": round(ssnr_port - ssnr_spec, 2),
        "psnr_db": round(psnr_port, 2),
        "psnr_spec_db": round(psnr_spec, 2),
        "device_resident_rtf": round(dev_rtf, 1),
        "stream_matches_spec": same_stream,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
