"""The encoder's analysis and the decoder's synthesis beside another
version's, in turns.

    python -m mrcaudiocodec_tpu_torch.analyze_turns BASE_DIR

BASE_DIR holds another version of this package, importable under
BASE_DIR's own name (for example a parent commit's, unpacked with `git
archive <commit> mrcaudiocodec_tpu_torch` and renamed); its kernels build
from its own csrc/ into its own build/. Both versions must give the same
outputs: `encoder._analyze_chunk` on the 30 s stereo 44.1 kHz 128 kbps
int16 clip's chunk (2586 frame rows) and on the first chunk of the 64 x
10 s corpus batch (8192 frame rows), `decoder._synth_chunk` (int16 PCM)
on each of the two chunks of the clip's decode (2048 and 538 frame rows,
its records staged on the card, both without a previous tail; a base
whose pcm is [R, n] is compared transposed), the clip's decode
(`codec.decode`, f32 and int16 PCM [n, channels]), the clip's stream and
the batch's streams. Then, in turns (base, this, this, base, ROUNDS
times):
  * each chunk's `_analyze_chunk`: host-clock ms a call (CALLS calls
    closed by a synchronize), device ms a call (the profiler's kernel
    times), device events a call, and K5's and K8's device ms in it;
  * each decode chunk's `_synth_chunk`: best wall ms of CALLS calls, each
    closed by a synchronize, device ms and device events a call, and K9's
    and K10's device ms in it;
  * the 30 s decode (`codec.decode`, f32 and int16): wall ms of each of
    CALLS calls, each closed by a synchronize (median and quartiles over
    every call of every turn beside the best), and one profiled decode's
    device ms and device events;
  * the 30 s encode (`codec.encode`): wall ms (best of CALLS), and one
    profiled encode's device ms and device events;
  * the 64 x 10 s batch (`corpus.encode_batch`): wall ms, and one profiled
    batch's device ms, with the part outside the version's own kernels
    (K1-K4 for a base without the analysis kernels, K1-K8 here).
Busy share = device ms over the turn's best unprofiled wall. One JSON
line on stdout, logs on stderr, the card's name and power limit beside
every number. Card only; exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import time

import numpy as np

from .profiling import KERNEL_NAMES

ROUNDS = 3
CALLS = 10
TRACKED = ("transients", "psycho", "synth_pre", "synth_post")


def _sync():
    import torch
    torch.cuda.synchronize()


def profiled(fn, names):
    """One call of fn() under torch.profiler -> (device ms, device events,
    device ms of the kernels whose names hold one of `names` + _kernel,
    {name: device ms} of each of those)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    _sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # open the trace with fills, which fn() does not launch
        pad = torch.empty(1024, device="cuda")
        for _ in range(20):
            pad.fill_(1.0)
        _sync()
        fn()
        _sync()
    ms, events, kern, each = 0.0, 0, 0.0, {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) / 1e3
        if t <= 0 or "FillFunctor" in e.key:
            continue
        ms += t
        events += e.count
        for n in names:
            if f"{n}_kernel" in e.key:
                kern += t
                each[n] = each.get(n, 0.0) + t
    return ms, events, kern, each


def wall_ms(fn, calls: int, best: bool):
    """Host-clock ms of fn() -> [the mean over `calls` calls in one
    synchronized run], or (best) [each of `calls` calls, each closed by a
    synchronize]."""
    fn()
    _sync()
    if not best:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        _sync()
        return [(time.perf_counter() - t0) / calls * 1e3]
    out = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        _sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _same(a, b):
    """Bitwise equality of two tuples of tensors (f32 as int32 bits); a
    first member of another shape is compared transposed (a base whose
    pcm is [R, n])."""
    import torch

    def bits(t):
        t = t.contiguous()
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    if a[0].shape != b[0].shape:
        a = (a[0].T,) + tuple(a[1:])
    return all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))


def _same_pcm(a, b):
    """Bitwise equality of two decodes' (pcm, cfg): numpy [n, channels]."""
    a, b = a[0], b[0]
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == np.float32:
        a, b = a.view(np.int32), b.view(np.int32)
    return bool(np.array_equal(a, b))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", help="directory of the other package version")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("analyze_turns: no CUDA card available", file=sys.stderr)
        return 2
    from . import config as C
    from . import corpus
    from .bench import make_clip, to_i16
    from .config import CodecConfig
    from .profiling import card_line, log
    base_dir = os.path.abspath(a.base)
    sys.path.insert(0, os.path.dirname(base_dir))
    bname = os.path.basename(base_dir)
    pkgs = {"base": bname, "this": __package__}
    mods = {k: {m: importlib.import_module(f"{p}.{m}")
                for m in ("models.encoder", "models.decoder",
                          "models.codec", "corpus")}
            for k, p in pkgs.items()}
    own = {}
    for k, p in pkgs.items():
        build = importlib.import_module(f"{p}.ops.kernels.build")
        own[k] = tuple(n for n in KERNEL_NAMES if n in build.MAIN)
    smi = card_line()
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    xi = to_i16(make_clip(44100, 30.0, 2))
    clips = corpus._synth_corpus(64, 10.0)
    enc = mods["this"]["models.encoder"]
    nf = C.frames_for_samples(xi.shape[0])
    P = enc._padded_rows(xi, nf)
    f0, s = enc.chunk_spans(nf, 2)[0]
    chunks = {"30 s chunk (2586 rows)": (enc.upload_chunk(P, f0, s, "cuda"),
                                          cfg)}
    nfb = -(-C.frames_for_samples(clips[0].shape[0]) // corpus.FRAME_BUCKET
            ) * corpus.FRAME_BUCKET
    Pb = np.zeros((128, (nfb + 6) * C.HOP), np.float32)
    for i, c in enumerate(clips):
        Pb[2 * i:2 * i + 2, 2 * C.HOP:2 * C.HOP + c.shape[0]] = c.T
    f0, s = enc.chunk_spans(nfb, 128)[0]
    chunks["corpus chunk (8192 rows)"] = (enc.upload_chunk(Pb, f0, s,
                                                           "cuda"), cfg)
    cfgs = {k: importlib.import_module(f"{p}.config").CodecConfig(
        fs=44100, channels=2, bitrate=128000) for k, p in pkgs.items()}
    bs = mods["this"]["models.codec"].encode(xi, cfg, device="cuda")
    slabs = [tuple(torch.from_numpy(a).cuda() for a in slab)
             for slab in mods["this"]["models.decoder"].record_slabs(bs)]

    def runs(k):
        e, c, co = (mods[k][m] for m in ("models.encoder", "models.codec",
                                         "corpus"))
        out = {f"analyze {n}": (lambda e=e, a=a: e._analyze_chunk(a,
                                                                  cfgs[k]))
               for n, (a, _) in chunks.items()}
        d = mods[k]["models.decoder"]
        for sl in slabs:
            out[f"synth {sl[2].numel()} rows"] = (
                lambda d=d, sl=sl: d._synth_chunk(*sl, 44100, "sine", True))
        for dtype in ("float32", "int16"):
            out[f"decode 30 s {dtype}"] = (
                lambda c=c, dtype=dtype: c.decode(bs, device="cuda",
                                                  pcm_dtype=dtype))
        out["encode 30 s"] = lambda c=c: c.encode(xi, cfgs[k],
                                                  device="cuda")
        out["batch 64 x 10 s"] = lambda co=co: co.encode_batch(
            clips, cfgs[k], device="cuda")
        return out

    fns = {k: runs(k) for k in pkgs}
    for name in fns["this"]:
        got = {k: fns[k][name]() for k in pkgs}
        _sync()
        if name.startswith(("analyze", "synth")):
            same = _same(got["base"], got["this"])
        elif name.startswith("decode"):
            same = _same_pcm(got["base"], got["this"])
        else:
            same = got["base"] == got["this"]
        log(f"[analyze turns] {name}: base == this: {same}")
        if not same:
            return 1
    del got
    res = {"card": smi, "base": base_dir, "rounds": ROUNDS, "calls": CALLS,
           "runs": {}}
    for name in fns["this"]:
        rec = {k: {"wall_ms": [], "call_ms": [], "device_ms": [],
                   "events": [], "kernel_ms": [],
                   **{f"{n}_ms": [] for n in TRACKED}}
               for k in pkgs}
        for _ in range(ROUNDS):
            for k in ("base", "this", "this", "base"):
                fn = fns[k][name]
                calls = CALLS if not name.startswith("batch") else 3
                walls = wall_ms(fn, calls,
                                best=not name.startswith("analyze"))
                rec[k]["wall_ms"].append(min(walls))
                rec[k]["call_ms"] += walls
                ms, ev, kern, each = profiled(fn, own[k])
                rec[k]["device_ms"].append(ms)
                rec[k]["events"].append(ev)
                rec[k]["kernel_ms"].append(kern)
                for n in TRACKED:
                    rec[k][f"{n}_ms"].append(each.get(n))
        for k in pkgs:
            r = rec[k]
            r["best_wall_ms"] = min(r["wall_ms"])
            r["median_wall_ms"] = float(np.median(r["wall_ms"]))
            r["call_quartiles_ms"] = [float(v) for v in np.percentile(
                r["call_ms"], [25, 50, 75])]
            r["median_device_ms"] = float(np.median(r["device_ms"]))
            r["busy_share"] = r["median_device_ms"] / r["best_wall_ms"]
            r["outside_kernels_ms"] = float(np.median(
                [d - q for d, q in zip(r["device_ms"], r["kernel_ms"])]))
            r["kernels"] = own[k]
            for n in TRACKED:
                got = [v for v in r[f"{n}_ms"] if v is not None]
                r[f"median_{n}_ms"] = (float(np.median(got)) if got
                                       else None)
        res["runs"][name] = rec
        log(f"[analyze turns] {smi}; {name}: " + "; ".join(
            f"{k}: wall ms {[round(w, 3) for w in rec[k]['wall_ms']]} "
            f"(best {rec[k]['best_wall_ms']:.3f}; every call's quartiles "
            f"{[round(v, 3) for v in rec[k]['call_quartiles_ms']]}), "
            f"device ms median "
            f"{rec[k]['median_device_ms']:.3f}, busy "
            f"{rec[k]['busy_share']:.3f}, events {rec[k]['events']}, "
            f"outside the {len(own[k])} kernels "
            f"{rec[k]['outside_kernels_ms']:.3f} ms, K5 "
            f"{rec[k]['median_transients_ms']} ms, K8 "
            f"{rec[k]['median_psycho_ms']} ms, K9 "
            f"{rec[k]['median_synth_pre_ms']} ms, K10 "
            f"{rec[k]['median_synth_post_ms']} ms" for k in pkgs))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
