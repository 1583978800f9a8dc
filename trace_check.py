"""The encode path's own spans on a CUDA card: where its launches, copies
and syncs start, and what the spans cost.

    python3 trace_check.py spans --workload <cell> --seed <n> [--requests 3]
    python3 trace_check.py cost --workload <cell> --seed <n> [--sets 10]
                           [--calls 20]

Both run a benchmark cell's entry point on the inputs the benchmark makes
for it (`mrcbench.entries.Load`), after its warm-up calls.

`spans` runs `--requests` requests under `torch.profiler` with the codec's
tracing on (`mrcaudiocodec_tpu_torch.trace.enable(True)`) and prints, a
request: the runtime calls that launched K2 and K4, every kernel launch,
every host-to-device copy and every synchronize, by the innermost `mrc.*`
span each starts in; whether every stage span lies inside its top span
with no two stages overlapping; the host ms of the entry's spans (pad,
order, upload, assemble; waits on the card left out) and of the top
span outside all of them and of the request outside the top span, beside
the request's wall less the stages' (as `entry_self_ms` reads it); the
runtime calls that put work on the card inside each `mrc.budget` span,
which must be two (the PE join, a kernel or for one chunk a copy on the
card, and K12), and `budget.kernel` counted once a request; the kernels
on the card behind each `mrc.decide` span, which must be K2 twice, K4 and
K13, and `choice.kernel` counted once a chunk (a `mrc.decide` span); and
the change of the codec's counters. It exits 1 when a budget or decide
check fails.

`cost` times calls with the codec's tracing on and off, no profiler
running: `--sets` sets of `--calls` calls a side, the sides in turns, the
first side alternating.

Each prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

TOP = ("mrc.encode", "mrc.encode_batch")
STAGES = ("mrc.analyze", "mrc.budget", "mrc.decide", "mrc.pack",
          "mrc.download")
ENTRY = ("mrc.pad", "mrc.order", "mrc.upload", "mrc.assemble")
# the kernels a mrc.decide span puts on the card, by name, and how many
DECIDE = {"quant_cost_kernel": 2, "rd_loop_kernel": 1,
          "codebook_choice_kernel": 1}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def warmed(cell: str, seed: int, device: str, overrides=None):
    """The cell's Load (shrunk by `overrides`, as the benchmark's tests
    shrink it), set up and past its warm-up calls -> (load, the next
    call's index)."""
    from mrcbench.catalog import Catalog
    from mrcbench.entries import Load
    load = Load(Catalog().cell(cell), seed, overrides)
    load.setup(device)
    c = load.mix["warmup_calls"]
    for i in range(c):
        load.call(load.next_input(i))
    sync(device)
    return load, c


def sync(device):
    import torch
    if str(device).startswith("cuda"):
        torch.cuda.synchronize(device)


def mrc_spans(prof) -> dict:
    """{name: [(start, end)]} ns of the codec's spans in a profiler run,
    and of this script's "request" around each call."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.profiler.kineto_results.events():
        if ((e.name().startswith("mrc.") or e.name() == "request")
                and e.device_type() == DeviceType.CPU):
            s = e.start_ns()
            out.setdefault(e.name(), []).append((s, s + e.duration_ns()))
    return out


def innermost(spans: dict, t) -> str:
    """The shortest codec span that holds time t ("" if none)."""
    best = (1 << 62, "")
    for name, rs in spans.items():
        for a, b in rs:
            if a <= t <= b and b - a < best[0]:
                best = (b - a, name)
    return best[1]


def by_span(spans, starts, n) -> dict:
    out = {}
    for t in starts:
        k = innermost(spans, t)
        out[k] = out.get(k, 0) + 1
    return {k: v / n for k, v in sorted(out.items())}


def nested(spans) -> bool:
    """Every stage span inside a top span, no two stages overlapping."""
    tops = [r for n in TOP for r in spans.get(n, [])]
    stages = sorted(r for n in STAGES for r in spans.get(n, []))
    inside = all(any(a <= s and e <= b for a, b in tops) for s, e in stages)
    return inside and all(e <= s for (_, e), (s, _) in zip(stages,
                                                           stages[1:]))


def host_ms(intervals, waits, n) -> float:
    """ms a request of the merged intervals, less the waits inside them."""
    from mrcbench import readers
    if not intervals:
        return 0.0
    merged = readers.union(intervals, -1, 1 << 62)
    w = readers.union(waits, -1, 1 << 62)
    ns = sum(b - a - readers.overlap(a, b, w) for a, b in merged)
    return ns / 1e6 / n


def check_spans(cell: str, seed: int, requests: int, device: str,
                overrides=None) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from mrcaudiocodec_tpu_torch import trace
    from mrcbench import readers
    from mrcbench.trace import Trace, _read
    load, c = warmed(cell, seed, device, overrides)
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if str(device).startswith("cuda") else [])
    inputs = [load.next_input(c + i) for i in range(requests)]
    before = trace.counters()
    trace.enable(True)
    try:
        with profile(activities=acts) as prof:
            for inp in inputs:
                with record_function("request"):
                    load.call(inp)
            sync(device)
    finally:
        trace.enable(False)
    after = trace.counters()
    t = Trace()
    _read(prof, t)
    spans = mrc_spans(prof)
    start = {corr: s for _, s, _, corr in t.runtime}

    def dev(key):
        """Start times of the runtime calls behind the device events whose
        name passes key."""
        return [start[corr] for name, _, _, corr in t.device
                if corr in start and key(name)]
    n = requests
    waits = readers.waits(t)
    inner = [r for k in STAGES + ENTRY for r in spans.get(k, [])]
    tops = readers.union([r for k in TOP for r in spans.get(k, [])],
                         -1, 1 << 62)
    stage = readers.union([r for k in STAGES for r in spans.get(k, [])],
                          -1, 1 << 62)
    entry = {k[4:]: host_ms(spans.get(k, []), waits, n) for k in ENTRY}
    # the top span outside every stage and entry span: what no span names
    top_wall = sum(b - a for a, b in tops)
    covered = readers.union(inner, -1, 1 << 62)
    top_self = (top_wall - sum(readers.overlap(a, b, covered)
                               for a, b in tops)) / 1e6 / n
    req = readers.union(spans.get("request", []), -1, 1 << 62)
    req_wall = sum(b - a for a, b in req)
    outside_top = (req_wall - top_wall) / 1e6 / n
    # as the benchmark's entry_self_ms reads it: the request's wall less
    # the stages'
    entry_self = (req_wall - sum(readers.overlap(a, b, stage)
                                 for a, b in req)) / 1e6 / n
    # the device work inside each mrc.budget span: the PE join (a kernel
    # for several chunks, a copy on the card for one) and K12
    budget = [sorted(name for name, s, _, _ in t.runtime
                     if a <= s <= b and ("LaunchKernel" in name
                                         or "Memcpy" in name))
              for a, b in spans.get("mrc.budget", [])]
    k12 = (after.get("budget.kernel", 0) - before.get("budget.kernel", 0)) / n
    # the kernels on the card behind each mrc.decide span: K2 twice (the
    # inner sweep), K4 and K13
    named = [(name, start[corr]) for name, _, _, corr in t.device
             if corr in start]
    decide = [{k: sum(a <= s <= b and k in name for name, s in named)
               for k in DECIDE} for a, b in spans.get("mrc.decide", [])]
    k13 = after.get("choice.kernel", 0) - before.get("choice.kernel", 0)
    return {
        "budget_device_calls": budget, "budget_kernel_a_request": k12,
        "budget_ok": len(budget) == n and all(len(b) == 2 for b in budget)
        and k12 == 1,
        "decide_kernels": decide, "choice_kernel_a_request": k13 / n,
        "decide_ok": len(decide) > 0 and k13 == len(decide)
        and all(d == DECIDE for d in decide),
        "requests": n, "nested": nested(spans),
        "k2_k4_by_span": by_span(spans, dev(
            lambda s: "quant_cost" in s or "rd_loop" in s), n),
        "launches_by_span": by_span(spans, [
            s for name, s, _, _ in t.runtime if "LaunchKernel" in name], n),
        "htod_by_span": by_span(spans, dev(lambda s: "HtoD" in s), n),
        "syncs_by_span": by_span(spans, [
            s for name, s, _, _ in t.runtime if "Synchronize" in name], n),
        "entry_host_ms": dict(entry, top_self=top_self,
                              outside_top=outside_top),
        "entry_parts_over_entry_self": (sum(entry.values()) + top_self
                                        + outside_top) / entry_self,
        "entry_self_ms": entry_self,
        "counters": {k: (v - before.get(k, 0)) / n
                     for k, v in sorted(after.items())
                     if v != before.get(k, 0)},
    }


def cost(cell: str, seed: int, sets: int, calls: int, device: str) -> dict:
    from mrcaudiocodec_tpu_torch import trace
    load, c = warmed(cell, seed, device)
    times = {"off": [], "on": []}
    set_ms = {"off": [], "on": []}
    for r in range(sets):
        for side in (("off", "on") if r % 2 == 0 else ("on", "off")):
            trace.enable(side == "on")
            got = []
            for _ in range(calls):
                inp = load.next_input(c)
                c += 1
                t = time.perf_counter()
                load.call(inp)
                got.append((time.perf_counter() - t) * 1e3)
            trace.enable(False)
            times[side] += got
            set_ms[side].append(float(np.median(got)))
    out = {}
    for side, v in times.items():
        q1, q2, q3 = np.percentile(v, [25, 50, 75])
        out[side] = {"median_ms": float(q2), "q1_ms": float(q1),
                     "q3_ms": float(q3), "set_medians_ms": set_ms[side],
                     "calls": len(v)}
    out["on_less_off_ms"] = out["on"]["median_ms"] - out["off"]["median_ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trace_check.py")
    ap.add_argument("mode", choices=("spans", "cost"))
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--sets", type=int, default=10)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA card is available", file=sys.stderr)
        return 2
    if args.mode == "spans":
        out = check_spans(args.workload, args.seed, args.requests, "cuda:0")
    else:
        out = cost(args.workload, args.seed, args.sets, args.calls, "cuda:0")
    out.update(mode=args.mode, workload=args.workload, seed=args.seed,
               card=card())
    print(json.dumps(out), flush=True)
    return 0 if out.get("budget_ok", True) and out.get("decide_ok",
                                                        True) else 1


if __name__ == "__main__":
    sys.exit(main())
