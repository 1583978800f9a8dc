"""One run of one cell: set-up, the measured window, the traced requests,
the comparison with the reference, the result line.

`run_cell` is what the command runs once it has found its cards; the
CPU tests call it with device="cpu", a cell shrunk by `overrides` and,
for the checks that must fail, a `fault` that breaks the timed path.
"""
from __future__ import annotations

import gc
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np

from . import host, readers
from .catalog import Catalog
from .entries import Load
from .trace import Trace, Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "mrcaudiocodec_tpu")
TOP = 10                        # entries of each breakdown list


@dataclass
class RunData:
    """What the readers read."""
    setup_s: float = 0.0
    window_s: float = 0.0
    completed: int = 0
    audio_s_per_request: float = 0.0
    latencies_s: list = field(default_factory=list)
    trace: Trace | None = None


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device):
    if str(device).startswith("cuda"):
        import torch
        torch.cuda.synchronize(device)


def _keep(kept, i, item, cap, rng):
    """Keep every output up to `cap`, then a uniform sample of `cap` of
    them drawn from the seed (reservoir sampling)."""
    if len(kept) < cap:
        kept.append(item)
    else:
        j = int(rng.integers(0, i + 1))
        if j < cap:
            kept[j] = item


def short_name(name: str) -> str:
    """A kernel's name without its argument list and long template
    arguments; copies and sets as the profiler names them."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = name.find("(", 1)
    name = name[:cut] if cut > 0 else name
    lt = name.find("<")
    return name[:lt] + "<...>" if len(name) > 60 and lt > 0 else name


def breakdown(trace: Trace) -> dict:
    """The device operations that took most time, by name, and the
    longest idle gaps of the card, each labelled by the innermost span the
    host was in when it began; seconds."""
    w = readers.window(trace)
    if w is None or not trace.device:
        return {"device_ops": [], "idle_gaps": []}
    by = {}
    for name, s, e, _ in trace.device:
        if w[0] <= s <= w[1]:
            by[name] = by.get(name, 0) + (e - s)
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
    ops = [(short_name(n), v) for n, v in ops]
    busy = readers.union([(s, e) for _, s, e, _ in trace.device], *w)
    edges = [w[0]] + [x for a, b in busy for x in (a, b)] + [w[1]]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans = [(b - a, a, b, n) for n, rs in trace.spans.items()
             for a, b in rs]

    def label(t):
        inside = [x for x in spans if x[1] <= t < x[2]]
        return min(inside)[3] if inside else "between requests"
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {"device_ops": [[n, v / 1e9] for n, v in ops],
            "idle_gaps": [[label(a), (b - a) / 1e9] for a, b in longest]}


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str, t0: float, catalog: Catalog | None = None,
             overrides: dict | None = None, fault=None, workers=None,
             log=None):
    """-> (result dict, checks {name: (number, limit)}). t0: the process's
    start on time.perf_counter's clock."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cat = catalog or Catalog()
    cell = cat.cell(name)
    kind = "per_layer" if trace else "end_to_end"
    metrics = cat.metrics(name, kind)
    load = Load(cell, seed, overrides)
    cuda = str(device).startswith("cuda")
    load.setup(device)
    call = fault(load.call) if fault else load.call
    tracer = (Tracer(metrics, load.mix["traced_requests"], cuda)
              if trace else None)
    warm = load.mix["warmup_calls"]
    for c in range(warm):
        call(load.next_input(c))
    _sync(device)
    if tracer:
        tracer.warm()
    run = RunData(audio_s_per_request=load.audio_s)
    rng = np.random.default_rng([seed & (2**64 - 1), 1])
    kept, failed, attempted = [], 0, 0
    gc.collect()
    run.setup_s = time.perf_counter() - t0
    before = host.snapshot()
    start = time.perf_counter()
    end = start
    while end - start < seconds:
        c = warm + attempted
        inp = load.next_input(c)
        t = time.perf_counter()
        try:
            if tracer:
                with tracer.request(attempted):
                    outs = call(inp)
            else:
                outs = call(inp)
        except Exception:               # a failed request: counted, and shown
            failed += 1
            if failed == 1:
                log(traceback.format_exc())
            outs = None
        end = time.perf_counter()
        if outs is not None:
            run.latencies_s.append(end - t)
            _keep(kept, attempted, (c, outs), load.mix["keep"], rng)
        attempted += 1
    after = host.snapshot(probe=False)
    run.window_s = end - start
    run.completed = attempted - failed
    if run.latencies_s:
        q = np.percentile(np.asarray(run.latencies_s) * 1e3,
                          [0, 25, 50, 75, 95, 100])
        log("latency ms (min, p25, p50, p75, p95, max): "
            + ", ".join(f"{v:.3f}" for v in q))
        quarters = np.array_split(np.asarray(run.latencies_s) * 1e3, 4)
        log("median latency ms by quarter of the window: " + ", ".join(
            f"{np.median(x):.3f}" for x in quarters if len(x)))
    _sync(device)
    after.update(host.probes())
    log(host.describe(before, after))
    dev = {"platform": "gpu" if cuda else "cpu", "count": 1}
    if cuda:
        import torch
        dev["kind"] = torch.cuda.get_device_name(torch.device(device))
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": {}, "device": dev}
    if tracer:
        run.trace = tracer.finish()
        t = run.trace
        launched = {c for *_, c in t.runtime}
        log(f"trace: {t.requests} requests, {len(t.device)} device events "
            f"({sum(d[3] in launched for d in t.device)} matched to a "
            f"launch), {len(t.runtime)} runtime calls")
        w = readers.window(run.trace)
        if w is not None:
            spans = [(s, e) for _, s, e, _ in run.trace.device]
            dev["busy_s"] = sum(b - a for a, b in readers.union(spans, *w)) / 1e9
            dev["window_s"] = (w[1] - w[0]) / 1e9
        result["breakdown"] = breakdown(run.trace)
    for m in metrics:
        if tracer and not tracer.usable(m):
            log(f"metric {m['name']}: a function it spans is missing; "
                "left out")
            continue
        v = readers.get(m["reader"])(m, run)
        if v is not None:
            result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
    # the codec's state goes before the reference runs
    streams = load.streams
    del call
    load.codec = load.corpus = load.ring = None
    if tracer:
        run.trace.work.clear()
    gc.collect()
    if cuda:
        import torch
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    want = load.expected([c for c, _ in kept], workers)
    log(f"reference: {time.perf_counter() - t_ref:.2f} s "
        f"({os.cpu_count()} cores)")
    checks = load.compare(kept, want, failed, streams)
    checked = len(kept) * len(load.checked)
    log(f"outputs checked: {checked} clips of {len(kept)} of {attempted} "
        f"requests (calls {sorted(c for c, _ in kept)})")
    result["correct"] = bool(checked > 0 and all(
        v <= lim for v, lim in checks.values()))
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks
