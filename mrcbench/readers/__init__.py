"""One small reader a statistic: `read(metric, run) -> float | None`.

A metric file names its reader (`"reader"`); `run` is the harness's
`RunData`: the window's counts and times, and for a traced run its
`Trace`. A reader that finds nothing to read returns None, and the
harness leaves the metric out of the line.
"""
from __future__ import annotations

import importlib

WAITS = ("Synchronize",)            # runtime calls that wait on the card


def get(name: str):
    return importlib.import_module(f"{__name__}.{name}").read


def union(intervals, lo, hi) -> list:
    """The union of [start, end) intervals clipped to [lo, hi), merged and
    sorted."""
    out = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def window(trace):
    """(start, end) ns of the traced requests, or None."""
    req = trace.spans.get("request") if trace else None
    if not req:
        return None
    return min(a for a, _ in req), max(b for _, b in req)


def waits(trace) -> list:
    """Runtime calls in which the host waits on the card: synchronizes,
    and the copies to the host (which block until the copy is done)."""
    dtoh = {c for name, _, _, c in trace.device if "DtoH" in name}
    return [(s, e) for name, s, e, c in trace.runtime
            if any(w in name for w in WAITS)
            or ("emcpy" in name and c in dtoh)]


def overlap(a, b, intervals) -> int:
    """ns of [a, b) that the (merged) intervals cover."""
    return sum(max(0, min(b, e) - max(a, s)) for s, e in intervals)
