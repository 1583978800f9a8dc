"""The share of the traced requests' wall, %, in which no kernel, copy or
set ran on the card."""
from . import union, window


def read(metric, run):
    w = window(run.trace)
    if w is None or not run.trace.device:
        return None
    spans = [(s, e) for _, s, e, _ in run.trace.device]
    busy = sum(b - a for a, b in union(spans, *w))
    return 100.0 * (1.0 - busy / (w[1] - w[0]))
