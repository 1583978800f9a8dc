"""Host ms a request in the named spans: each call's wall minus the time
inside it spent in CUDA runtime calls that wait on the card."""
from . import union, waits


def read(metric, run):
    t = run.trace
    calls = [r for n in metric["spans"] for r in t.spans.get(n, [])]
    if not t.requests or not calls:
        return None
    w = union(waits(t), min(a for a, _ in calls), max(b for _, b in calls))
    total = 0
    for a, b in calls:
        total += (b - a) - sum(max(0, min(b, e) - max(a, s)) for s, e in w)
    return total / 1e6 / t.requests
