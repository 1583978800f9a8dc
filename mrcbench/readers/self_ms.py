"""Host self ms a request: the named span (the request) minus the parts
of it that the `minus` spans cover."""
from . import overlap, union


def read(metric, run):
    t = run.trace
    outer = [r for n in metric["spans"] for r in t.spans.get(n, [])]
    if not t.requests or not outer:
        return None
    inner = [r for n in metric["minus"] for r in t.spans.get(n, [])]
    total = 0
    for a, b in outer:
        total += (b - a) - overlap(a, b, union(inner, a, b))
    return total / 1e6 / t.requests
