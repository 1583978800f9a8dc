"""Device-idle ms a request: the time in the traced window in which no
kernel, copy or set ran on the card, inside the union of the calls of the
metric's `spans` (the whole window where it names none), less the part
inside the union of the calls of its `minus` spans.

With the codec's top call as `spans` and its stages as `minus`, the
stages as `spans`, and the top call as `minus` over the whole window,
three metrics split the window's idle time with no overlap and nothing
left over, as long as every stage call lies inside a top call."""
from . import union, window


def _intersect(a, b) -> list:
    """The intersection of two merged, sorted interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def _calls(t, names) -> list:
    return [r for n in names for r in t.spans.get(n, [])]


def read(metric, run):
    t = run.trace
    w = window(t)
    if w is None or not t.device or not t.requests:
        return None
    busy = union([(s, e) for _, s, e, _ in t.device], *w)
    edges = [w[0]] + [x for a, b in busy for x in (a, b)] + [w[1]]
    idle = [[a, b] for a, b in zip(edges[::2], edges[1::2]) if b > a]
    if "spans" in metric:
        calls = _calls(t, metric["spans"])
        if not calls:
            return None
        inside = union(calls, *w)
    else:
        inside = [list(w)]
    got = _intersect(idle, inside)
    less = union(_calls(t, metric.get("minus", [])), *w)
    return (_length(got) - _length(_intersect(got, less))) / 1e6 / t.requests
