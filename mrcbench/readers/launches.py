"""Kernel launches a request: the CUDA runtime calls whose name holds
"LaunchKernel" and that start inside a call of the named spans. Every
launch counts, PyTorch's own among them, where the kernels' wrappers
count only their own."""
from . import union, window


def read(metric, run):
    t = run.trace
    w = window(t)
    calls = [r for n in metric["spans"] for r in t.spans.get(n, [])]
    if w is None or not t.requests or not calls or not t.runtime:
        return None
    calls = union(calls, *w)
    n = sum("LaunchKernel" in name and any(a <= s < b for a, b in calls)
            for name, s, _, _ in t.runtime)
    return n / t.requests
