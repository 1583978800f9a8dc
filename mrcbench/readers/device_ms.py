"""Device ms a request of the kernels, copies and sets launched inside the
named spans (matched to their launches by correlation id)."""


def read(metric, run):
    t = run.trace
    if not t.requests or not any(t.spans.get(n) for n in metric["spans"]):
        return None
    dev = t.device_of(metric["spans"])
    if not dev:
        return None
    return sum(e - s for _, s, e, _ in dev) / 1e6 / t.requests
