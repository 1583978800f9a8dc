"""A stage's share of its roofline, %: the least time its work needs
(`work`, counted from the stage's own inputs and outputs) over the device
time of what its calls launched, times 100."""
from .. import work


def read(metric, run):
    t = run.trace
    recs = [r for n in metric["spans"] for r in t.work.get(n, [])]
    dev = t.device_of(metric["spans"])
    busy = sum(e - s for _, s, e, _ in dev) / 1e9
    if not recs or busy <= 0:
        return None
    stage = work.STAGES[metric["work"]]
    least = sum(work.least_seconds(*stage.count(r)) for r in recs)
    return 100.0 * least / busy
