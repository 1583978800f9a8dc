"""A percentile (`q`) of every window request's latency, ms: from the call
to its result in host memory."""
import numpy as np


def read(metric, run):
    if not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3,
                               metric["q"]))
