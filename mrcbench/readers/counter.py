"""A count of the codec's a request, from its own counters
(`mrcaudiocodec_tpu_torch.trace.counters()`, kept over the process's
whole run): the counters whose names start with `counter`, summed, over
the counter `per` (the requests of the cell's entry point,
`requests.encode` or `requests.encode_batch`), times `scale` (1 where
absent).

That is the mean over every request of the process, the warm-up's
among them; a cell's requests all have one shape, so it is each
request's count. Nothing is read where the codec keeps no such
counters, or where it counted the requests of another entry point too,
whose counts would be mixed in."""
import importlib


def read(metric, run):
    try:
        got = importlib.import_module(
            "mrcaudiocodec_tpu_torch.trace").counters()
    except ImportError:
        return None
    per = got.get(metric["per"], 0)
    mixed = any(v for k, v in got.items()
                if k.startswith("requests.") and k != metric["per"])
    keys = [k for k in got if k.startswith(metric["counter"])]
    if not per or mixed or not keys:
        return None
    return sum(got[k] for k in keys) * metric.get("scale", 1) / per
