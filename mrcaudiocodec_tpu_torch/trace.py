"""Spans and counters of the encode path.

`span(name)` marks one stage of a request. With tracing off (the default)
it returns one shared no-op context: no allocation, no torch call. With
tracing on (`enable(True)`) it returns `torch.profiler.record_function`,
so every span is an event of any `torch.profiler` trace, on the clock of
that trace's CUDA runtime calls and kernels; the program keeps no
timestamps of its own.

Spans, each a stage at one layer boundary (no span inside a per-frame or
per-band loop):

    mrc.encode        a clip request (`models.encoder.encode`)
    mrc.encode_batch  a batch request (`corpus.encode_batch`)
    mrc.pad           the PCM padded into rows
    mrc.order         the chunks' stream orders
    mrc.upload        a host array handed to the device (`upload`): an
                      audio chunk, a stream order, the rows' frame counts
    mrc.analyze       a chunk's analysis (`_analyze_chunk`)
    mrc.budget        the PE join and the bit-reservoir scan
    mrc.decide        a chunk's RD loop and codebooks (`decide_chunk`)
    mrc.pack          a chunk's record pack (`pack_chunk`)
    mrc.download      a packed chunk read back (`download_body`)
    mrc.assemble      the clips' slices, joins and headers

The stage spans (analyze, budget, decide, pack, download) of one request
are siblings under its top span; the entry's spans (pad, order, upload,
assemble) lie between them.

Counters are plain integers, always on, read by `counters()`:

    requests.encode         clip requests (`models.encoder.encode`)
    requests.encode_batch   batch requests (`corpus.encode_batch`)
    host_syncs.rd_exit      the RD loop's exit tests that read the device
    host_syncs.pack_status  K3's read of its status
    host_syncs.download     each read of a packed chunk in `download_body`
    bytes_up                bytes handed to the device by `upload`, whatever
                            the device: every host-to-device copy of the
                            encode path goes through it
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

_on = False
_OFF = contextlib.nullcontext()
_counts: dict[str, int] = {}
_lock = threading.Lock()


def enable(on: bool) -> None:
    """Switch the spans on or off (the counters are always on)."""
    global _on
    _on = bool(on)


def span(name: str):
    """A context that marks one stage: a `record_function` while tracing is
    on, the shared no-op context otherwise."""
    if not _on:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """A copy of every counter, by name."""
    with _lock:
        return dict(_counts)


def upload(a: np.ndarray, dev):
    """A host array -> a tensor on `dev`, as the span `mrc.upload`, its
    bytes counted in `bytes_up`."""
    with span("mrc.upload"):
        a = np.ascontiguousarray(a)
        count("bytes_up", a.nbytes)
        return torch.from_numpy(a).to(dev)
