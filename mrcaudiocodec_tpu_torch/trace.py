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
    mrc.pad           the PCM staged for the device (`encoder.stage_pcm`:
                      the clips copied into the staging buffer), or, on
                      the oracle's path, padded into rows
    mrc.order         the chunks' stream orders
    mrc.upload        a host array handed to the device (`upload`): the
                      staged PCM, the clips' offsets and lengths, a
                      stream order, the rows' frame counts
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
    staging.bytes_up        of those, the bytes copied up from the staging
                            buffer (`encoder.upload_pcm`: page-locked for a
                            card, plain host memory for the CPU); not named
                            bytes_up_*, which a reader of `bytes_up` by
                            prefix would add in
    staging.grow            allocations of a device's staging buffer: one
                            a device, and another only when a request is
                            larger than any before it
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


def upload(a, dev):
    """A host array -> a tensor on `dev`, as the span `mrc.upload`, its
    bytes counted in `bytes_up`.

    A numpy array is copied into page-locked memory first when `dev` is a
    card, so the copy up neither waits for the card's queue nor holds the
    host. A tensor is a view of the staging buffer (`encoder.upload_pcm`,
    page-locked for a card): it is copied into a new tensor on `dev`
    without waiting, its bytes counted in `staging.bytes_up` too; the
    caller keeps the buffer unchanged until the copy is done."""
    with span("mrc.upload"):
        if isinstance(a, torch.Tensor):
            count("bytes_up", a.nbytes)
            count("staging.bytes_up", a.nbytes)
            out = torch.empty(a.shape, dtype=a.dtype, device=dev)
            return out.copy_(a, non_blocking=True)
        a = np.ascontiguousarray(a)
        count("bytes_up", a.nbytes)
        t = torch.from_numpy(a)
        if torch.device(dev).type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)
