"""Spans around the codec's functions and the profiler over a few
requests of the window, kept in memory.

The benchmark wraps the module-level functions that its metric files name
(`spans`, `minus`) in `record_function` spans, from its own files: the
program is unchanged, and a name that is missing leaves its metrics out.
The wrappers pass straight through except while a traced request runs;
`torch.profiler` (CPU and, on a card, CUDA activity) covers the first
`traced_requests` requests of the window, each inside a "request" span.

`Trace` holds what the readers read, times in ns on the profiler's clock:
    spans[name]  [(start, end)] of each call of a wrapped function, and of
                 each traced request under "request"
    runtime      [(name, start, end, correlation)] CUDA API calls (cuda*,
                 cu*) on the host
    device       [(name, start, end, correlation)] kernels, copies and
                 sets on the card
    work[name]   the stage's work records (`work.STAGES`) of each call
    requests     the number of traced requests
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field

from torch.autograd import DeviceType

from . import work as work_mod

PREFIX = "mrcbench:"
REQUEST = "request"


@dataclass
class Trace:
    spans: dict = field(default_factory=dict)
    runtime: list = field(default_factory=list)
    device: list = field(default_factory=list)
    work: dict = field(default_factory=dict)
    requests: int = 0

    def device_of(self, names) -> list:
        """Device events launched by a runtime call that started inside a
        call of one of these spans."""
        ranges = sorted(r for n in names for r in self.spans.get(n, []))
        corr = {c for _, s, _, c in self.runtime if _inside(s, ranges)}
        return [d for d in self.device if d[3] in corr]


def _inside(t, ranges) -> bool:
    return any(a <= t <= b for a, b in ranges)


def _resolve(path: str):
    """'pkg.mod.attr' -> (module, attr), or None if either is missing."""
    mod_name, _, attr = path.rpartition(".")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        return None
    return (mod, attr) if callable(getattr(mod, attr, None)) else None


def span_paths(metric: dict) -> list[str]:
    return [p for p in metric.get("spans", []) + metric.get("minus", [])
            if p != REQUEST]


class Tracer:
    """Wraps the functions `metrics` name; `request(i)` opens the profiler
    before request 0 and closes it after request `count` - 1."""

    def __init__(self, metrics: list[dict], count: int, cuda: bool):
        self.count = count
        self.cuda = cuda
        self.active = False
        self.prof = None
        self.running = False
        self.trace = Trace()
        self.missing: set[str] = set()
        self._saved = []
        works = {}
        for m in metrics:
            if m.get("work"):
                for p in m["spans"]:
                    works[p] = work_mod.STAGES[m["work"]]
        paths = sorted({p for m in metrics for p in span_paths(m)})
        for path in paths:
            got = _resolve(path)
            if got is None:
                self.missing.add(path)
                continue
            mod, attr = got
            orig = getattr(mod, attr)
            self._saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(path, orig, works.get(path)))

    def usable(self, metric: dict) -> bool:
        return not (set(span_paths(metric)) & self.missing)

    def _wrap(self, path, fn, stage):
        from torch.profiler import record_function
        label = PREFIX + path
        tracer = self

        def wrapper(*args, **kwargs):
            if not tracer.active:
                return fn(*args, **kwargs)
            with record_function(label):
                out = fn(*args, **kwargs)
            if stage is not None:
                tracer.trace.work.setdefault(path, []).append(
                    stage.capture(args, kwargs, out))
            return out
        return wrapper

    def remove(self):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved = []

    def warm(self):
        """One short profiler run before the window: the first profiler run
        of a process starts the device tracer and can miss launches."""
        import torch
        with self._profile():
            if self.cuda:
                pad = torch.empty(1024, device="cuda")
                for _ in range(50):
                    pad.fill_(1.0)
                torch.cuda.synchronize()

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        return profile(activities=acts)

    def request(self, i: int):
        return _Request(self, i)

    def finish(self) -> Trace:
        """Close the profiler if a short window left it open; read it."""
        if self.prof is not None and self.running:
            self._stop()
        self.remove()
        if self.prof is not None:
            _read(self.prof, self.trace)
            self.prof = None
        return self.trace

    def _start(self):
        self.prof = self._profile()
        self.prof.__enter__()
        self.running = True

    def _stop(self):
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.running = False
        self.prof.__exit__(None, None, None)


class _Request:
    def __init__(self, tracer: Tracer, i: int):
        self.tracer, self.i = tracer, i
        self.rf = None

    def __enter__(self):
        t = self.tracer
        if self.i >= t.count:
            return self
        if self.i == 0:
            t._start()
        from torch.profiler import record_function
        self.rf = record_function(PREFIX + REQUEST)
        self.rf.__enter__()
        t.active = True
        t.trace.requests += 1
        return self

    def __exit__(self, *exc):
        t = self.tracer
        if self.rf is None:
            return False
        t.active = False
        self.rf.__exit__(*exc)
        if self.i == t.count - 1:
            t._stop()
        return False


def _kind(e) -> str:
    """"span", "runtime", "device" or "" for one profiler event, from its
    device and name (CUDA API calls are named cuda* and cu*; a span is a
    user annotation with the benchmark's prefix)."""
    name = e.name()
    if name.startswith(PREFIX):
        return "span" if e.device_type() == DeviceType.CPU else ""
    if e.device_type() == DeviceType.CUDA:
        return "" if e.is_user_annotation() else "device"
    if e.device_type() == DeviceType.CPU and (
            name.startswith("cuda") or (name.startswith("cu")
                                        and name[2:3].isupper())):
        return "runtime"
    return ""


def _read(prof, trace: Trace):
    """The profiler's events -> `trace`."""
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        if not kind:
            continue
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if kind == "span":
            trace.spans.setdefault(name[len(PREFIX):], []).append(
                (start, end))
        elif kind == "runtime":
            trace.runtime.append((name, start, end, e.correlation_id()))
        else:
            trace.device.append((name, start, end, e.correlation_id()))
