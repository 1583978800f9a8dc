"""The host's state around a run's window, logged on standard error so
that a rate that drifts between runs can be laid to the host, or cleared
of it.

    before = snapshot(); ...window...; after = snapshot()
    log(describe(before, after))

A snapshot holds the machine's CPU times (/proc/stat: busy, iowait,
steal), the process's resource use (CPU time, context switches, page
faults), the mean clock of the cores (/proc/cpuinfo), the load average,
and two probes of the host's speed: a fixed pure-Python loop (one core's
speed, as the codec's Python glue sees it) and a 64 MiB copy (the memory
bandwidth that pageable uploads and padding use). Readings a machine
lacks are left out.
"""
from __future__ import annotations

import os
import resource
import time

import numpy as np

PROBE_REPS = 5
COPY_BYTES = 64 << 20


def _cpu_times():
    """(busy, iowait, steal, total) jiffies of all cores, or None."""
    try:
        with open("/proc/stat") as f:
            v = [int(x) for x in f.readline().split()[1:]]
    except (OSError, ValueError):
        return None
    v += [0] * (8 - len(v))
    user, nice, system, idle, iowait, irq, softirq, steal = v[:8]
    busy = user + nice + system + irq + softirq
    return busy, iowait, steal, busy + idle + iowait + steal


def _mhz():
    """The cores' mean clock in MHz, or None."""
    try:
        with open("/proc/cpuinfo") as f:
            v = [float(ln.split(":")[1]) for ln in f
                 if ln.startswith("cpu MHz")]
    except (OSError, ValueError, IndexError):
        return None
    return sum(v) / len(v) if v else None


def _py_loop_ms() -> float:
    """The best of a few runs of a fixed pure-Python loop, in ms."""
    best = float("inf")
    for _ in range(PROBE_REPS):
        t = time.perf_counter()
        s = 0
        for i in range(100_000):
            s += i & 7
        best = min(best, time.perf_counter() - t)
    return best * 1e3


def _copy_gbs() -> float:
    """The best of a few copies of 64 MiB between two host buffers, GB/s."""
    a = np.ones(COPY_BYTES // 8)
    b = np.empty_like(a)
    best = float("inf")
    for _ in range(PROBE_REPS):
        t = time.perf_counter()
        np.copyto(b, a)
        best = min(best, time.perf_counter() - t)
    return COPY_BYTES / best / 1e9


def snapshot(probe: bool = True) -> dict:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    snap = {"t": time.perf_counter(), "cpu": _cpu_times(), "mhz": _mhz(),
            "load": os.getloadavg()[0],
            "proc_s": ru.ru_utime + ru.ru_stime, "nvcsw": ru.ru_nvcsw,
            "nivcsw": ru.ru_nivcsw, "minflt": ru.ru_minflt,
            "threads": len(os.listdir("/proc/self/task"))
            if os.path.isdir("/proc/self/task") else None}
    if probe:
        snap.update(probes())
    return snap


def probes() -> dict:
    """The two probes of the host's speed."""
    return {"py_ms": _py_loop_ms(), "copy_gbs": _copy_gbs()}


def describe(a: dict, b: dict) -> str:
    """One line: the host between snapshots a and b (the window)."""
    wall = b["t"] - a["t"]
    parts = [f"cores {os.cpu_count()}",
             f"affinity {len(os.sched_getaffinity(0))}",
             f"threads {b['threads']}", f"load {a['load']:.2f}"]
    if a["mhz"] and b["mhz"]:
        parts.append(f"MHz {a['mhz']:.0f}/{b['mhz']:.0f}")
    if a["cpu"] and b["cpu"]:
        d = [y - x for x, y in zip(a["cpu"], b["cpu"])]
        if d[3] > 0:
            parts.append(f"machine busy {100 * d[0] / d[3]:.1f}% iowait "
                         f"{100 * d[1] / d[3]:.1f}% steal "
                         f"{100 * d[2] / d[3]:.1f}%")
    if wall > 0:
        parts.append(f"process {(b['proc_s'] - a['proc_s']) / wall:.2f} "
                     "cores")
    if b["nvcsw"]:              # a kernel that counts them
        parts.append(f"ctx switches {b['nvcsw'] - a['nvcsw']} voluntary "
                     f"{b['nivcsw'] - a['nivcsw']} involuntary")
        parts.append(f"minor faults {b['minflt'] - a['minflt']}")
    if "py_ms" in a and "py_ms" in b:
        parts.append(f"python loop {a['py_ms']:.3f}/{b['py_ms']:.3f} ms "
                     f"copy {a['copy_gbs']:.2f}/{b['copy_gbs']:.2f} GB/s "
                     "(before/after)")
    return "host: " + ", ".join(parts)
