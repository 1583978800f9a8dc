"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` into its own shared library with a plain
C interface, loaded with ctypes; no PyTorch header is included, so a build
takes seconds. Flags: `-gencode arch=compute_90a,code=sm_90a -O3
--fmad=false`. `--fmad=false` is load-bearing — the kernels' arithmetic is
a pinned sequence of single-rounded f32 ops, and nvcc would otherwise
contract a multiply and an add into an FMA — and `--use_fast_math` is
never set (it flushes subnormals to zero).

The probe path (`probes/`) adds one library per probe source, and
`probe_fma_contract`: csrc/probe_fma.cu built with `--fmad=true` in place
of `--fmad=false`, the FMA probe's positive control. Only the FMA probe
loads it; no normative path names it.

Libraries go into the package's git-ignored `build/` directory at first
use. A library is stale when its source or a csrc/*.cuh header the source
includes (`#include "name.cuh"`: K2's warp routine in quant_cost_warp.cuh,
which K2 and K4 share and whose tuple lookup and band walk K13 shares;
the device xlog2 / xexp2 in xpsy_dev.cuh, which K5, K8 and K9 share) is
newer than it. `build()` starts one nvcc per stale source, all at once,
and returns each compiler log (`-Xptxas -v`: registers, shared memory,
spills). A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
MAIN = ("fft_stages", "quant_cost", "record_pack", "rd_loop", "transients",
        "analysis_pre", "mdct_post", "psycho", "synth_pre", "synth_post",
        "pad_rows", "budget_scan", "codebook_choice")
PROBES = ("probe_fma", "probe_quant_g32", "probe_quant_bisect",
          "probe_primitives", "probe_fma_contract")
SOURCES = MAIN + PROBES
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
# library -> (source, flags) where they differ from (library, NVCC_FLAGS)
_VARIANTS = {
    "probe_fma_contract": ("probe_fma", tuple(
        "--fmad=true" if f == "--fmad=false" else f for f in NVCC_FLAGS)),
}

_libs: dict[str, ctypes.CDLL] = {}
logs: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _so(name: str) -> str:
    return os.path.join(BUILD, f"lib{name}.so")


def inputs(name: str) -> list[str]:
    """The files library `name` is built from: its source and the csrc
    headers that source includes."""
    src = os.path.join(CSRC, f"{_VARIANTS.get(name, (name,))[0]}.cu")
    with open(src) as f:
        heads = re.findall(r'^\s*#\s*include\s+"([^"/]+\.cuh)"', f.read(),
                           re.M)
    return [src] + [os.path.join(CSRC, h) for h in heads]


def stale(name: str) -> bool:
    """True when library `name` is missing or older than a file it is
    built from."""
    so = _so(name)
    return not os.path.exists(so) or any(
        os.path.getmtime(p) > os.path.getmtime(so) for p in inputs(name))


def build(names=SOURCES, force: bool = False) -> dict[str, str]:
    """Compile every named source that has no up-to-date library (every
    one if `force`), one nvcc process per source started together.
    Returns {name: compiler log} for the sources compiled now."""
    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        source, flags = _VARIANTS.get(name, (name, NVCC_FLAGS))
        src = os.path.join(CSRC, f"{source}.cu")
        so = _so(name)
        if not force and not stale(name):
            continue
        tmp = f"{so}.tmp.{os.getpid()}.{threading.get_ident()}"
        procs[name] = (subprocess.Popen(
            [nvcc(), *flags, src, "-o", tmp],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate(timeout=600)
        logs[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, so)
    return {n: logs[n] for n in procs}


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    if name not in _libs:
        build((name,))
        _libs[name] = ctypes.CDLL(_so(name))
    return _libs[name]
