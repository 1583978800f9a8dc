"""The probe path: the port's counterparts of the repository's TPU probes.

The JAX package's `scripts/` hold four probe scripts whose Pallas kernels
asked questions of the TPU's compiler. Each becomes a module here whose
kernels are hand-written CUDA C++ (csrc/probe_*.cu), each beside a plain
PyTorch version of the same function and a launch counter:

  fma_probe        P3 (scripts/tpu_fma_probe.py): k1-k3 and the SASS audit
  quant_g32        P1, P2 (scripts/tpu_quant_g32.py): mag_probe, op_probe
  quant_bisect     P4 (scripts/tpu_quant_bisect.py): v1-v5
  primitive_probe  P5 (scripts/tpu_primitive_probe.py): p0-p4

Each runs as `python -m mrcaudiocodec_tpu_torch.probes.<name>`: on the
card by default, raising without one; `--device cpu` runs the plain
versions. Each module has `run(device)` (the probe as its script ran it),
`BODIES` ({body: (kernel wrapper, plain version)}), `body_inputs(device,
rows)` ({body: argument tuple}) and `launches` ({body: count}).

A wrapper launches its kernel for CUDA tensors, takes the plain version
for CPU tensors, and raises for anything else; no path falls back.
"""
from __future__ import annotations

import argparse
import ctypes

import torch


def cfn(lib_name: str, fn_name: str, argtypes):
    """The C entry `fn_name` of build library `lib_name` (built on first
    use), taking `argtypes` then the stream, returning a cudaError."""
    from ..ops.kernels.build import lib
    fn = getattr(lib(lib_name), fn_name)
    fn.argtypes = list(argtypes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_args(name: str, specs):
    """specs: [(tensor, dtype, shape)] (None in a shape: any size). Each
    tensor must be contiguous, of that dtype and shape, and all must lie
    on one CUDA device."""
    for t, dtype, shape in specs:
        ok_shape = t.dim() == len(shape) and all(
            s is None or s == n for s, n in zip(shape, t.shape))
        if t.dtype != dtype or not ok_shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: want contiguous {dtype} {tuple(shape)}, got "
                f"{t.dtype} {tuple(t.shape)}")
    dev = specs[0][0].device
    for t, _, _ in specs:
        if not t.is_cuda or t.device != dev:
            raise ValueError(f"{name}: needs CUDA tensors on one device, "
                             f"got {t.device}")


def launch(name: str, fn, *args, device):
    """Call a C launcher on the current stream; raise on a cudaError."""
    rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: code {rc}")


def pick(t, kernel, plain):
    """The kernel wrapper for a CUDA tensor, the plain version for a CPU
    tensor, an error for anything else."""
    if t.is_cuda:
        return kernel
    if t.device.type == "cpu":
        return plain
    raise ValueError(f"no probe kernel for device {t.device}")


def need_device(device: str) -> str:
    """`device` if it can run: 'cuda' needs a card (no CPU fallback)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the probes run on the card; pass "
                           "--device cpu to run their plain versions")
    return device


def cli(run, doc: str, argv=None):
    """`python -m ...probes.<name> [--device cpu]` for a module's run()."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default: the kernels) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    run(need_device(args.device))


def log(*a):
    print(*a, flush=True)
