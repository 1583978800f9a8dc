"""P3: does the compiler contract a multiply and an add into one FMA?

Counterpart of scripts/tpu_fma_probe.py, which asked XLA:TPU and Mosaic
whether a*b - c, a*b - c*d and a*b + c*d come out twice rounded ("plain")
or with a fused, once-rounded multiply-add. Here the rows are:
  * torch eager on the given device (one op per kernel) for the three
    expressions and the butterfly (a+b)*0.7 - (c+d)*0.3;
  * the port's kernels k1-k3 (csrc/probe_fma.cu, built with --fmad=false
    like every library of the port; the plain versions on the CPU);
  * on the card, the same kernels from `probe_fma_contract`, the same
    source built with --fmad=true: the positive control, which shows the
    probe can see a contraction at all;
  * on the card, the SASS audit: `cuobjdump -sass` of every library in the
    build directory, counting FFMA instructions and .FTZ modifiers.

    python -m mrcaudiocodec_tpu_torch.probes.fma_probe [--device cpu]
"""
from __future__ import annotations

import ctypes
import functools
import glob
import os
import re
import subprocess

import numpy as np
import torch

from . import check_args, cfn, cli, launch, log, pick

SHAPE = (8, 1024)
CONTROL = "probe_fma_contract"
NORMATIVE = ("fft_stages", "quant_cost", "record_pack", "rd_loop",
             "transients", "analysis_pre", "mdct_post", "psycho",
             "synth_pre", "synth_post", "pad_rows", "budget_scan",
             "codebook_choice")
# kernels whose source calls the IEEE divide or square root or a libm
# function: ptxas and the math library build those from fused
# multiply-adds (and flushing estimates) that still give the IEEE result
IEEE_ROUTINE_KERNELS = ("mag_probe_kernel", "op_probe_kernel", "v1_kernel",
                        "v2_kernel")
W7 = float(np.float32(0.7))
W3 = float(np.float32(0.3))

launches = {"k1": 0, "k2": 0, "k3": 0}      # of libprobe_fma's kernels


def fma64(a, b, c):
    """round_f32(a*b + c) with one f64 rounding in the middle (product is
    exact in f64; good enough to classify contraction behavior)."""
    return (a.astype(np.float64) * b.astype(np.float64)
            + c.astype(np.float64)).astype(np.float32)


def classify(name, got, cands):
    """-> the names of the candidates `got` equals bit for bit."""
    matches = [k for k, v in cands.items()
               if (got.view(np.uint32) == v.view(np.uint32)).all()]
    log(f"{name}: matches {matches or 'NONE'}")
    if not matches:
        for k, v in cands.items():
            neq = got.view(np.uint32) != v.view(np.uint32)
            log(f"   vs {k}: {int(neq.sum())}/{neq.size} diffs")
    return matches


def make_inputs():
    """a, b, c, d: [8, 1024] f32 numpy, as the script makes them."""
    rng = np.random.default_rng(0)
    return tuple((0.3 * rng.standard_normal(SHAPE)
                  ).astype(np.float32) for _ in range(4))


def candidates(a, b, c, d):
    """The script's candidate values: {row: {candidate: f32 array}}."""
    x, u = a + b, c + d
    return {
        "a*b-c": {"plain": a * b - c, "fma": fma64(a, b, -c)},
        "a*b-c*d": {
            "plain": a * b - c * d,
            "fma_first": fma64(a, b, -(c * d)),
            "fma_second": fma64(-c, d, a * b),
            "fma_both64": (a.astype(np.float64) * b.astype(np.float64)
                           - c.astype(np.float64) * d.astype(np.float64)
                           ).astype(np.float32)},
        "a*b+c*d": {"plain": a * b + c * d,
                    "fma_first": fma64(a, b, c * d),
                    "fma_second": fma64(c, d, a * b)},
        "(a+b)*k1-(c+d)*k2": {
            "plain": x * np.float32(W7) - u * np.float32(W3),
            "fma_first": fma64(x, np.full_like(x, W7), -(u * np.float32(W3))),
            "fma_second": fma64(-u, np.full_like(u, W3),
                                x * np.float32(W7))},
    }


# ---------------------------------------------------------------------------
# Plain versions (torch eager: one op per kernel, never contracted)
# ---------------------------------------------------------------------------


def k1_plain(a, b, c, d):
    return a * b - c


def k2_plain(a, b, c, d):
    return a * b - c * d


def k3_plain(a, b, c, d):
    return a * b + c * d


def butterfly_plain(a, b, c, d):
    return (a + b) * W7 - (c + d) * W3


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str):
    return cfn(lib_name, "mrc_probe_fma",
               [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_longlong])


def _kernel(which: int, a, b, c, d, contract: bool = False):
    name = f"k{which}"
    check_args(name, [(t, torch.float32, tuple(a.shape))
                      for t in (a, b, c, d)])
    out = torch.empty_like(a)
    if a.numel():
        launch(name, _fn(CONTROL if contract else "probe_fma"), which,
               a.data_ptr(), b.data_ptr(), c.data_ptr(), d.data_ptr(),
               out.data_ptr(), a.numel(), device=a.device)
        if not contract:
            launches[name] += 1
    return out


def k1_kernel(a, b, c, d, contract: bool = False):
    return _kernel(1, a, b, c, d, contract)


def k2_kernel(a, b, c, d, contract: bool = False):
    return _kernel(2, a, b, c, d, contract)


def k3_kernel(a, b, c, d, contract: bool = False):
    return _kernel(3, a, b, c, d, contract)


BODIES = {"k1": (k1_kernel, k1_plain), "k2": (k2_kernel, k2_plain),
          "k3": (k3_kernel, k3_plain)}


def body(name: str, a, b, c, d):
    """k1-k3: the kernel on the card, the plain version on the CPU."""
    kernel, plain = BODIES[name]
    return pick(a, kernel, plain)(a, b, c, d)


def body_inputs(device):
    args = tuple(torch.from_numpy(v).to(device) for v in make_inputs())
    return {name: args for name in BODIES}


# ---------------------------------------------------------------------------
# SASS audit
# ---------------------------------------------------------------------------

_FUNC = re.compile(r"Function : (\S+)")
_INSTR = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)")


def sass_counts(text: str) -> dict:
    """A `cuobjdump -sass` listing -> {function: {"FFMA": n, "FTZ": n,
    "instructions": n, "ftz_ops": {opcode: n}}}."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), {"FFMA": 0, "FTZ": 0,
                                              "instructions": 0,
                                              "ftz_ops": {}})
            continue
        m = _INSTR.search(line)
        if m is None or cur is None:
            continue
        op = m.group(1)
        cur["instructions"] += 1
        if op.split(".")[0].startswith("FFMA"):
            cur["FFMA"] += 1
        if ".FTZ" in op:
            cur["FTZ"] += 1
            cur["ftz_ops"][op] = cur["ftz_ops"].get(op, 0) + 1
    return out


def sass_opcodes(text: str) -> dict:
    """A `cuobjdump -sass` listing -> {function: {mnemonic: n}}, the
    mnemonic being the opcode before its first dot."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.search(line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        m = _INSTR.search(line)
        if m is not None and cur is not None:
            op = m.group(1).split(".")[0]
            cur[op] = cur.get(op, 0) + 1
    return out


def cuobjdump() -> str:
    from ..ops.kernels import build
    path = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    if not os.path.exists(path):
        raise RuntimeError(f"cuobjdump not found beside nvcc ({path})")
    return path


def sass_audit() -> dict:
    """{library: {"FFMA": n, "FTZ": n, "functions": sass_counts}} for
    every lib*.so in the build directory."""
    from ..ops.kernels import build
    tool = cuobjdump()
    audit = {}
    for path in sorted(glob.glob(os.path.join(build.BUILD, "lib*.so"))):
        text = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, timeout=120, check=True).stdout
        funcs = sass_counts(text)
        name = os.path.basename(path)[3:-3]
        audit[name] = {"FFMA": sum(f["FFMA"] for f in funcs.values()),
                       "FTZ": sum(f["FTZ"] for f in funcs.values()),
                       "functions": funcs}
    return audit


def _ieee_routine(func: str) -> bool:
    return any(k in func for k in IEEE_ROUTINE_KERNELS)


def audit_failures(audit: dict) -> list[str]:
    """What the audit must show: no FFMA and no .FTZ in any kernel of any
    library but the control, apart from the kernels that call IEEE
    divide/sqrt or libm (IEEE_ROUTINE_KERNELS); at least one FFMA in the
    control; and the main path's libraries (K1-K13) present."""
    bad = [f"{lib}: not in the build directory" for lib in NORMATIVE + (CONTROL,)
           if lib not in audit]
    for lib, r in audit.items():
        if lib == CONTROL:
            if r["FFMA"] < 1:
                bad.append(f"{lib}: no FFMA in the positive control")
            continue
        for func, c in r["functions"].items():
            if (c["FFMA"] or c["FTZ"]) and (lib in NORMATIVE
                                            or not _ieee_routine(func)):
                bad.append(f"{lib}: {func} has {c['FFMA']} FFMA, "
                           f"{c['FTZ']} .FTZ {c['ftz_ops']}")
    return bad


def log_audit(audit: dict):
    log("SASS audit (cuobjdump -sass): library, FFMA, .FTZ, kernels")
    for lib, r in audit.items():
        log(f"  {lib:22s} FFMA {r['FFMA']:4d}  .FTZ {r['FTZ']:4d}  "
            f"kernels {len(r['functions'])}")
        for func, c in r["functions"].items():
            if c["FFMA"] or c["FTZ"]:
                log(f"    {func}: FFMA {c['FFMA']}, .FTZ {c['FTZ']} "
                    f"{c['ftz_ops']} of {c['instructions']} instructions")


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------


def run(device) -> dict:
    """Classify every row; on the card also the control and the SASS
    audit. -> {"classes": {row: [matches]}, "audit": {...} or None,
    "audit_failures": [...]}."""
    a, b, c, d = make_inputs()
    cands = candidates(a, b, c, d)
    ta, tb, tc, td = (torch.from_numpy(v).to(device) for v in (a, b, c, d))
    on_card = ta.is_cuda
    exprs = (("a*b-c", "k1", k1_plain), ("a*b-c*d", "k2", k2_plain),
             ("a*b+c*d", "k3", k3_plain))
    classes = {}

    def row(label, out, key):
        classes[label] = classify(label, out.cpu().numpy(), cands[key])

    for key, _, plain in exprs:
        row(f"torch eager {key}", plain(ta, tb, tc, td), key)
    row("torch eager (a+b)*k1-(c+d)*k2", butterfly_plain(ta, tb, tc, td),
        "(a+b)*k1-(c+d)*k2")
    what = "kernel" if on_card else "plain version on the CPU"
    for key, name, _ in exprs:
        row(f"port {name} {key} ({what})", body(name, ta, tb, tc, td), key)
    audit, failures = None, []
    if on_card:
        for key, name, _ in exprs:
            kernel = BODIES[name][0]
            row(f"control {name} {key} (--fmad=true)",
                kernel(ta, tb, tc, td, contract=True), key)
        torch.cuda.synchronize()
        audit = sass_audit()
        log_audit(audit)
        failures = audit_failures(audit)
        log(f"SASS audit: {'as expected' if not failures else failures}")
    else:
        log("control and SASS audit: need the card")
    return {"classes": classes, "audit": audit, "audit_failures": failures}


def main(argv=None):
    cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
