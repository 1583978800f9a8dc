"""The benchmark's command: one run of one cell on the cards of this
machine.

    python3 -m mrcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It exits 2, printing no result, without a CUDA card or with fewer than
the cell asks for, and 3 if a module of JAX or of the JAX package is
loaded once the window has closed. Otherwise the last line of standard
output is the result's JSON object, and the last lines of standard error
are each compared number beside its limit. The codec builds its kernels
and native library at first use into its own `build/` directory in the
checkout.
"""
import time

T0 = time.perf_counter()        # set-up is timed from here

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mrcbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from .catalog import Catalog
    cell = Catalog().load("workloads", args.workload)
    import torch
    if not torch.cuda.is_available():
        _log("error: no CUDA card is available")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        _log(f"error: the cell needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} are visible")
        return 2
    from .harness import forbidden_modules, run_cell
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), "cuda:0", T0, log=_log)
    bad = forbidden_modules()
    if bad:
        _log("error: modules of JAX or of the JAX package are loaded: "
             + ", ".join(bad))
        return 3
    for k, (v, lim) in checks.items():
        _log(f"check {k} {v} limit {lim}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
