"""The control: the reference put in the codec's place, one precision step
below the float32 the format states (bfloat16, `runner`'s `lower`), and
judged by the same comparison as a run. It has to come out not correct.

    python3 -m mrcbench.control --workload <cell> --seed <n> [--seed <n> ...]

For each seed it builds the cell's clips and calls at the cell's own
size, takes the control's outputs for as many calls as a run compares
(and, for the decode, the control's streams in place of the codec's
set-up streams), compares them with the reference's, and prints one JSON
line:
{"workload", "seed", "correct", "checks"}. The benchmark's own runs never
run it; it needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys

from .catalog import Catalog
from .entries import Load


def control_checks(load: Load, workers=None) -> dict:
    """The comparison's numbers for the control's outputs of the first
    `keep` calls, as many as a run compares."""
    calls = range(load.mix["keep"])
    want = load.expected(calls, workers)
    low = load.expected(calls, workers, lower=True)
    n = load.conf["clips_per_request"]
    if load.entry == "decode":
        kept = [(c, [low[load.key(c, 0)][1]]) for c in calls]
        streams = [low[load.key(c, 0)][0] for c in calls]
        return load.compare(kept, want, 0, streams)
    kept = [(c, [low[load.key(c, j)][0] if j in load.checked else b""
                 for j in range(n)]) for c in calls]
    return load.compare(kept, want, 0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mrcbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    cell = Catalog().cell(args.workload)
    for seed in args.seed:
        checks = control_checks(Load(cell, seed))
        ok = all(v <= lim for v, lim in checks.values())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": ok, "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
