"""K4 beside another version's K4, on the main path's inputs, in turns.

    python -m mrcaudiocodec_tpu_torch.k4_turns BASE_DIR

BASE_DIR holds another version of this package, importable under
BASE_DIR's own name (for example a parent commit's, unpacked with `git
archive <commit> mrcaudiocodec_tpu_torch` and renamed); its K4 builds
from its own csrc/ into its own build/. The inputs are those the main
path gives K4, captured at the wrapper: the 30 s stereo 44.1 kHz 128 kbps
clip's chunk (2586 rows) and the first chunk of the 64 x 10 s corpus
batch (8192 rows). On each, both kernels must give the same q, amp, gain
and bits; then each is timed in turns (base, this, this, base, ROUNDS
times), a turn being the profiler's device ms a launch over 20 launches.
Beside the times: each input's bound by this design's op count and by
the count of a K4 that quantizes again in every over-mask
(`profiling.rd_loop_ops`), and the card's name and power limit.
One JSON line on stdout, logs on stderr. Card only; exits 2 without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

import numpy as np

ROUNDS = 3


def main_path_inputs():
    """{"2586 rows": the 30 s encode's K4 input, "8192 rows": the corpus
    batch's first}."""
    import torch
    from . import corpus
    from .bench import make_clip, to_i16
    from .config import CodecConfig
    from .models import codec
    from .profiling import capture_inputs
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    clip = to_i16(make_clip(44100, 30.0, 2))
    enc = capture_inputs(lambda: codec.encode(clip, cfg, device="cuda"))
    clips = corpus._synth_corpus(64, 10.0)
    batch = capture_inputs(
        lambda: corpus.encode_batch(clips, cfg, device="cuda"))
    out = {f"{k[1][0]} rows": a for caps in (enc, batch)
           for k, a in caps.items() if k[0] == "rd_loop"}
    torch.cuda.synchronize()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("base", help="directory of the other package version")
    a = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k4_turns: no CUDA card available", file=sys.stderr)
        return 2
    from .ops.kernels import rd_loop
    from .profiling import (bound_ms, card_line, device_ms, log,
                            rd_loop_ops, HBM_BYTES_PER_S, F32_OPS_PER_S,
                            kernel_bound)
    base_dir = os.path.abspath(a.base)
    sys.path.insert(0, os.path.dirname(base_dir))
    base = importlib.import_module(
        os.path.basename(base_dir) + ".ops.kernels.rd_loop")
    kernels = {"base": base.rd_loop_kernel, "this": rd_loop.rd_loop_kernel}
    smi = card_line()
    res = {"card": smi, "base": base_dir, "inputs": {}}
    for name, args in main_path_inputs().items():
        outs = {k: fn(*args) for k, fn in kernels.items()}
        torch.cuda.synchronize()
        same = all(torch.equal(g, w) for g, w in zip(outs["base"],
                                                      outs["this"]))
        if not same:
            log(f"[k4 turns] {name}: the two kernels differ")
            return 1
        times = {k: [] for k in kernels}
        for _ in range(ROUNDS):
            for k in ("base", "this", "this", "base"):
                times[k].append(device_ms(lambda: kernels[k](*args), 20,
                                          match="rd_loop_kernel"))
        b, o, _ = kernel_bound(("rd_loop", (args[0].shape[0],)), args)
        oq = rd_loop_ops(args, kept=False)
        t_new, _ = bound_ms([(b, o, F32_OPS_PER_S)])
        t_req, _ = bound_ms([(b, oq, F32_OPS_PER_S)])
        r = {"equal": same, "device_ms": times,
             "mean_ms": {k: float(np.mean([t for t in v if t is not None]))
                         for k, v in times.items()},
             "bound_ms": t_new, "bound_ms_requantize": t_req,
             "ops": o, "ops_requantize": oq,
             "bytes_ms": b / HBM_BYTES_PER_S * 1e3}
        res["inputs"][name] = r
        log(f"[k4 turns] {smi}; {name}: outputs equal; device ms in turns "
            f"(base, this, this, base) {json.dumps(times)}; means "
            f"{json.dumps(r['mean_ms'])}; bound {t_new:.5f} ms (this "
            f"count), {t_req:.5f} ms (requantizing count)")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
