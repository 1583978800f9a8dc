"""Multi-process launch (port of mrcaudiocodec_tpu/parallel/launch.py).

One process per card: rank r runs on cuda:{r % cards} (`--device cpu`:
on the host). `initialize` wires the processes with
`torch.distributed.init_process_group(init_method="tcp://COORDINATOR")`,
NCCL on the card and gloo on the host by default. `--backend gloo` on the
card is allowed (several processes on one card, which NCCL refuses); the
exchanged tensors are then staged through host memory, and the log line
says so.

    # on every process (coordinator = the host of rank 0, a free port):
    python -m mrcaudiocodec_tpu_torch.parallel.launch corpus \\
        --coordinator 10.0.0.1:8476 --num-hosts 2 --host-id $ID \\
        --indir wavs/ --outdir out/
    python -m mrcaudiocodec_tpu_torch.parallel.launch scaling --n-seq 1

`corpus`: each process encodes the WAV files i with i % num_hosts ==
host_id (sorted names) on its own device, with a manifest of its own
(`manifest_h{id}.jsonl`); no collective. `scaling`: frames/s of a
synthetic mono corpus through `sharded.sharded_encode`, on this process's
device alone and over every process (a (world / n_seq, n_seq) grid), and
their scaling efficiency, as one JSON line from rank 0 (each trial timed
to the slowest rank's end). Without --coordinator a
single process (--num-hosts 1) takes a free localhost port, so the
process-group path runs at world size 1 too.

The JAX scaling bench's `align_slabs` is not ported: it aligned shards to
ops/blocking.DECISION_BLOCK, which the port does not have (every float
reduction is a pinned tree, so no shard length changes the work done a
frame).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import socket
import sys
import time

import torch
import torch.distributed as dist

from .. import config as C
from ..config import CodecConfig
from ..models import encoder


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator: str | None, num_hosts: int, host_id: int,
               device="cuda", backend: str | None = None):
    """Join the process group; -> (this process's device, backend).

    Rank host_id of num_hosts; on "cuda" the process takes card
    host_id % cards and makes it current. The backend defaults to nccl
    on the card, gloo on the host."""
    dev = encoder.device_for(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", host_id % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs --device cuda")
    if coordinator is None:
        if num_hosts > 1:
            raise ValueError("--coordinator is needed with --num-hosts > 1")
        coordinator = f"localhost:{free_port()}"
    # NCCL is told its card (else it guesses one from the rank)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_hosts, rank=host_id,
                            device_id=dev if backend == "nccl" else None)
    staged = backend == "gloo" and dev.type == "cuda"
    print(f"[launch] rank {host_id} of {num_hosts}: backend {backend}, "
          f"device {dev}"
          + ("; the exchanged tensors are staged through host memory"
             if staged else ""), file=sys.stderr, flush=True)
    return dev, backend


def scaling_bench(seconds: float, n_clips: int, bitrate: int, dev,
                  backend: str, n_seq: int = 1, trials: int = 3) -> dict:
    """frames/s of n_clips synthetic mono clips through sharded_encode: on
    this process's device alone ("1dev", every shard in turn on a 1 x 1
    grid) and over every process ("all": GroupShards on a (world / n_seq,
    n_seq) grid), best of `trials` after a warm-up, and
    scaling_efficiency = all / (1dev x devices). Frames are the clips'
    real frames. Each trial starts every rank together (a barrier) and
    ends when the slowest rank ends (the ranks' times all-reduced by
    MAX), so every rank gets the same figures."""
    from .. import corpus
    from . import mesh, sharded

    cfg = CodecConfig(fs=44100, channels=1, bitrate=bitrate)
    clips = corpus._synth_corpus(n_clips, seconds, channels=1)
    frames = n_clips * C.frames_for_samples(clips[0].shape[0])
    world = dist.get_world_size()
    one = mesh.Grid(1, 1)
    grid = mesh.make_grid(world // n_seq, n_seq)
    cases = {"1dev": (one, sharded.LocalShards(one, dev)),
             "all": (grid, sharded.GroupShards(grid, dev))}
    rows, nf_row, n_samples = sharded.pad_rows(clips, n_seq)
    comm = dev if backend == "nccl" else torch.device("cpu")
    results = {}
    for label, (g, ex) in cases.items():
        def run():
            sharded.sharded_encode(rows, nf_row, cfg, g, ex,
                                   n_samples=n_samples)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        run()                                   # warm-up: builds, tables
        dt = float("inf")
        for _ in range(trials):
            dist.barrier()
            t0 = time.perf_counter()
            run()
            slowest = torch.tensor([time.perf_counter() - t0],
                                   dtype=torch.float64, device=comm)
            dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
            dt = min(dt, float(slowest))
        results[label] = {"devices": g.size, "frames_per_s": frames / dt,
                          "wall_s": dt,
                          "nf_per_clip": C.frames_for_samples(
                              clips[0].shape[0])}
    r1, ra = results["1dev"], results["all"]
    results["scaling_efficiency"] = (
        ra["frames_per_s"] / (r1["frames_per_s"] * ra["devices"]))
    results.update(backend=backend, world_size=world, n_seq=n_seq,
                   device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu"))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="mrcaudiocodec_tpu_torch.parallel.launch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pc = sub.add_parser("corpus")
    pc.add_argument("--indir", required=True)
    pc.add_argument("--outdir", required=True)
    pc.add_argument("--bitrate", type=int, default=128)
    ps = sub.add_parser("scaling")
    ps.add_argument("--seconds", type=float, default=10.0)
    ps.add_argument("--clips", type=int, default=16)
    ps.add_argument("--bitrate", type=int, default=128)
    ps.add_argument("--n-seq", type=int, default=1)
    for p in (pc, ps):
        p.add_argument("--coordinator", default=None)
        p.add_argument("--num-hosts", type=int, default=1)
        p.add_argument("--host-id", type=int, default=0)
        p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
        p.add_argument("--backend", choices=["nccl", "gloo"], default=None)
    args = ap.parse_args(argv)
    try:
        encoder.device_for(args.device)
    except RuntimeError:
        raise SystemExit("error: no CUDA card is available; run with "
                         "--device cpu") from None
    try:
        dev, backend = initialize(args.coordinator, args.num_hosts,
                                  args.host_id, args.device, args.backend)
    except ValueError as e:
        raise SystemExit(f"error: {e}") from None
    try:
        if args.cmd == "scaling":
            out = scaling_bench(args.seconds, args.clips,
                                args.bitrate * 1000, dev, backend,
                                args.n_seq)
        else:
            from ..corpus import run_corpus
            paths = sorted(glob.glob(os.path.join(args.indir, "*.wav")))
            mine = [p for i, p in enumerate(paths)
                    if i % args.num_hosts == args.host_id]
            out = run_corpus(mine, args.outdir,
                             {"bitrate": args.bitrate * 1000},
                             manifest_path=os.path.join(
                                 args.outdir,
                                 f"manifest_h{args.host_id}.jsonl"),
                             devices=[str(dev)])
        if args.cmd == "corpus" or args.host_id == 0:  # scaling: one line
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
