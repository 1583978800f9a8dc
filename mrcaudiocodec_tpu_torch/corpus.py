"""Corpus runner: batched encode of many clips over the local cards, with
a completion manifest for cheap restart.

Port of mrcaudiocodec_tpu/corpus.py. Clips that share channel count and
dtype run as one fused batch (every channel of every clip is one row of
`encoder.encode_rows`, records built on the device), spread in contiguous
blocks of whole clips over a list of devices (the data axis; default:
every local card), a host thread a block; streams are byte-identical to
encoding each clip alone. Across processes, `parallel/launch.py corpus`
splits the files by rank.

    python -m mrcaudiocodec_tpu_torch.corpus run INDIR OUTDIR --bitrate 128
    python -m mrcaudiocodec_tpu_torch.corpus bench --clips 64 --seconds 10

Both run on the card unless `--device cpu` is given; without CUDA they
exit non-zero.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import glob
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from . import audiofile
from . import trace
from .config import CodecConfig, frames_for_samples
from .models import encoder

# Fused batches pad every clip's frame count up to a multiple of this, so
# clips of similar lengths share one bucket (waste is bounded by
# FRAME_BUCKET - 1 silent frames, about 1.5 s a clip).
FRAME_BUCKET = 64


def local_devices(device="cuda") -> list[str]:
    """The devices a batch spreads over by default: every local card for
    "cuda", else the one device named (raises for "cuda" without one)."""
    dev = encoder.device_for(device)
    if dev.type == "cuda" and dev.index is None:
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return [str(dev)]


def encode_batch(clips: list[np.ndarray], cfg: CodecConfig,
                 device="cuda", devices=None) -> list[bytes]:
    """Encode clips, batching the device work across clips where possible.

    Each clip is [n] or [n, channels] float32 (or int16). Clips that
    share channel count and dtype (lengths may differ) run through the
    fused path, spread over `devices` (default `local_devices(device)`);
    otherwise each clip is encoded alone on the first of them. Streams are
    byte-identical either way."""
    trace.count("requests.encode_batch")
    with trace.span("mrc.encode_batch"):
        devices = list(devices or local_devices(device))
        arrs = []
        for x in clips:
            x = np.asarray(x)
            if x.dtype != np.int16:
                x = x.astype(np.float32)
            if x.ndim == 1:
                x = x[:, None]
            arrs.append(x)
        if (len(arrs) > 1
                and len({a.shape[1] for a in arrs}) == 1
                and len({a.dtype for a in arrs}) == 1):
            return _encode_batch_fused(arrs, cfg, devices)
        return [encoder.encode(x, cfg, devices[0]) for x in arrs]


def _on_device(dev: torch.device):
    """Make `dev` the current card (nothing for the CPU)."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _pad_batch(arrs: list[np.ndarray], out):
    """A batch's clips [n_i, nch] -> copied back to back into `out`, their
    view of the staging buffer (`encoder.stage_pcm`): the batch's host work
    before the copy up, under the name its benchmark metric reads."""
    return encoder.stage_pcm(arrs, out)


def _encode_batch_fused(arrs: list[np.ndarray], cfg: CodecConfig,
                        devices: list) -> list[bytes]:
    """Same-channel-count, same-dtype clips -> batches of rows, one
    contiguous block of whole clips a device (mrcaudiocodec_tpu/corpus.py
    :94-113 shards the rows over the local devices), each uploaded and
    encoded under its device in a host thread of its own, so one device's
    host work overlaps another's kernels. Each row is tail-padded on the
    device with silence to a shared frame count (a FRAME_BUCKET multiple);
    each row's true frame count goes to the reservoir, the only whole-clip
    quantity, so pad frames change no byte, and stream order leaves them
    out of every body. int16 sources stay int16 through the upload."""
    nch = arrs[0].shape[1]
    n_list = [a.shape[0] for a in arrs]
    nf_list = [frames_for_samples(n) for n in n_list]
    nf = -(-max(nf_list) // FRAME_BUCKET) * FRAME_BUCKET
    nf_row = np.repeat(nf_list, nch)
    with trace.span("mrc.assemble"):
        heads = [encoder.header(cfg, f, n) for f, n in zip(nf_list, n_list)]
    per = -(-len(arrs) // min(len(devices), len(arrs)))    # clips a block
    blocks = [(encoder.device_for(devices[i]), slice(k, k + per))
              for i, k in enumerate(range(0, len(arrs), per))]

    def run(block):
        dev, clips = block
        with _on_device(dev):
            pcm = encoder.upload_pcm(arrs[clips], dev, _pad_batch)
            return encoder.encode_rows(
                pcm, nf, nf_row[clips.start * nch:clips.stop * nch], cfg,
                heads[clips])

    if len(blocks) == 1:
        return run(blocks[0])
    # one host thread a block: the devices overlap
    with concurrent.futures.ThreadPoolExecutor(len(blocks)) as pool:
        return [s for got in pool.map(run, blocks) for s in got]


def run_corpus(paths: list[str], outdir: str, cfg_base: dict,
               manifest_path: str | None = None,
               group_size: int | None = None, device="cuda",
               devices=None) -> dict:
    """Encode files with manifest-based resume. Returns stats.

    Clips are bucketed by (fs, channels, dtype, ceil(frames/FRAME_BUCKET))
    and each bucket is encoded as one fused batch (encode_batch) over
    `devices` (default `local_devices(device)`). The manifest is written
    per flushed group, so restart cost is bounded by group_size clips
    (default max(4 * devices_global, 16)). `devices_local` counts the
    devices this process spreads a batch over, `devices_global` those of
    every process of the process group (world size x devices_local)."""
    devices = list(devices or local_devices(device))
    world = dist.get_world_size() if dist.is_initialized() else 1
    os.makedirs(outdir, exist_ok=True)
    manifest_path = manifest_path or os.path.join(outdir, "manifest.jsonl")
    done = set()
    claimed_dst: dict[str, str] = {}          # dst -> src (from manifest)
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done.add(rec["src"])
                    claimed_dst[rec.get("dst", "")] = rec["src"]
                except (json.JSONDecodeError, KeyError):
                    continue
    todo = [p for p in paths if p not in done]
    stats = {"total": len(paths), "skipped": len(paths) - len(todo),
             "encoded": 0, "audio_seconds": 0.0, "wall_seconds": 0.0,
             "devices_local": len(devices),
             "devices_global": len(devices) * world, "batches": 0}
    if group_size is None:
        group_size = max(4 * stats["devices_global"], 16)
    t0 = time.perf_counter()
    pending: dict[tuple, list[tuple[str, np.ndarray]]] = {}
    used_dst: set[str] = set()

    def dst_for(path: str) -> str:
        """Output path; clips that share a basename (a/x.wav and b/x.wav)
        get a .1/.2 suffix instead of overwriting each other. A dst claimed
        by THIS src in the manifest (partial re-run) may be overwritten."""
        base = os.path.splitext(os.path.basename(path))[0]
        dst = os.path.join(outdir, base + ".mrc")
        k = 1
        while (dst in used_dst
               or claimed_dst.get(dst, path) != path):
            dst = os.path.join(outdir, f"{base}.{k}.mrc")
            k += 1
        used_dst.add(dst)
        return dst

    with open(manifest_path, "a") as mf:

        def flush(key):
            group = pending.pop(key, [])
            if not group:
                return
            fs, nch = key[0], key[1]
            cfg = CodecConfig(fs=fs, channels=nch, **cfg_base)
            datas = encode_batch([x for _, x in group], cfg,
                                 devices=devices)
            for (path, x), data in zip(group, datas):
                dst = dst_for(path)
                with open(dst, "wb") as f:
                    f.write(data)
                mf.write(json.dumps({"src": path, "dst": dst,
                                     "bytes": len(data)}) + "\n")
                stats["encoded"] += 1
                stats["audio_seconds"] += x.shape[0] / fs
            mf.flush()
            stats["batches"] += 1

        for path in todo:
            x, fs = audiofile.read_wav(path, raw_int16=True)
            key = (fs, x.shape[1], str(x.dtype),
                   -(-frames_for_samples(x.shape[0]) // FRAME_BUCKET))
            pending.setdefault(key, []).append((path, x))
            if len(pending[key]) >= group_size:
                flush(key)
        for key in list(pending):
            flush(key)
    stats["wall_seconds"] = time.perf_counter() - t0
    return stats


def _synth_corpus(n_clips, seconds, fs=44100, channels=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    clips = []
    for c in range(n_clips):
        f0 = 200 + 37.0 * (c % 13)
        x = (0.4 * np.sin(2 * np.pi * f0 * t)
             + 0.15 * np.sin(2 * np.pi * 3.1 * f0 * t)
             + 0.02 * rng.standard_normal(n)).astype(np.float32)
        x[n // 3:n // 3 + 80] += (0.5 * rng.standard_normal(80)).astype(np.float32)
        x = np.clip(x, -1, 1)
        clips.append(np.stack([x, np.roll(x, 5) * 0.9], 1)
                     if channels == 2 else x[:, None])
    return clips


def _sync(device) -> str:
    """Wait for the card (if `device` is one); -> the device's name."""
    if not str(device).startswith("cuda"):
        return "cpu"
    import torch
    torch.cuda.synchronize()
    return torch.cuda.get_device_name(0)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mrcaudiocodec_tpu_torch.corpus")
    sub = ap.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run")
    pr.add_argument("indir")
    pr.add_argument("outdir")
    pr.add_argument("--bitrate", type=int, default=128)
    pr.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    pb = sub.add_parser("bench")
    pb.add_argument("--clips", type=int, default=64)
    pb.add_argument("--seconds", type=float, default=10.0)
    pb.add_argument("--bitrate", type=int, default=128)
    pb.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    try:
        encoder.device_for(args.device)
    except RuntimeError:
        raise SystemExit("error: no CUDA card is available; run with "
                         "--device cpu") from None

    if args.cmd == "run":
        paths = sorted(glob.glob(os.path.join(args.indir, "*.wav")))
        stats = run_corpus(paths, args.outdir,
                           {"bitrate": args.bitrate * 1000},
                           device=args.device)
        print(json.dumps(stats))
        return 0

    cfg = CodecConfig(fs=44100, channels=2, bitrate=args.bitrate * 1000)
    clips = _synth_corpus(args.clips, args.seconds)
    encode_batch(clips[:2], cfg, args.device)         # warm-up
    _sync(args.device)
    t0 = time.perf_counter()
    encode_batch(clips, cfg, args.device)
    name = _sync(args.device)
    dt = time.perf_counter() - t0
    audio = args.clips * args.seconds
    nf = frames_for_samples(int(44100 * args.seconds)) * 2 * args.clips
    print(json.dumps({
        "device": name, "clips": args.clips, "audio_seconds": audio,
        "wall_seconds": dt, "realtime_factor": audio / dt,
        "frames_per_second": nf / dt,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
