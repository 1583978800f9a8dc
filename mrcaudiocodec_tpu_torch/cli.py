"""Command-line entry points of the PyTorch port.

    python -m mrcaudiocodec_tpu_torch.cli encode in.wav out.mrc --bitrate 128 \\
        [--engine torch|spec] [--device cuda|cpu] [--window sine|kbd] \\
        [--no-window-switching] [--no-psycho] [--no-reservoir]
    python -m mrcaudiocodec_tpu_torch.cli decode in.mrc out.wav \\
        [--engine torch|spec] [--device cuda|cpu]
    python -m mrcaudiocodec_tpu_torch.cli info in.mrc

The options and messages are those of mrcaudiocodec_tpu/cli.py, with
`--engine torch` (the default: the PyTorch codec) in place of its
`--engine tpu`, and `--device`. `--engine spec` runs the port's normative
NumPy codec (`spec.codec`) and takes no device. The torch engine runs on
the card (`--device cuda`, the default) unless `--device cpu` is given;
without a card, `--device cuda` exits non-zero, and nothing falls back to
the CPU or to the spec. Streams are byte-identical across engines and
devices.
"""
from __future__ import annotations

import argparse
import sys
import time

from . import audiofile, bitstream
from .config import CodecConfig
from .models import codec, encoder
from .spec import codec as spec_codec


def _build_cfg(args, fs: int, channels: int) -> CodecConfig:
    return CodecConfig(
        fs=fs,
        channels=channels,
        bitrate=args.bitrate * 1000,
        window_switching=not args.no_window_switching,
        full_psycho=not args.no_psycho,
        reservoir=not args.no_reservoir,
        window=args.window,
    )


def _device(name: str):
    """The device to run on; exits with an error if it is a missing card."""
    try:
        return encoder.device_for(name)
    except RuntimeError:
        raise SystemExit("error: no CUDA card is available; run with "
                         "--device cpu") from None


def cmd_encode(args) -> int:
    spec = args.engine == "spec"
    dev = None if spec else _device(args.device)
    name = "spec" if spec else dev.type
    x, fs = audiofile.read_wav(args.infile, raw_int16=not spec)
    cfg = _build_cfg(args, fs, x.shape[1])
    t0 = time.perf_counter()
    data = (spec_codec.encode(x, cfg) if spec
            else codec.encode(x, cfg, device=dev))
    dt = time.perf_counter() - t0
    with open(args.outfile, "wb") as f:
        f.write(data)
    dur = x.shape[0] / fs
    kbps = len(data) * 8 / dur / 1000
    print(f"[{name}] encoded {dur:.2f}s {cfg.channels}ch @{fs}Hz -> "
          f"{len(data)} bytes ({kbps:.1f} kbps) in {dt:.2f}s "
          f"({dur / dt:.2f}x realtime)")
    return 0


def cmd_decode(args) -> int:
    with open(args.infile, "rb") as f:
        data = f.read()
    spec = args.engine == "spec"
    dev = None if spec else _device(args.device)
    name = "spec" if spec else dev.type
    t0 = time.perf_counter()
    x, cfg = (spec_codec.decode(data) if spec
              else codec.decode(data, device=dev, pcm_dtype="int16"))
    dt = time.perf_counter() - t0
    audiofile.write_wav(args.outfile, x, cfg.fs)
    dur = x.shape[0] / cfg.fs
    print(f"[{name}] decoded {dur:.2f}s {cfg.channels}ch @{cfg.fs}Hz "
          f"in {dt:.2f}s ({dur / dt:.2f}x realtime)")
    return 0


def cmd_info(args) -> int:
    with open(args.infile, "rb") as f:
        data = f.read()
    cfg, nf, ns, _ = bitstream.read_header(data)
    dur = ns / cfg.fs
    print(f"MRC1 stream: {cfg.fs} Hz, {cfg.channels} ch, "
          f"{cfg.bitrate / 1000:.0f} kbps target, {nf} frames, "
          f"{ns} samples ({dur:.2f}s)")
    print(f"  window_switching={cfg.window_switching} "
          f"full_psycho={cfg.full_psycho} reservoir={cfg.reservoir} "
          f"window={cfg.window}")
    print(f"  actual rate: {len(data) * 8 / dur / 1000:.1f} kbps")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="mrcaudiocodec_tpu_torch",
        description="MRC1 perceptual audio codec (PyTorch + CUDA)")
    sub = p.add_subparsers(dest="cmd", required=True)

    pe = sub.add_parser("encode", help="encode WAV -> MRC1")
    pe.add_argument("infile")
    pe.add_argument("outfile")
    pe.add_argument("--bitrate", type=int, default=128,
                    help="target bitrate in kbps (total)")
    pe.add_argument("--engine", choices=["torch", "spec"], default="torch")
    pe.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the torch engine runs")
    pe.add_argument("--window", choices=["sine", "kbd"], default="sine")
    pe.add_argument("--no-window-switching", action="store_true")
    pe.add_argument("--no-psycho", action="store_true")
    pe.add_argument("--no-reservoir", action="store_true")
    pe.set_defaults(fn=cmd_encode)

    pd = sub.add_parser("decode", help="decode MRC1 -> WAV")
    pd.add_argument("infile")
    pd.add_argument("outfile")
    pd.add_argument("--engine", choices=["torch", "spec"], default="torch")
    pd.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the torch engine runs")
    pd.set_defaults(fn=cmd_decode)

    pi = sub.add_parser("info", help="print MRC1 stream info")
    pi.add_argument("infile")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except (ValueError, EOFError) as e:
        print(f"error: invalid input: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
