"""The port's CLI (python -m mrcaudiocodec_tpu_torch.cli) against the JAX
package's CLI with `--engine spec` (the normative NumPy codec): the same
.mrc bytes, the same decoded WAV, the same `info` fields, the same exit
codes on bad input; and `--device cuda` without a card exits non-zero.
"""
import os
import subprocess
import sys

import pytest
import torch

from mrcaudiocodec_tpu import cli as jcli

from mrcaudiocodec_tpu_torch import audiofile
from mrcaudiocodec_tpu_torch import cli
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec

from tests.test_conformance import make_clip

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def wav(tmp_path):
    """0.5 s stereo 44.1 kHz int16 WAV."""
    path = str(tmp_path / "in.wav")
    audiofile.write_wav(path, make_clip(44100, 0.5, 2), 44100)
    return path


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("flags", [[], ["--bitrate", "96", "--window", "kbd"],
                                   ["--no-psycho", "--no-reservoir",
                                    "--no-window-switching"]],
                         ids=["default", "96k_kbd", "no_options"])
def test_encode_matches_jax_cli_spec(wav, tmp_path, capsys, flags):
    port, spec = str(tmp_path / "p.mrc"), str(tmp_path / "s.mrc")
    assert cli.main(["encode", wav, port, "--device", "cpu", *flags]) == 0
    assert capsys.readouterr().out.startswith("[cpu] encoded 0.50s 2ch")
    assert jcli.main(["encode", wav, spec, "--engine", "spec", *flags]) == 0
    assert _read(port) == _read(spec)
    x, fs = audiofile.read_wav(wav, raw_int16=True)
    br = int(flags[1]) * 1000 if flags[:1] == ["--bitrate"] else 128000
    cfg = CodecConfig(fs=fs, channels=2, bitrate=br,
                      window="kbd" if "kbd" in flags else "sine",
                      full_psycho="--no-psycho" not in flags,
                      reservoir="--no-reservoir" not in flags,
                      window_switching="--no-window-switching" not in flags)
    assert _read(port) == codec.encode(x, cfg, device="cpu")


def test_decode_and_info_match_jax_cli(wav, tmp_path, capsys):
    mrc = str(tmp_path / "a.mrc")
    assert jcli.main(["encode", wav, mrc, "--engine", "spec"]) == 0
    port_wav, spec_wav = str(tmp_path / "p.wav"), str(tmp_path / "s.wav")
    assert cli.main(["decode", mrc, port_wav, "--device", "cpu"]) == 0
    assert jcli.main(["decode", mrc, spec_wav, "--engine", "spec"]) == 0
    assert _read(port_wav) == _read(spec_wav)
    capsys.readouterr()
    assert cli.main(["info", mrc]) == 0
    port_info = capsys.readouterr().out
    assert jcli.main(["info", mrc]) == 0
    assert port_info == capsys.readouterr().out
    assert "MRC1 stream: 44100 Hz, 2 ch, 128 kbps target" in port_info


@pytest.mark.parametrize("flags", [[], ["--bitrate", "96", "--window", "kbd",
                                         "--no-reservoir"]],
                         ids=["default", "96k_kbd_no_reservoir"])
def test_engine_spec_encode_matches_jax_cli_spec(wav, tmp_path, capsys,
                                                 flags):
    """--engine spec runs the port's NumPy spec (no card needed, whatever
    --device says): the JAX CLI's --engine spec bytes."""
    port, spec = str(tmp_path / "p.mrc"), str(tmp_path / "s.mrc")
    assert cli.main(["encode", wav, port, "--engine", "spec", *flags]) == 0
    assert capsys.readouterr().out.startswith("[spec] encoded 0.50s 2ch")
    assert jcli.main(["encode", wav, spec, "--engine", "spec", *flags]) == 0
    assert _read(port) == _read(spec)


def test_engine_spec_decode_matches_jax_cli_spec(wav, tmp_path, capsys):
    mrc = str(tmp_path / "a.mrc")
    assert jcli.main(["encode", wav, mrc, "--engine", "spec"]) == 0
    port_wav, spec_wav = str(tmp_path / "p.wav"), str(tmp_path / "s.wav")
    capsys.readouterr()
    assert cli.main(["decode", mrc, port_wav, "--engine", "spec"]) == 0
    assert capsys.readouterr().out.startswith("[spec] decoded 0.50s 2ch")
    assert jcli.main(["decode", mrc, spec_wav, "--engine", "spec"]) == 0
    assert _read(port_wav) == _read(spec_wav)


def _exit_code(main, argv):
    try:
        return main(argv)
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else 1


@pytest.mark.parametrize("case", ["not_mrc", "truncated", "missing",
                                  "typo_flag"])
def test_error_exit_codes_match_jax_cli(wav, tmp_path, capsys, case):
    mrc = str(tmp_path / "a.mrc")
    assert jcli.main(["encode", wav, mrc, "--engine", "spec"]) == 0
    out = str(tmp_path / "o.wav")
    if case == "not_mrc":
        argv = ["decode", wav, out]
    elif case == "truncated":
        cut = str(tmp_path / "cut.mrc")
        with open(cut, "wb") as f:
            f.write(_read(mrc)[:500])
        argv = ["decode", cut, out]
    elif case == "missing":
        argv = ["decode", str(tmp_path / "nope.mrc"), out]
    else:
        argv = ["encode", wav, mrc, "--bitrte", "96"]
    port = _exit_code(cli.main, argv + ["--device", "cpu"])
    spec = _exit_code(jcli.main, argv + ["--engine", "spec"])
    assert port == spec and port != 0
    err = capsys.readouterr().err
    assert "error" in err


def test_device_cuda_without_card_exits_nonzero(wav, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "-m", "mrcaudiocodec_tpu_torch.cli", "encode", wav,
         str(tmp_path / "a.mrc")], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert res.returncode != 0
    assert "no CUDA card" in res.stderr
    assert not os.path.exists(tmp_path / "a.mrc")
    with pytest.raises(SystemExit, match="--device cpu"):
        cli.main(["decode", wav, str(tmp_path / "o.wav")])
