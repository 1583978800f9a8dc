"""The PyTorch port end to end on the CPU: streams byte-identical to the
spec codec and the JAX engine, decoded PCM bitwise equal, goldens.

`encode(..., device="cpu")` / `decode(..., device="cpu")` run the same
code as on the card, with each CUDA kernel's plain version in its place
(tests/test_torch_kernels.py holds the kernels to those versions).
"""
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu.config import CodecConfig as JCfg
from mrcaudiocodec_tpu.spec import codec as scodec

from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec

from tests.test_conformance import CASES, make_clip
from tests.test_golden import GOLDEN, make_golden_clip

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(y):
    return np.ascontiguousarray(y, np.float32).view(np.int32)


@pytest.mark.parametrize("name,fs,channels,bitrate,kw", CASES,
                         ids=[c[0] for c in CASES])
def test_stream_equals_spec(name, fs, channels, bitrate, kw):
    x = make_clip(fs, 0.6, channels)
    bs_spec = scodec.encode(x, JCfg(fs=fs, channels=channels,
                                    bitrate=bitrate, **kw))
    cfg = CodecConfig(fs=fs, channels=channels, bitrate=bitrate, **kw)
    bs = codec.encode(x, cfg, device="cpu")
    assert bs == bs_spec
    y, cfg2 = codec.decode(bs, device="cpu")
    y_spec, _ = scodec.decode(bs_spec)
    np.testing.assert_array_equal(_bits(y), _bits(y_spec))
    assert cfg2 == cfg


def test_stream_equals_jax_engine_and_cross_decodes():
    """config2 through the JAX engine: same bytes; each engine decodes
    the other's stream to the same PCM."""
    from mrcaudiocodec_tpu.models import codec as tcodec
    x = make_clip(44100, 0.6, 2)
    bs_jax = tcodec.encode(x, JCfg(fs=44100, channels=2, bitrate=128000))
    bs = codec.encode(x, CodecConfig(fs=44100, channels=2, bitrate=128000),
                      device="cpu")
    assert bs == bs_jax
    y_port, _ = codec.decode(bs_jax, device="cpu")
    y_jax, _ = tcodec.decode(bs)
    y_spec, _ = scodec.decode(bs)
    np.testing.assert_array_equal(_bits(y_port), _bits(y_jax))
    np.testing.assert_array_equal(_bits(y_port), _bits(y_spec))


@pytest.mark.parametrize("name,fs,ch,br,kw,digest", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_digest(name, fs, ch, br, kw, digest):
    cfg = CodecConfig(fs=fs, channels=ch, bitrate=br, **kw)
    bs = codec.encode(make_golden_clip(fs, 0.7, ch), cfg, device="cpu")
    assert hashlib.sha256(bs).hexdigest() == digest


@pytest.mark.parametrize("n", [1, 10, 1023, 1024, 1025])
def test_clip_lengths(n):
    from mrcaudiocodec_tpu.models import codec as tcodec
    x = (0.3 * np.random.default_rng(n).standard_normal((n, 1))
         ).astype(np.float32)
    bs_spec = scodec.encode(x, JCfg(fs=44100, channels=1, bitrate=96000))
    bs = codec.encode(x, CodecConfig(fs=44100, channels=1, bitrate=96000),
                      device="cpu")
    assert bs == bs_spec
    y, _ = codec.decode(bs, device="cpu")
    y_spec, _ = scodec.decode(bs_spec)
    y_jax, _ = tcodec.decode(bs_spec)
    assert y.shape == (n, 1)
    np.testing.assert_array_equal(_bits(y), _bits(y_spec))
    np.testing.assert_array_equal(_bits(y), _bits(y_jax))


def test_int16_input_and_output():
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    xi = np.clip(np.round(make_clip(44100, 0.4, 2) * 32768.0),
                 -32768, 32767).astype(np.int16)
    bs_int = codec.encode(xi, cfg, device="cpu")
    bs_float = codec.encode(xi.astype(np.float32) / np.float32(32768.0), cfg,
                            device="cpu")
    assert bs_int == bs_float
    yf, _ = codec.decode(bs_int, device="cpu")
    yi, _ = codec.decode(bs_int, device="cpu", pcm_dtype="int16")
    ref = np.clip(np.round(yf * 32767.0), -32768, 32767).astype(np.int16)
    np.testing.assert_array_equal(yi, ref)


def test_chunk_size_does_not_change_bytes(monkeypatch):
    """No fixed-block execution is needed: chunking changes no byte."""
    from mrcaudiocodec_tpu_torch.models import decoder, encoder
    cfg = CodecConfig(fs=44100, channels=2, bitrate=128000)
    x = make_clip(44100, 0.8, 2, seed=5)
    a = codec.encode(x, cfg, device="cpu")
    ya, _ = codec.decode(a, device="cpu")
    monkeypatch.setattr(encoder, "ENC_ROW_FRAMES", 14)     # 7 frames x 2
    monkeypatch.setattr(decoder, "DEC_CHUNK", 5)
    assert codec.encode(x, cfg, device="cpu") == a
    yb, _ = codec.decode(a, device="cpu")
    np.testing.assert_array_equal(_bits(ya), _bits(yb))
    with pytest.raises(ValueError, match="pcm_dtype"):
        codec.decode(a, device="cpu", pcm_dtype="float64")


def test_default_device_is_cuda():
    cfg = CodecConfig(fs=44100, channels=1, bitrate=96000)
    x = make_clip(44100, 0.1, 1)
    if torch.cuda.is_available():
        bs = codec.encode(x, cfg)
        assert bs == codec.encode(x, cfg, device="cpu")
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        codec.encode(x, cfg)
    bs = codec.encode(x, cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        codec.decode(bs)


IMPORT_EVERYTHING = """
import ast, importlib, pkgutil, sys
import mrcaudiocodec_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                               pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
for node in ast.walk(ast.parse(open("chip_smoke.py").read())):
    if isinstance(node, ast.Import):
        for a in node.names:
            importlib.import_module(a.name)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        importlib.import_module(node.module)
        for a in node.names:           # a submodule, or a name in it
            try:
                importlib.import_module(node.module + "." + a.name)
            except ModuleNotFoundError:
                getattr(sys.modules[node.module], a.name)
import chip_smoke
assert "mrcaudiocodec_tpu_torch.parallel.launch" in names, names
bad = [m for m in sys.modules if m == "jax" or m.startswith(
    ("jax.", "mrcaudiocodec_tpu.")) or m == "mrcaudiocodec_tpu"]
assert not bad, bad
"""


def test_port_imports_no_jax():
    """Every module of the port (a walk of the package) and every module
    chip_smoke.py imports load no JAX and nothing of the JAX package."""
    subprocess.run([sys.executable, "-c", IMPORT_EVERYTHING], cwd=REPO,
                   check=True, timeout=120)


def test_chip_smoke_refuses_without_card_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: chip_smoke.py would run")
    for cwd in (REPO, str(tmp_path)):
        script = os.path.join(cwd, "chip_smoke.py")
        if cwd != REPO:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), script)
        res = subprocess.run([sys.executable, script], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
