"""The frozen reference and the traffic generators.

The reference's streams and PCM equal its frozen spec codec's and the
codec package's own spec's; it imports numpy and the standard library
only; the same seed gives the same inputs; and the control (the
reference one precision step below) comes out not correct in every
cell.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest

from mrcbench import gen
from mrcbench.catalog import Catalog
from mrcbench.control import control_checks
from mrcbench.entries import Load
from mrcbench.reference import runner
from mrcbench.reference.config import CodecConfig
from mrcbench.reference.spec import codec as frozen

HERE = os.path.dirname(os.path.abspath(__file__))
REF = os.path.join(os.path.dirname(HERE), "reference")
REPO = os.path.dirname(os.path.dirname(HERE))
FORBIDDEN = {"torch", "jax", "jaxlib", "flax", "mrcaudiocodec_tpu",
             "mrcaudiocodec_tpu_torch"}
SEED = 2**31 + 11
TINY = {"config": {"clip_seconds": 0.4, "clips_per_request": 1},
        "traffic": {"distinct_clips": 2}}


def _port_spec():
    from mrcaudiocodec_tpu_torch.config import CodecConfig as PortConfig
    from mrcaudiocodec_tpu_torch.spec import codec
    return PortConfig, codec


@pytest.mark.parametrize("case", [
    ("music", dict(fs=44100, channels=2, bitrate=128000)),
    ("tones", dict(fs=48000, channels=1, bitrate=96000,
                   window_switching=False, window="kbd")),
])
def test_reference_equals_the_frozen_and_the_port_spec(case):
    # runner == the frozen spec codec (the reference's own definition,
    # whole clip at a time) == the codec package's spec today
    generator, kw = case
    PortConfig, port = _port_spec()
    clips = gen.clips(generator, kw["fs"], 0.6, kw["channels"], SEED, 2)
    streams = runner.encode_clips(clips, CodecConfig(**kw), workers=2)
    pcm = runner.decode_streams(streams, workers=2)
    for x, s, p in zip(clips, streams, pcm):
        xf = x.astype(np.float32) / 32768
        want = frozen.encode(xf, CodecConfig(**kw))
        assert s == want == port.encode(xf, PortConfig(**kw))
        y, _ = frozen.decode(want)
        assert np.array_equal(y, port.decode(want)[0])
        assert p.dtype == np.int16 and np.array_equal(p, runner.to_i16(y))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield 0, a.name
        elif isinstance(node, ast.ImportFrom):
            yield node.level, node.module or ""


def test_reference_imports_numpy_and_the_standard_library_only():
    allowed = set(sys.stdlib_module_names) | {"numpy", "__future__"}
    files = [os.path.join(d, f) for d, _, fs in os.walk(REF)
             for f in fs if f.endswith(".py")]
    assert len(files) >= 15
    for path in files:
        for level, mod in _imports(path):
            if level == 0:
                assert mod.split(".")[0] in allowed, (path, mod)
    # what importing the reference adds to what the interpreter started with
    code = ("import sys; t = lambda: {m.split('.')[0] for m in sys.modules}; "
            "a = t(); import mrcbench.reference.runner, "
            "mrcbench.reference.spec.codec; print(' '.join(sorted(t() - a)))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    added = set(out.stdout.split())
    assert "mrcbench" in added
    assert not added & FORBIDDEN
    assert added <= allowed | {"mrcbench"} | {
        m for m in added if m.startswith("_")}, added - allowed


@pytest.mark.parametrize("cell", ["clip30s.encode", "corpus64.encode",
                                  "clip30s.decode"])
def test_the_control_is_not_correct(cell):
    over = {"config": dict(TINY["config"]), "traffic": TINY["traffic"]}
    if cell.startswith("corpus"):
        over["config"]["clips_per_request"] = 3
    checks = control_checks(Load(Catalog().cell(cell), SEED, over),
                            workers=2)
    assert checks["wrong_streams"][0] > 0
    if cell.endswith("decode"):
        assert checks["wrong_pcm"][0] > 0 and checks["pcm_diff_max"][0] > 0
    assert not all(v <= lim for v, lim in checks.values())


@pytest.mark.parametrize("cell", ["clip30s.encode", "corpus64.encode",
                                  "clip30s.decode"])
def test_the_same_seed_gives_the_same_inputs(cell):
    over = {"config": dict(TINY["config"]), "traffic": TINY["traffic"]}
    if cell.startswith("corpus"):
        over["config"]["clips_per_request"] = 3
    a, b, other = (Load(Catalog().cell(cell), s, over)
                   for s in (SEED, SEED, SEED + 1))
    assert a.checked == b.checked
    # the mix fixes the clips: every seed sends the same work
    assert all(np.array_equal(x, y) for x, y in zip(a.base, other.base))
    for c in (0, 1, 7, 2**20 + 3):
        for j in a.checked:
            assert np.array_equal(a.content(c, j), b.content(c, j))
            assert not np.array_equal(a.content(c, j), other.content(c, j))
