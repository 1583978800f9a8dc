"""The port's own NumPy spec codec (mrcaudiocodec_tpu_torch/spec/) against
the JAX package's spec, bitwise: whole streams and decodes on the goldens,
each copied xmath/xpsy function on seeded inputs (the JAX one called with
xp=np), the batched stages on seeded frames; the port's torch encode on
the CPU against the port's spec; and the spec importing neither torch nor
JAX.
"""
import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu import xmath as jxmath
from mrcaudiocodec_tpu import xpsy as jxpsy
from mrcaudiocodec_tpu.config import CodecConfig as JCfg
from mrcaudiocodec_tpu.spec import codec as jcodec
from mrcaudiocodec_tpu.spec import dsp as jdsp
from mrcaudiocodec_tpu.spec import psycho as jpsycho
from mrcaudiocodec_tpu.spec import rd as jrd
from mrcaudiocodec_tpu.spec import reservoir as jreservoir

from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec
from mrcaudiocodec_tpu_torch.spec import codec as pcodec
from mrcaudiocodec_tpu_torch.spec import dsp, psycho, rd, reservoir
from mrcaudiocodec_tpu_torch.spec import xmath_np, xpsy_np

from tests.test_conformance import make_clip
from tests.test_golden import GOLDEN, make_golden_clip
from tests.test_spec_batching import _frames_with_types
from tests.test_xpsy_fastpath import _adversarial_f32

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_bitwise(a, b, where="out"):
    """Equal values, dtypes and shapes, floats compared as bit patterns,
    through tuples, lists and dicts."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            assert_bitwise(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_bitwise(x, y, f"{where}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f":
            a = a.view(np.dtype(f"i{a.dtype.itemsize}"))
            b = b.view(np.dtype(f"i{b.dtype.itemsize}"))
        np.testing.assert_array_equal(a, b, where)


@pytest.mark.parametrize("name,fs,ch,br,kw,digest", GOLDEN,
                         ids=[g[0] for g in GOLDEN])
def test_golden_stream_and_decode_equal_jax_spec(name, fs, ch, br, kw,
                                                 digest):
    x = make_golden_clip(fs, 0.7, ch)
    bs = pcodec.encode(x, CodecConfig(fs=fs, channels=ch, bitrate=br, **kw))
    want = jcodec.encode(x, JCfg(fs=fs, channels=ch, bitrate=br, **kw))
    assert bs == want
    assert hashlib.sha256(bs).hexdigest() == digest
    y, cfg = pcodec.decode(bs)
    y_want, cfg_want = jcodec.decode(want)
    assert_bitwise(y, y_want)
    assert cfg == CodecConfig(fs=fs, channels=ch, bitrate=br, **kw)


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _spectrum(rng, *shape):
    """Power-spectrum-like positive f32 values over 12 decades."""
    return (10.0 ** rng.uniform(-8, 4, shape)).astype(np.float32)


def _band_inputs(rng, fs, long_block):
    nb = jxpsy.psy_tables(fs, long_block)["nb"]
    lead = (5,) if long_block else (5, 8)
    return _spectrum(rng, *lead, nb), _spectrum(rng, *lead, nb)


# each case: f(mod, rng) with mod the JAX module or the port's copy; both
# get the same seeded inputs
XMATH_CASES = {
    "_fft_stages": lambda m, rng: [m._fft_stages(n) for n in (4, 64, 512)],
    "_dct4_tables": lambda m, rng: [m._dct4_tables(n) for n in (128, 1024)],
    "_dif_tables": lambda m, rng: [m._dif_tables(n) for n in (64, 1024)],
    "_cmul": lambda m, rng: m._cmul(*(_f32(rng, 300) for _ in range(4)), np),
    "fft_stockham": lambda m, rng: [
        m.fft_stockham(_f32(rng, 3, n), _f32(rng, 3, n), np)
        for n in (2, 64, 512)],
    "dct_iv": lambda m, rng: [m.dct_iv(_f32(rng, 7, n, scale=s), np)
                              for n, s in ((1024, 1.0), (128, 1e-3),
                                           (1024, 3e4))],
    "_bitrev": lambda m, rng: m._bitrev(_f32(rng, 2, 3, 256), np),
    "fft_dif_stages": lambda m, rng: m.fft_dif_stages(
        _f32(rng, 4, 1024), _f32(rng, 4, 1024), np),
    "fft_dif": lambda m, rng: [m.fft_dif(_f32(rng, 4, n), _f32(rng, 4, n),
                                         np) for n in (128, 1024)],
}


def _thresholds(m, rng):
    out = []
    for fs in (44100, 48000, 32000):
        for long_block, bins in ((True, 1024), (False, 128)):
            cst = m.psy_tables(fs, long_block)
            lead = (6,) if long_block else (6, 8)
            p = _spectrum(rng, *lead, bins)
            p[0] = 0.0                      # a silent block
            for full in (True, False):
                out.append(m.block_thresholds(p, cst, full, np))
    return out


XPSY_CASES = {
    "xlog2": lambda m, rng: m.xlog2(
        (lambda x: x[x >= np.float32(2.0 ** -126)])(_adversarial_f32(rng)),
        np),
    "xsqrt": lambda m, rng: [m.xsqrt(_adversarial_f32(rng), np),
                             m.xsqrt(np.abs(_f32(rng, 64, 2, 32))[::2, 1,
                                                                   ::3], np)],
    "xexp2": lambda m, rng: m.xexp2(np.concatenate([
        rng.uniform(-126, 126, 100000).astype(np.float32),
        np.array([0.0, -0.5, 0.5, 125.9, -125.9], np.float32)]), np),
    "seg_scan_and_sums": lambda m, rng: [
        m.seg_sums_clamped(_spectrum(rng, 9, 1024), tuple(
            int(v) for v in T.unified_layout(fs)["edges"][bt]), np)
        for fs in (44100, 48000, 32000) for bt in (0, 2)],
    "tree_sum": lambda m, rng: [m.tree_sum(_spectrum(rng, 5, n), np)
                                for n in (1, 7, 49, 64)],
    "rfft_power": lambda m, rng: [m.rfft_power(_f32(rng, 3, n), np)
                                  for n in (2048, 256)] + [
        m.rfft_power(_f32(rng, 2, 8, 256), np)],
    "hann": lambda m, rng: [m.hann(n) for n in (256, 2048)],
    "psy_tables": lambda m, rng: [m.psy_tables(fs, lb)
                                  for fs in (44100, 48000, 32000)
                                  for lb in (True, False)],
    "spread_apply": lambda m, rng: m.spread_apply(
        _spectrum(rng, 4, 30), _spectrum(rng, 30, 30), np),
    "block_thresholds": _thresholds,
    "band_pe_groups_pe": lambda m, rng: [
        m.band_pe(*_band_inputs(rng, 44100, True),
                  m.psy_tables(44100, True)["width"], np),
        m.groups_pe(*_band_inputs(rng, 48000, False),
                    m.psy_tables(48000, False)["width"], np)],
    "transient_detect": lambda m, rng: m.transient_detect(
        np.concatenate([_f32(rng, 40, 2048, scale=1e-3),
                        np.repeat(_f32(rng, 40, 128), 16, axis=1),
                        np.zeros((2, 2048), np.float32)]), np),
    "allowed_noise": lambda m, rng: m.allowed_noise(
        _spectrum(rng, 50, 60), _spectrum(rng, 50, 60),
        _spectrum(rng, 50, 60), np),
    "constants": lambda m, rng: [m.TINY, m.SFM_FLOOR_REL, m.ATTACK_RATIO,
                                 m.ATTACK_ABS, m.ATTACK_EPS, m.N_SUB,
                                 m.SMR_FLOOR, m.SMR_CEIL],
}


@pytest.mark.parametrize("name", sorted(XMATH_CASES))
def test_xmath_np_equals_jax_xmath(name):
    f = XMATH_CASES[name]
    assert_bitwise(f(xmath_np, np.random.default_rng(7)),
                   f(jxmath, np.random.default_rng(7)), name)


@pytest.mark.parametrize("name", sorted(XPSY_CASES))
def test_xpsy_np_equals_jax_xpsy(name):
    f = XPSY_CASES[name]
    assert_bitwise(f(xpsy_np, np.random.default_rng(11)),
                   f(jxpsy, np.random.default_rng(11)), name)


@pytest.fixture(scope="module")
def staged():
    """Seeded frames with both block families, through the JAX spec's
    stages: {frames, bt, coeffs, allowed, pe, budgets}."""
    frames, bt = _frames_with_types(seconds=0.6, seed=5)
    assert (bt == 2).any() and (bt != 2).any()
    coeffs = jdsp.analyze_frames(frames, bt, "sine")
    allowed, pe, _ = jpsycho.analyze_frames(frames, coeffs, bt, 44100, True)
    budgets = jreservoir.allocate(pe, JCfg(fs=44100, channels=1,
                                           bitrate=96000))
    return dict(frames=frames, bt=bt, coeffs=coeffs, allowed=allowed, pe=pe,
                budgets=budgets)


def test_dsp_stages_equal_jax_spec(staged):
    x = _frames_with_types(seconds=0.6, seed=5)[0][:, 1024:].reshape(-1)
    assert_bitwise(dsp.frame_signal(x), jdsp.frame_signal(x))
    tr = dsp.detect_transients(staged["frames"])
    assert_bitwise(tr, jdsp.detect_transients(staged["frames"]))
    for ws in (True, False):
        assert_bitwise(dsp.block_types(tr, ws), jdsp.block_types(tr, ws))
    for window in ("sine", "kbd"):
        got = dsp.analyze_frames(staged["frames"], staged["bt"], window)
        assert_bitwise(got, jdsp.analyze_frames(staged["frames"],
                                                staged["bt"], window))
    for bt in range(5):
        assert_bitwise(dsp.synthesize_frame(staged["coeffs"][3], bt, "kbd"),
                       jdsp.synthesize_frame(staged["coeffs"][3], bt, "kbd"))


@pytest.mark.parametrize("full_psycho", [True, False])
def test_psycho_analyze_frames_equals_jax_spec(staged, full_psycho):
    for fs in (44100, 48000):
        args = (staged["frames"], staged["coeffs"], staged["bt"], fs,
                full_psycho)
        assert_bitwise(psycho.analyze_frames(*args),
                       jpsycho.analyze_frames(*args))


def test_rd_frames_equals_jax_spec(staged):
    args = (staged["coeffs"], staged["allowed"], staged["budgets"],
            staged["bt"], 44100)
    assert_bitwise(rd.rd_frames(*args), jrd.rd_frames(*args))


@pytest.mark.parametrize("reservoir_on", [True, False])
def test_reservoir_allocate_equals_jax_spec(staged, reservoir_on):
    for br in (64000, 96000, 192000):
        got = reservoir.allocate(staged["pe"], CodecConfig(
            fs=44100, channels=1, bitrate=br, reservoir=reservoir_on))
        want = jreservoir.allocate(staged["pe"], JCfg(
            fs=44100, channels=1, bitrate=br, reservoir=reservoir_on))
        assert_bitwise(got, want)


@pytest.mark.parametrize("fs,channels,bitrate,kw", [
    (44100, 2, 128000, {}),
    (48000, 1, 64000, {"window": "kbd", "reservoir": False}),
], ids=["44k_stereo_128k", "48k_mono_64k_kbd"])
def test_torch_encode_on_cpu_equals_port_spec(fs, channels, bitrate, kw):
    x = make_clip(fs, 0.5, channels, seed=2)
    cfg = CodecConfig(fs=fs, channels=channels, bitrate=bitrate, **kw)
    bs = codec.encode(x, cfg, device="cpu")
    assert bs == pcodec.encode(x, cfg)
    y, _ = codec.decode(bs, device="cpu")
    assert_bitwise(y, pcodec.decode(bs)[0])


SPEC_IMPORTS = """
import pkgutil, importlib, sys
import mrcaudiocodec_tpu_torch.spec as spec
names = [m.name for m in pkgutil.iter_modules(spec.__path__)]
for n in names:
    importlib.import_module("mrcaudiocodec_tpu_torch.spec." + n)
assert {"codec", "xmath_np", "xpsy_np"} <= set(names), names
bad = [m for m in sys.modules if m.split(".")[0] in ("torch", "jax",
                                                      "mrcaudiocodec_tpu")]
assert not bad, bad
"""


def test_spec_imports_neither_torch_nor_jax():
    subprocess.run([sys.executable, "-c", SPEC_IMPORTS], cwd=REPO,
                   check=True, timeout=120)
