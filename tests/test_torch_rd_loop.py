"""The RD loop of the port (ops/rd.py) against the JAX package and the
spec, bitwise, on the CPU; and a per-frame model of K4's schedule.

`rd.rd_batch` on CPU tensors runs the inner sweep and the plain loop
`rd_loop_plain`; its outputs must equal the JAX `ops/rd.rd_batch` and the
spec's `rd_frames` at 32, 44.1 and 48 kHz, on music frames and on the
corners K4 must get right: starved budgets (the GAIN_MAX fallback),
all-SHORT frames, silent pad frames with budget 0, frames that run every
outer iteration. Each case asserts that its corner was reached, from
the plain loop's own counts (`rd.loop_counts`). AMP_MAX cannot bind: the
loop's 7 refine iterations raise a band's amp by at most 14 < 24
(asserted).

K4's schedule, modelled one frame at a time, is held to `rd_batch` on
these corner sets in tests/test_torch_kernel_layout.py (`k4_model`).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mrcaudiocodec_tpu.config import CodecConfig as JCfg
from mrcaudiocodec_tpu.ops import rd as jrd
from mrcaudiocodec_tpu.spec import dsp as sdsp
from mrcaudiocodec_tpu.spec import psycho as spsy
from mrcaudiocodec_tpu.spec import rd as srd
from mrcaudiocodec_tpu.spec import reservoir as sres

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch.ops import rd

torch.set_num_threads(1)

KINDS = ("music", "adversarial", "starved", "all_short", "silent_pad",
         "outer_max")


def _music(fs, seconds, seed, all_short=False):
    rng = np.random.default_rng(seed)
    n = int(fs * seconds)
    t = np.arange(n) / fs
    x = (0.4 * np.sin(2 * np.pi * 440 * t)
         + 0.15 * np.sin(2 * np.pi * 3000 * t)
         + 0.02 * rng.standard_normal(n)).astype(np.float32)
    for pos in range(fs // 8, n - 200, fs // 6):
        x[pos:pos + 64] += (0.7 * rng.standard_normal(64)).astype(np.float32)
    frames = sdsp.frame_signal(np.clip(x, -1, 1))
    bt = sdsp.block_types(sdsp.detect_transients(frames), True)
    if all_short:
        bt = np.full_like(bt, C.SHORT)
    coeffs = sdsp.analyze_frames(frames, bt, "sine")
    allowed, pe, _ = spsy.analyze_frames(frames, coeffs, bt, fs, True)
    return coeffs, allowed, pe, bt


def _adversarial(fs):
    """tests/test_spec_batching.py's corners: starved and lavish budgets,
    zero and huge allowed noise, silent and loud flat frames."""
    rng = np.random.default_rng(7)
    nf = 24
    nb = T.unified_layout(fs)["nb"]
    coeffs = (rng.standard_normal((nf, C.LONG_COEFFS)).astype(np.float32)
              * np.float32(40.0))
    coeffs[0] = 0.0
    coeffs[1] = np.float32(3000.0)
    bt = rng.integers(0, 5, nf).astype(np.int32)
    allowed = np.abs(rng.standard_normal((nf, nb))).astype(np.float32)
    allowed[2] = 0.0
    allowed[3] = np.float32(1e30)
    budgets = rng.integers(60, 6000, nf).astype(np.int64)
    budgets[4] = 40
    budgets[5] = 10 ** 6
    return coeffs, allowed, budgets, bt


def rd_case(kind, fs):
    """(coeffs, allowed, budgets, bt) of one corner set."""
    if kind == "adversarial":
        return _adversarial(fs)
    coeffs, allowed, pe, bt = _music(fs, 0.3, fs % 97,
                                     all_short=kind == "all_short")
    rate = {"starved": 16000, "outer_max": 96000}.get(kind, 128000)
    budgets = sres.allocate(pe, JCfg(fs=fs, channels=2, bitrate=rate))
    if kind == "outer_max":
        allowed = (allowed * np.float32(1e-6)).astype(np.float32)
    if kind == "silent_pad":
        # the corpus batch's pad frames: silence, budget 0, no noise allowed
        pad = np.arange(len(bt)) % 3 == 1
        coeffs = np.where(pad[:, None], np.float32(0.0), coeffs)
        allowed = np.where(pad[:, None], np.float32(0.0), allowed)
        budgets = np.where(pad, 0, budgets)
        bt = np.where(pad, C.LONG, bt)
    return (coeffs.astype(np.float32), allowed.astype(np.float32),
            np.asarray(budgets, np.int64), np.asarray(bt, np.int32))


def loop_inputs(coeffs, allowed, budgets, bt, fs):
    """rd_batch's own inputs to rd_loop: x, allowed, budget_content, bt and
    the inner sweep's gain0, bits0 (torch, CPU)."""
    x = torch.from_numpy(coeffs)
    nb = T.unified_layout(fs)["nb"]
    btt = torch.from_numpy(bt)
    bc = (torch.from_numpy(budgets) - C.FRAME_LEN_BITS - 7).to(torch.int32)
    zeros = torch.zeros((len(bt), nb), dtype=torch.int32)
    gain0, bits0 = rd.inner_gain_search(
        x, zeros, bc, btt, fs, torch.zeros((len(bt), C.LONG_COEFFS),
                                           dtype=torch.int32))
    return x, torch.from_numpy(allowed), bc, btt, gain0, bits0


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_rd_batch_matches_spec_at_each_corner(fs, kind):
    coeffs, allowed, budgets, bt = rd_case(kind, fs)
    got = rd.rd_batch(torch.from_numpy(coeffs), torch.from_numpy(allowed),
                      torch.from_numpy(budgets), torch.from_numpy(bt), fs)
    ref = srd.rd_frames(coeffs, allowed, budgets, bt, fs)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), r)
    # the corner was reached (the plain loop's own counts)
    st = rd.loop_counts(*loop_inputs(coeffs, allowed, budgets, bt, fs), fs)
    outer = st["outer"].numpy()
    assert (st["over_masks"].numpy() == outer + 1).all()
    assert (outer >= 0).all() and (outer <= C.OUTER_MAX - 1).all()
    assert outer.max() > 0                       # the loop ran
    amp = got[1].numpy()
    if kind in ("adversarial", "starved"):
        assert st["fallbacks"].sum() > 0
        assert (got[2].numpy()[st["fallbacks"].numpy() > 0]
                == C.GAIN_MAX).all()
    if kind == "all_short":
        assert (bt == C.SHORT).all()
    if kind == "silent_pad":
        pad = budgets == 0
        assert pad.sum() >= 3
        assert (outer[pad] == 0).all() and (got[2].numpy()[pad] == 255).all()
        assert (got[0].numpy()[pad] == 0).all() and (amp[pad] == 0).all()
    if kind in ("adversarial", "outer_max"):
        at_max = outer == C.OUTER_MAX - 1
        assert at_max.any()
        assert amp.max() == C.AMP_STEP * (C.OUTER_MAX - 1)


@pytest.mark.parametrize("fs", [32000, 44100, 48000])
def test_rd_batch_matches_jax_on_every_corner(fs):
    """Every corner set of this rate in one batch (the JAX rd_batch
    compiles once a call): rows are independent, so this holds each."""
    cases = [rd_case(kind, fs) for kind in KINDS]
    coeffs, allowed, budgets, bt = (np.concatenate([c[i] for c in cases])
                                    for i in range(4))
    got = rd.rd_batch(torch.from_numpy(coeffs), torch.from_numpy(allowed),
                      torch.from_numpy(budgets), torch.from_numpy(bt), fs)
    jax_out = jrd.rd_batch(jnp.asarray(coeffs), jnp.asarray(allowed),
                           jnp.asarray(budgets.astype(np.int32)),
                           jnp.asarray(bt), fs)
    for g, r in zip(got, jax_out):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_amp_max_is_out_of_the_loops_reach():
    """7 refine iterations of AMP_STEP: the clamp at AMP_MAX never binds."""
    assert C.AMP_STEP * (C.OUTER_MAX - 1) < C.AMP_MAX


def test_plain_loop_counts_what_a_frame_does():
    """The counts are per frame: a frame that never goes over costs no
    candidate; a frame's candidates are 4 a block until its first fit,
    +1 for the fallback, over its own iterations."""
    fs = 44100
    args = loop_inputs(*rd_case("adversarial", fs), fs)
    st = rd.loop_counts(*args, fs)
    outer, cands = st["outer"].numpy(), st["cands"].numpy()
    fall = st["fallbacks"].numpy()
    assert ((outer == 0) == (cands == 0)).all()
    assert (cands >= 4 * outer).all() and (cands <= 17 * outer).all()
    assert ((cands - fall) % 4 == 0).all()
    assert (fall <= outer).all()
