"""P1 and P2: the quantizer with native IEEE divide and square root.

Counterpart of scripts/tpu_quant_g32.py, three phases, finest last:
  1. K2 (the quantization-cost kernel, through `rd.bits_for_gains` minus
     `entropy.fixed_and_sf_bits`) against its plain version at five gain
     sets -> which (frame, gain) entries disagree;
  2. the magnitude probe P1 (`mag_probe`: quantized magnitudes of one gain
     column with native divide and sqrt) against the normative rev-4
     quantizer `|quantize.quantize|` at the gains phase 1 flags, else at
     0, 8, 128 and 248 -> which bins disagree, at which (x, e). These
     mismatches measure native IEEE against the pinned chain; they are
     reported, not asserted;
  3. the op probe P2 (`op_probe`: |x| / s, sqrt, sqrt(a * sqrt(a))) on the
     flagged (x, e) pairs, else on an 8192-pair sweep, against torch eager:
     the plain version on the device and on the CPU, and PyTorch's float32
     `torch.sqrt` on the CPU.

The plain versions take the square root through float64 (`ieee_sqrt`):
PyTorch's float32 `torch.sqrt` on the CPU is not correctly rounded for
every input (phase 3 counts where it differs), while the card's is, as
IEEE asks and as the kernels' sqrtf is.

    python -m mrcaudiocodec_tpu_torch.probes.quant_g32 [--device cpu]
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import config as C
from .. import tables as T
from ..ops import dsp, entropy, quantize, rd
from ..ops.kernels import quant_cost
from . import check_args, cfn, cli, launch, log, pick

FS = 44100
NF = 256
SWEEP = 8192
GAIN_SETS = (
    ("G=8 mid (40..47)", np.arange(40, 48)),
    ("G=8 low (0..7)", np.arange(0, 8)),
    ("G=8 high (248..255)", np.arange(248, 256)),
    ("G=16 (64..184 step 8)", np.arange(64, 192, 8)),
    ("G=32 coarse (0..248 step 8)",
     np.arange(C.GAIN_MIN, C.GAIN_MAX + 1, C.GAIN_COARSE_STEP)),
)
I32 = torch.int32

launches = {"mag_probe": 0, "op_probe": 0}


def make_inputs(seed: int = 0, nf: int = NF, device="cpu"):
    """(coeffs [nf,1024] f32, amp [nf,NB] i32, bt [nf] i32) on `device`,
    drawn as the script draws them (the MDCT runs K1 on the card)."""
    rng = np.random.default_rng(seed)
    fr = (0.3 * rng.standard_normal((nf, C.LONG_SIZE))).astype(np.float32)
    bt = rng.integers(0, 5, nf).astype(np.int32)
    nb = T.unified_layout(FS)["nb"]
    amp = (rng.integers(0, C.AMP_MAX // C.AMP_STEP + 1, (nf, nb))
           * C.AMP_STEP).astype(np.int32)
    bt_t = torch.from_numpy(bt).to(device)
    coeffs = dsp.analyze(torch.from_numpy(fr).to(device), bt_t).contiguous()
    return coeffs, torch.from_numpy(amp).to(device), bt_t


def ieee_sqrt(a):
    """Correctly rounded float32 square root of float32 `a`: the float64
    root rounded once more to float32, which is exact (53 >= 2 * 24 + 2
    bits, so the second rounding cannot move the result)."""
    return torch.sqrt(a.double()).float()


# ---------------------------------------------------------------------------
# P1: magnitudes of one gain column
# ---------------------------------------------------------------------------


def mag_probe_plain(x, amp_bin, gains):
    """[F,1024] f32, [F,1024] i32, [F,G] i32 (column 0 used) -> [F,1024]
    i32 min(floor(sqrt(a*sqrt(a)) + MAGIC), QMAX), a = |x| / step."""
    e = torch.clamp(gains[:, :1] - amp_bin, C.GAIN_MIN, C.GAIN_MAX)
    d = e - C.GAIN_BIAS
    frac = quantize._fracs(str(x.device))[0][d & 3]
    two_k = (((d >> 2) + 127) << 23).view(torch.float32)
    a = torch.abs(x) / (frac * two_k)
    p = ieee_sqrt(a * ieee_sqrt(a))
    mag = torch.clamp(torch.floor(p + quantize.QUANT_MAGIC),
                      max=float(C.QMAX))
    return mag.to(I32)


@functools.lru_cache(maxsize=1)
def _mag_fn():
    return cfn("probe_quant_g32", "mrc_probe_mag",
               [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_float] * 4
               + [ctypes.c_void_p, ctypes.c_longlong])


def mag_probe_kernel(x, amp_bin, gains):
    """Launch P1 on CUDA tensors; same contract as mag_probe_plain."""
    nf = x.shape[0]
    check_args("mag_probe", [(x, torch.float32, (nf, C.LONG_COEFFS)),
                             (amp_bin, I32, (nf, C.LONG_COEFFS)),
                             (gains, I32, (nf, None))])
    if gains.shape[1] < 1:
        raise ValueError("mag_probe: gains needs at least one column")
    out = torch.empty((nf, C.LONG_COEFFS), dtype=I32, device=x.device)
    if nf:
        f = quantize.FRACS
        launch("mag_probe", _mag_fn(), x.data_ptr(), amp_bin.data_ptr(),
               gains.data_ptr(), gains.shape[1], float(f[1]), float(f[2]),
               float(f[3]), quantize.QUANT_MAGIC, out.data_ptr(), nf,
               device=x.device)
        launches["mag_probe"] += 1
    return out


def mag_probe(x, amp_bin, gains):
    return pick(x, mag_probe_kernel, mag_probe_plain)(x, amp_bin, gains)


# ---------------------------------------------------------------------------
# P2: the elementwise ops
# ---------------------------------------------------------------------------


def op_probe_plain(x, s):
    """x, s [R, 256] f32 -> (|x| / s, sqrt(a), sqrt(a * sqrt(a)))."""
    a = torch.abs(x) / s
    return a, ieee_sqrt(a), ieee_sqrt(a * ieee_sqrt(a))


@functools.lru_cache(maxsize=1)
def _op_fn():
    return cfn("probe_quant_g32", "mrc_probe_ops",
               [ctypes.c_void_p] * 5 + [ctypes.c_longlong])


def op_probe_kernel(x, s):
    """Launch P2 on CUDA tensors; same contract as op_probe_plain."""
    check_args("op_probe", [(x, torch.float32, (None, 256)),
                            (s, torch.float32, tuple(x.shape))])
    outs = tuple(torch.empty_like(x) for _ in range(3))
    if x.numel():
        launch("op_probe", _op_fn(), x.data_ptr(), s.data_ptr(),
               *(o.data_ptr() for o in outs), x.numel(), device=x.device)
        launches["op_probe"] += 1
    return outs


def op_probe(x, s):
    return pick(x, op_probe_kernel, op_probe_plain)(x, s)


BODIES = {"mag_probe": (mag_probe_kernel, mag_probe_plain),
          "op_probe": (op_probe_kernel, op_probe_plain)}


def sweep_pairs(n: int = SWEEP):
    """The script's synthetic (x, e) sweep (seed 1)."""
    rng = np.random.default_rng(1)
    xs = (0.3 * rng.standard_normal(n)).astype(np.float32)
    es = rng.integers(0, 256, xs.size).astype(np.int32)
    return list(zip(xs.tolist(), es.tolist()))


def op_inputs(pairs, device):
    """(x, e) pairs -> X, S [R, 256] f32 on `device` (zero-padded)."""
    n = -(-max(256, len(pairs)) // 256) * 256
    xs = np.zeros(n, np.float32)
    es = np.zeros(n, np.int32)
    for i, (xv, ev) in enumerate(pairs[:n]):
        xs[i], es[i] = xv, ev
    steps = quantize.band_steps(torch.from_numpy(es))
    return (torch.from_numpy(xs.reshape(-1, 256)).to(device),
            steps.reshape(-1, 256).contiguous().to(device))


def body_inputs(device, rows: int = NF):
    """P1 at gain 128 on `rows` frames of make_inputs; P2 on the sweep."""
    coeffs, amp, bt = make_inputs(nf=rows, device=device)
    amp_bin = entropy.amp_to_bins(amp, bt, FS).contiguous()
    gains = torch.full((rows, 8), 128, dtype=I32, device=device)
    return {"mag_probe": (coeffs, amp_bin, gains),
            "op_probe": op_inputs(sweep_pairs(), device)}


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------


def phase1(coeffs, amp, bt):
    log("== phase 1: payload bits, K2 vs its plain version ==")
    nf = coeffs.shape[0]
    amp_bin = entropy.amp_to_bins(amp, bt, FS).contiguous()
    fixed = entropy.fixed_and_sf_bits(amp, bt, FS)[:, None]
    bad, counts = [], {}
    for name, gains_np in GAIN_SETS:
        g = len(gains_np)
        gains = torch.from_numpy(np.broadcast_to(
            gains_np.astype(np.int32)[None, :], (nf, g)).copy()).to(
            coeffs.device)
        got = (rd.bits_for_gains(coeffs, amp, gains, bt, FS, amp_bin)
               - fixed).cpu().numpy()
        ref = quant_cost.payload_bits_plain(coeffs, amp_bin, gains, bt,
                                            FS).cpu().numpy()
        neq = ref != got
        counts[name] = int(neq.sum())
        log(f"{name}: mismatches {counts[name]}/{neq.size}")
        fi, gi = np.nonzero(neq)
        for f, gg in list(zip(fi.tolist(), gi.tolist()))[:6]:
            log(f"  frame {f} bt={int(bt[f])} gain {int(gains_np[gg])}: "
                f"plain {ref[f, gg]} kernel {got[f, gg]}")
            bad.append((f, int(gains_np[gg])))
    return bad, counts


def phase2(coeffs, amp, bt, bad_entries):
    log("== phase 2: magnitude probe (native IEEE) vs |quantize| (rev 4) ==")
    nf = coeffs.shape[0]
    amp_bin = entropy.amp_to_bins(amp, bt, FS).contiguous()
    x = coeffs.cpu().numpy()
    pairs, counts = [], {}
    for gv in (sorted({g for _, g in bad_entries}) or [0, 8, 128, 248])[:4]:
        gains = torch.full((nf, 8), gv, dtype=I32, device=coeffs.device)
        e_bin = torch.clamp(gv - amp_bin, C.GAIN_MIN, C.GAIN_MAX)
        mag_k = mag_probe(coeffs, amp_bin, gains).cpu().numpy()
        mag_x = torch.abs(quantize.quantize(coeffs, e_bin)).cpu().numpy()
        e_np = e_bin.cpu().numpy()
        neq = mag_k != mag_x
        counts[gv] = int(neq.sum())
        log(f"gain {gv}: mag mismatches {counts[gv]}/{neq.size}")
        fi, bi = np.nonzero(neq)
        for f, b in list(zip(fi.tolist(), bi.tolist()))[:8]:
            log(f"  f={f} bin={b} x={x[f, b]!r} e={e_np[f, b]} "
                f"probe={mag_k[f, b]} rev4={mag_x[f, b]}")
            pairs.append((float(x[f, b]), int(e_np[f, b])))
    return pairs, counts


def phase3(pairs, device):
    log("== phase 3: elementwise ops, probe vs torch eager ==")
    if not pairs:
        pairs = sweep_pairs()
    X, S = op_inputs(pairs, device)
    got = op_probe(X, S)
    xc, sc = X.cpu(), S.cpu()
    a = torch.abs(xc) / sc
    refs = {f"plain on {X.device.type}": op_probe_plain(X, S),
            "plain on the CPU": op_probe_plain(xc, sc),
            "float32 torch.sqrt on the CPU": (a, torch.sqrt(a),
                                              torch.sqrt(a * torch.sqrt(a)))}
    counts = {}
    for i, name in enumerate(("divide", "sqrt", "p=sqrt(a*sqrt(a))")):
        kb = got[i].cpu().numpy().view(np.uint32)
        counts[name] = {
            ref: int((kb != r[i].cpu().numpy().view(np.uint32)).sum())
            for ref, r in refs.items()}
        log(f"{name}: bit mismatches of {kb.size}: " + ", ".join(
            f"vs {ref} {n}" for ref, n in counts[name].items()))
    return counts


def run(device) -> dict:
    coeffs, amp, bt = make_inputs(device=device)
    bad, c1 = phase1(coeffs, amp, bt)
    pairs, c2 = phase2(coeffs, amp, bt, bad)
    c3 = phase3(pairs, device)
    return {"phase1": c1, "phase2": c2, "phase3": c3}


def main(argv=None):
    cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
