"""P4: the cut-down pieces of the quantization-cost kernel.

Counterpart of scripts/tpu_quant_bisect.py, whose five Pallas kernels were
pieces of the TPU quantization-cost kernel, cut down to find which piece
the remote Mosaic compiler refused. That question has no meaning on the
card; the values the pieces compute do, and these are they (csrc/
probe_quant_bisect.cu), at the script's shapes (NF = 64 frames, gains
40..47, zero amplification, block type 0):
  v1  per gain, the sum of the rev-3 magnitudes (exp2 step, ** 0.75)
  v2  per gain, the sum of the CB_SMALL lengths of the clipped 4-tuples
  v3  the per-band sums of pair sums |x[2p]| + |x[2p+1]|, summed, as int
  v4  the sum of the CB_ESC pair lengths of min(int(min(|x|, 30)), 16)
  v5  the sum of escape suffix and sign bits of int(min(|x|*100, 4095))
The script imported helpers that the TPU kernel has since lost; what they
computed is a lookup: `_onehot_dot(sym, len_small, 81)` is
len_small[sym], `_esc_pair_dot(a, b, esc17)` is len_esc[a * 17 + b], and
`_masks(fs)[0]` is `unified_layout(fs)["mask2"]`.

    python -m mrcaudiocodec_tpu_torch.probes.quant_bisect [--device cpu]
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import config as C
from .. import tables as T
from .. import xpsy
from ..ops import quantize
from . import check_args, cfn, cli, launch, log, pick

NF = 64
FS = 44100
G = 8
I32 = torch.int32
F32 = torch.float32

launches = {"v1": 0, "v2": 0, "v3": 0, "v4": 0, "v5": 0}


def make_inputs(device, nf: int = NF):
    """(x [nf,1024] f32, amp_bin [nf,1024] i32, gains [nf,8] i32, bt [nf]
    i32) as the script makes them."""
    rng = np.random.default_rng(0)
    x = (10.0 * rng.standard_normal((nf, C.LONG_COEFFS))).astype(np.float32)
    gains = np.broadcast_to(np.arange(40, 48, dtype=np.int32)[None, :],
                            (nf, G)).copy()
    return (torch.from_numpy(x).to(device),
            torch.zeros((nf, C.LONG_COEFFS), dtype=I32, device=device),
            torch.from_numpy(gains).to(device),
            torch.zeros(nf, dtype=I32, device=device))


@functools.lru_cache(maxsize=None)
def tables(device: str):
    """len_small [81] i32, len_esc [289] i32, mask2 [5,512,nb] f32."""
    ca = T.code_arrays()
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)
    return {"len_small": t(ca["len_small"], np.int32),
            "len_esc": t(ca["len_esc"], np.int32),
            "mask2": t(T.unified_layout(FS)["mask2"], np.float32)}


def _broadcast(tot):
    """[F] -> [F, G]: the scripts' output block holds the frame's value in
    every column."""
    return tot[:, None].expand(tot.shape[0], G).contiguous()


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _mag(x, amp_bin, gains):
    """[F, G, 1024] i32 rev-3 magnitudes (exp2 step, ** 0.75)."""
    e = torch.clamp(gains[:, :, None] - amp_bin[:, None, :], C.GAIN_MIN,
                    C.GAIN_MAX)
    step = torch.exp2((e.to(F32) - C.GAIN_BIAS) / 4.0)
    p = torch.pow(torch.abs(x)[:, None, :] / step, 0.75)
    return torch.clamp(torch.floor(p + quantize.QUANT_MAGIC),
                       max=float(C.QMAX)).to(I32)


def v1_plain(x, amp_bin, gains):
    return _mag(x, amp_bin, gains).sum(-1, dtype=I32)


def v2_plain(x, amp_bin, gains, len_small):
    mag = _mag(x, amp_bin, gains)
    q = torch.where(x[:, None, :] < 0, -mag, mag)
    t4 = (torch.clamp(q, -1, 1) + 1).reshape(q.shape[:2] + (256, 4))
    sym = ((t4[..., 0] * 3 + t4[..., 1]) * 3 + t4[..., 2]) * 3 + t4[..., 3]
    return len_small[sym.long()].sum(-1, dtype=I32)


def v3_plain(x, bt, mask2):
    ax = torch.abs(x).reshape(x.shape[0], 512, 2)
    v = ax[..., 0] + ax[..., 1]                                  # [F, 512]
    band = xpsy.tree_sum((v[:, :, None] * mask2[bt.long()]).transpose(1, 2))
    return _broadcast(xpsy.tree_sum(band).to(I32))


def v4_plain(x, len_esc):
    mag = torch.clamp(torch.abs(x), max=30.0).to(I32)
    m2 = torch.clamp(mag, max=C.ESC_MAG).reshape(x.shape[0], 512, 2)
    bits = len_esc[(m2[..., 0] * (C.ESC_MAG + 1) + m2[..., 1]).long()]
    return _broadcast(bits.sum(-1, dtype=I32))


def v5_plain(x):
    mag = torch.clamp(torch.abs(x) * 100.0, max=4095.0).to(I32)
    e_esc = torch.full_like(mag, 4)
    for k in range(5, 13):
        e_esc = e_esc + (mag >= (1 << k)).to(I32)
    extra = (torch.where(mag >= C.ESC_MAG, 2 * e_esc - 3, 0)
             + (mag > 0).to(I32))
    return _broadcast(extra.sum(-1, dtype=I32))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@functools.lru_cache(maxsize=None)
def _fn(body: str):
    argtypes = {
        "v1": [_P, _P, _P, _I, ctypes.c_float, _P, _L],
        "v2": [_P, _P, _P, _I, ctypes.c_float, _P, _P, _L],
        "v3": [_P, _P, _P, _I, _I, _P, _L],
        "v4": [_P, _P, _I, _P, _L],
        "v5": [_P, _I, _P, _L],
    }[body]
    return cfn("probe_quant_bisect", f"mrc_probe_{body}", argtypes)


def _x_spec(x):
    return (x, F32, (x.shape[0], C.LONG_COEFFS))


def _gain_args(name, x, amp_bin, gains):
    nf = x.shape[0]
    check_args(name, [_x_spec(x), (amp_bin, I32, (nf, C.LONG_COEFFS)),
                      (gains, I32, (nf, None))])
    return torch.empty((nf, gains.shape[1]), dtype=I32, device=x.device)


def _done(name, out):
    launches[name] += 1
    return out


def v1_kernel(x, amp_bin, gains):
    out = _gain_args("v1", x, amp_bin, gains)
    if out.numel() == 0:
        return out
    launch("v1", _fn("v1"), x.data_ptr(), amp_bin.data_ptr(),
           gains.data_ptr(), gains.shape[1], quantize.QUANT_MAGIC,
           out.data_ptr(), x.shape[0], device=x.device)
    return _done("v1", out)


def v2_kernel(x, amp_bin, gains, len_small):
    out = _gain_args("v2", x, amp_bin, gains)
    check_args("v2", [(len_small, I32, (81,))])
    if out.numel() == 0:
        return out
    launch("v2", _fn("v2"), x.data_ptr(), amp_bin.data_ptr(),
           gains.data_ptr(), gains.shape[1], quantize.QUANT_MAGIC,
           len_small.data_ptr(), out.data_ptr(), x.shape[0], device=x.device)
    return _done("v2", out)


def _frame_out(x):
    return torch.empty((x.shape[0], G), dtype=I32, device=x.device)


def v3_kernel(x, bt, mask2):
    nf = x.shape[0]
    check_args("v3", [_x_spec(x), (bt, I32, (nf,)),
                      (mask2, F32, (C.N_BLOCK_TYPES, 512, None))])
    if not 0 < mask2.shape[2] <= 128:
        raise ValueError(f"v3: {mask2.shape[2]} bands, at most 128")
    out = _frame_out(x)
    if nf == 0:
        return out
    launch("v3", _fn("v3"), x.data_ptr(), bt.data_ptr(), mask2.data_ptr(),
           mask2.shape[2], G, out.data_ptr(), nf, device=x.device)
    return _done("v3", out)


def v4_kernel(x, len_esc):
    check_args("v4", [_x_spec(x), (len_esc, I32, (289,))])
    out = _frame_out(x)
    if x.shape[0] == 0:
        return out
    launch("v4", _fn("v4"), x.data_ptr(), len_esc.data_ptr(), G,
           out.data_ptr(), x.shape[0], device=x.device)
    return _done("v4", out)


def v5_kernel(x):
    check_args("v5", [_x_spec(x)])
    out = _frame_out(x)
    if x.shape[0] == 0:
        return out
    launch("v5", _fn("v5"), x.data_ptr(), G, out.data_ptr(), x.shape[0],
           device=x.device)
    return _done("v5", out)


BODIES = {"v1": (v1_kernel, v1_plain), "v2": (v2_kernel, v2_plain),
          "v3": (v3_kernel, v3_plain), "v4": (v4_kernel, v4_plain),
          "v5": (v5_kernel, v5_plain)}


def body_inputs(device, rows: int = NF):
    x, amp_bin, gains, bt = make_inputs(device, rows)
    tb = tables(str(torch.device(device)))
    return {"v1": (x, amp_bin, gains),
            "v2": (x, amp_bin, gains, tb["len_small"]),
            "v3": (x, bt, tb["mask2"]),
            "v4": (x, tb["len_esc"]),
            "v5": (x,)}


def run(device) -> dict:
    """Each body once through its wrapper (the kernel on the card, the
    plain version on the CPU). -> {body: [NF, 8] int32 numpy}."""
    out = {}
    for name, args in body_inputs(device).items():
        kernel, plain = BODIES[name]
        got = pick(args[0], kernel, plain)(*args).cpu().numpy()
        out[name] = got
        log(f"{name}: [{got.shape[0]}, {got.shape[1]}] int32, total "
            f"{int(got.astype(np.int64).sum())}, frame 0 {got[0].tolist()}")
    return out


def main(argv=None):
    cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
