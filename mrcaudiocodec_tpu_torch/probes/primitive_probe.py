"""P5: five ways of pairing neighbouring lanes, then a row sum.

Counterpart of scripts/tpu_primitive_probe.py, whose Pallas kernels asked
which lane-restructuring primitives the remote Mosaic compiler accepts.
That question has no meaning on the card; the values the five bodies
compute do, and these are they (csrc/probe_primitives.cu), on the
script's x [64, 1024] f32 (seed 0), each row's value in 8 columns:
  p0  sum of x[2p] + x[2p+1], read as the [F, 512, 2] reshape
  p1  the same, read as the strided lanes x[::2] + x[1::2]
  p2  sum of x[i] + x[i+1] at even i (the row rolled by -1), 0 at odd i
  p3  sum of x @ E + x @ O with the 0/1 deinterleave matrices E, O
  p4  sum over even i of bf16(tab[m[i]*9 + m[i+1]]), m = clip(int(|x|),
      0, 8), tab = 0..80 (the script's masked bf16 one-hot dot)
Every row sum runs in the halving order of xpsy.tree_sum, in the kernels
and the plain versions alike, so the two give the same bits.

    python -m mrcaudiocodec_tpu_torch.probes.primitive_probe [--device cpu]
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import xpsy
from . import check_args, cfn, cli, launch, log, pick

NF = 64
COLS = 8
N = 1024
F32 = torch.float32

launches = {"p0": 0, "p1": 0, "p2": 0, "p3": 0, "p4": 0}


def make_x(device):
    rng = np.random.default_rng(0)
    return torch.from_numpy((10.0 * rng.standard_normal((NF, N))
                             ).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=None)
def deinterleave(device: str):
    """E, O [1024, 512] f32: E[2j, j] = O[2j+1, j] = 1."""
    e = np.zeros((N, N // 2), np.float32)
    o = np.zeros((N, N // 2), np.float32)
    e[np.arange(0, N, 2), np.arange(N // 2)] = 1.0
    o[np.arange(1, N, 2), np.arange(N // 2)] = 1.0
    return torch.from_numpy(e).to(device), torch.from_numpy(o).to(device)


@functools.lru_cache(maxsize=None)
def table(device: str):
    """The script's length table 0..80, [81] f32."""
    return torch.arange(81, dtype=F32, device=device)


def _row(tot):
    """[F] -> [F, COLS]: the row's value in every column."""
    return tot[:, None].expand(tot.shape[0], COLS).contiguous()


def _even(x):
    return (torch.arange(x.shape[-1], device=x.device) % 2) == 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def p0_plain(x):
    v = x.reshape(x.shape[0], N // 2, 2)
    return _row(xpsy.tree_sum(v[..., 0] + v[..., 1]))


def p1_plain(x):
    return _row(xpsy.tree_sum(x[:, ::2] + x[:, 1::2]))


def p2_plain(x):
    pair = torch.where(_even(x), x + torch.roll(x, -1, 1), 0.0)
    return _row(xpsy.tree_sum(pair))


def _deinterleave_product(x, m, rows: int = 8):
    """x [F, 1024] @ m [1024, 512], each output a tree sum over the 1024
    products (exact: one nonzero term per output), 8 rows at a time."""
    out = [xpsy.tree_sum((x[r:r + rows, :, None] * m).transpose(1, 2))
           for r in range(0, x.shape[0], rows)]
    return torch.cat(out) if out else x.new_zeros((0, m.shape[1]))


def p3_plain(x, e_mat, o_mat):
    even = _deinterleave_product(x, e_mat)
    odd = _deinterleave_product(x, o_mat)
    return _row(xpsy.tree_sum(even + odd))


def p4_plain(x, tab):
    m = torch.clamp(torch.abs(x).to(torch.int32), 0, 8)
    sym = m * 9 + torch.roll(m, -1, 1)
    tab16 = tab.to(torch.bfloat16).to(F32)
    bits = torch.where(_even(x), tab16[sym.long()], 0.0)
    return _row(xpsy.tree_sum(bits))


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _fn(body: str):
    extra = {"p3": [_P, _P], "p4": [_P]}.get(body, [])
    return cfn("probe_primitives", f"mrc_probe_{body}",
               [_P] + extra + [ctypes.c_int, _P, ctypes.c_longlong])


def _kernel(name, x, extra):
    check_args(name, [(x, F32, (x.shape[0], N))] + extra)
    out = torch.empty((x.shape[0], COLS), dtype=F32, device=x.device)
    if x.shape[0]:
        launch(name, _fn(name), x.data_ptr(),
               *(t.data_ptr() for t, _, _ in extra), COLS, out.data_ptr(),
               x.shape[0], device=x.device)
        launches[name] += 1
    return out


def p0_kernel(x):
    return _kernel("p0", x, [])


def p1_kernel(x):
    return _kernel("p1", x, [])


def p2_kernel(x):
    return _kernel("p2", x, [])


def p3_kernel(x, e_mat, o_mat):
    return _kernel("p3", x, [(e_mat, F32, (N, N // 2)),
                             (o_mat, F32, (N, N // 2))])


def p4_kernel(x, tab):
    return _kernel("p4", x, [(tab, F32, (81,))])


BODIES = {"p0": (p0_kernel, p0_plain), "p1": (p1_kernel, p1_plain),
          "p2": (p2_kernel, p2_plain), "p3": (p3_kernel, p3_plain),
          "p4": (p4_kernel, p4_plain)}


def body_inputs(device):
    x = make_x(device)
    dev = str(torch.device(device))
    return {"p0": (x,), "p1": (x,), "p2": (x,),
            "p3": (x,) + deinterleave(dev), "p4": (x, table(dev))}


def run(device) -> dict:
    """Each body once through its wrapper, then the script's host checks.
    -> {body: [NF, 8] f32 numpy}."""
    out = {}
    for name, args in body_inputs(device).items():
        kernel, plain = BODIES[name]
        out[name] = pick(args[0], kernel, plain)(*args).cpu().numpy()
        log(f"{name}: sum={out[name].sum():.1f} row 0 {out[name][0, 0]!r}")
    xh = make_x("cpu").numpy()
    want = xh.astype(np.float64).sum(axis=1)
    for name in ("p0", "p1", "p2", "p3"):
        log(f"{name} vs the host's float64 row sums: max |diff| "
            f"{np.abs(out[name][:, 0] - want).max():.3g}")
    m = np.clip(np.abs(xh).astype(np.int64), 0, 8)
    bits = (m * 9 + np.roll(m, -1, axis=1)).astype(np.float64)
    bits[:, 1::2] = 0
    log(f"p4 host check row 0: {bits[0].sum()} kernel: {out['p4'][0, 0]}")
    return out


def main(argv=None):
    cli(run, __doc__, argv)


if __name__ == "__main__":
    main()
