"""The measurement helpers of `profiling.py` on CPU inputs: each
kernel's bytes and operations from its launch's inputs (`kernel_bound`,
K4's op count `rd_loop_ops`) and the least time of a set of launches
(`bound_ms`).
"""
import numpy as np
import pytest
import torch

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import profiling
from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch.ops import device_pack
from mrcaudiocodec_tpu_torch.ops.kernels import record_pack

torch.set_num_threads(1)


def test_kernel_bounds_on_cpu_inputs():
    """kernel_bound's bytes and ops from the shapes (K1, K2) and from the
    records' own bits (K3: its body bytes equal the plain pack's total),
    and bound_ms the larger of the byte and op times."""
    re = torch.zeros((6, 8, 128))
    b, o, rate = profiling.kernel_bound(("fft_stages", (6, 8, 128)),
                                        (re, re))
    assert (b, o, rate) == (6144 * 16 + 127 * 8, 3072 * 7 * 10,
                            profiling.F32_OPS_PER_S)
    gains = torch.zeros((10, 4), dtype=torch.int32)
    b, o, _ = profiling.kernel_bound(("quant_cost", (10, 4)),
                                     (None, None, gains))
    assert (b, o) == (10 * 1024 * 8 + 10 * 9 * 4, 10 * 4 * 1024 * 54)
    fs, cap = 44100, 4096
    d = [torch.from_numpy(v) for v in record_pack.random_decisions(
        np.random.default_rng(1), 40, fs)]
    order = torch.from_numpy(np.random.default_rng(2).permutation(40)[:31]
                             .astype(np.int32))
    args = (*d, order, fs, cap)
    _, _, status = device_pack.pack_stream_plain(*args)
    nb = T.unified_layout(fs)["nb"]
    b, o, rate = profiling.kernel_bound(("record_pack", (31,)), args)
    assert b == 31 * (2 * C.LONG_COEFFS + 2 * nb + 7) + int(status[0]) + 124
    assert rate == profiling.INT32_OPS_PER_S and o > 0
    t, by = profiling.bound_ms([(3.35e9, 0, 1.0), (0, 1.0, 1e3)])
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = profiling.bound_ms([(0, 3.0, 1e3), (3.35e9, 1.0, 1e3)])
    assert by == "operations" and t == pytest.approx(4.0)


def test_k4_bound_counts_kept_magnitudes():
    """K4's op count (profiling.rd_loop_ops, kernel_bound): each candidate's
    quantize and the entry's, then a table dequantize, d, d * d and one add
    a scan stage a bin an over-mask; the requantizing count (kept=False)
    quantizes and dequantizes by the xlog2 / xexp2 chain in every one. The
    bytes add the |q|^(4/3) table."""
    from test_torch_rd_loop import loop_inputs, rd_case
    from mrcaudiocodec_tpu_torch.ops import rd
    fs = 44100
    case = tuple(v[:10] for v in rd_case("all_short", fs))
    args = (*loop_inputs(*case, fs), fs)
    st = {k: v.numpy().astype(np.int64) for k, v in
          rd.loop_counts(*args).items()}
    bt = args[3].numpy()
    stages = np.where(bt == C.SHORT, rd.scan_stages(fs, True),
                      rd.scan_stages(fs, False))
    masks = int((st["over_masks"] * (2 + stages)).sum())
    cands, n_masks, rows = int(st["cands"].sum()), int(
        st["over_masks"].sum()), len(bt)
    assert cands > 0 and n_masks > rows
    kept = 1024 * ((cands + rows) * 54 + n_masks * 4 + masks)
    requantized = 1024 * (cands * 54 + n_masks * (54 + 53) + masks)
    assert profiling.rd_loop_ops(args) == kept
    assert profiling.rd_loop_ops(args, kept=False) == requantized
    assert kept < requantized
    nb = args[1].shape[1]
    b, o, rate = profiling.kernel_bound(("rd_loop", (rows,)), args)
    assert (b, o, rate) == (rows * (2 * 1024 + 2 * nb + 6) * 4 + 4096 * 4,
                            kept, profiling.F32_OPS_PER_S)
