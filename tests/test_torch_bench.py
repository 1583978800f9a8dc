"""The port's bench (python -m mrcaudiocodec_tpu_torch.bench) on the CPU:
its clip and quality measures equal the root bench.py's, one run at a
small size prints the root bench's JSON keys with the port's stream equal
to the port's spec's, it refuses the card without one and --kernels off
the card; and the profiling helpers' bounds on CPU inputs.
"""
import json

import numpy as np
import pytest
import torch

import bench as root_bench

from mrcaudiocodec_tpu_torch import bench, profiling
from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import tables as T
from mrcaudiocodec_tpu_torch.ops import device_pack
from mrcaudiocodec_tpu_torch.ops.kernels import record_pack

torch.set_num_threads(1)

ROOT_KEYS = {"metric", "value", "unit", "vs_baseline", "seg_snr_db",
             "seg_snr_spec_db", "seg_snr_vs_spec_db", "psnr_db",
             "psnr_spec_db", "device_resident_rtf", "stream_matches_spec"}


@pytest.mark.parametrize("fs,seconds,channels,seed", [
    (44100, 1.3, 2, 0), (48000, 0.7, 1, 3)])
def test_make_clip_equals_root_bench(fs, seconds, channels, seed):
    got = bench.make_clip(fs, seconds, channels, seed)
    want = root_bench.make_clip(fs, seconds, channels, seed)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("measure", ["psnr", "segmental_snr"])
def test_quality_measures_equal_root_bench(measure):
    rng = np.random.default_rng(4)
    x = bench.make_clip(44100, 0.5, 2)
    y = (x + 1e-3 * rng.standard_normal(x.shape)).astype(np.float32)
    y[:2048] = 0.0                              # some segments lost
    args = (x, y) if measure == "psnr" else (x[:, 0], y[:, 0])
    assert getattr(bench, measure)(*args) == getattr(root_bench,
                                                     measure)(*args)


def test_bench_main_on_cpu_prints_the_root_keys(monkeypatch, capsys):
    for name in ("ENCODE_TRIALS", "SPEC_TRIALS", "RESIDENT_TRIALS"):
        monkeypatch.setattr(bench, name, 1)
    assert bench.main(["--device", "cpu", "--seconds", "1",
                       "--spec-seconds", "0.5", "--full"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == ROOT_KEYS
    assert res["metric"] == "encode_realtime_factor_per_chip_128kbps_stereo"
    assert res["stream_matches_spec"] is True
    assert res["seg_snr_vs_spec_db"] == 0.0
    assert res["psnr_db"] == res["psnr_spec_db"]
    assert res["value"] > 0 and res["device_resident_rtf"] > 0
    assert "not a card number" in err and "device-resident decode" in err


@pytest.mark.parametrize("argv,code", [
    (["--seconds", "1"], "error: no CUDA card is available; run with "
                         "--device cpu"),
    (["--device", "cpu", "--kernels"], 2)],
    ids=["cuda_without_card", "kernels_on_cpu"])
def test_bench_refuses_without_card(argv, code, capsys):
    """No JSON line, a non-zero exit (the message, or argparse's 2)."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit) as e:
        bench.main(argv)
    assert e.value.code == code
    assert capsys.readouterr().out == ""


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


def test_k4_turns_refuses_without_card(tmp_path, capsys):
    """The in-turns K4 timing prints no JSON line and exits 2 without a
    card, before it imports or builds the other version."""
    from mrcaudiocodec_tpu_torch import k4_turns
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert k4_turns.main([str(tmp_path / "missing")]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA card" in out.err
