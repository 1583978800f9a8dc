"""The harness on the CPU: its data found by name, BENCHMARK.json in step
with it, the result line's keys, the readers, a metric whose function is
gone, faults in the timed path that `correct` must catch, and no JAX.

Each cell's pipeline is rehearsed at a tiny size on CPU tensors through
`harness.run_cell` (the command itself refuses to run without a card).
"""
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

from mrcbench import catalog, harness, readers
from mrcbench.catalog import Catalog
from mrcbench.trace import Trace

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
REPO = os.path.dirname(PKG)
SEED = 2**31 + 37
CELLS = ["clip30s.encode", "corpus64.encode", "clip30s.decode"]
HELD_BACK = {"clip30s.decode"}
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny(cell):
    over = {"config": {"clip_seconds": 0.3, "clips_per_request": 1},
            "traffic": {"distinct_clips": 2, "warmup_calls": 1,
                        "traced_requests": 2}}
    if cell.startswith("corpus"):
        over["config"]["clips_per_request"] = 3
        over["traffic"]["traced_requests"] = 1
    if cell.endswith("decode"):
        over["traffic"]["requests"] = 2
    return over


def rehearse(cell, trace=False, fault=None, cat=None, seconds=0.2,
             traffic=None):
    over = tiny(cell)
    over["traffic"].update(traffic or {})
    return harness.run_cell(cell, SEED, seconds, trace, "cpu", 0.0,
                            catalog=cat, overrides=over, fault=fault,
                            workers=2)


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kind", catalog.KINDS)
def test_every_file_loads_by_name(kind):
    cat = Catalog()
    names = cat.names(kind)
    assert names
    for n in names:
        assert cat.load(kind, n)["name"] == n
    if kind == "workloads":
        for n in names:
            cell = cat.cell(n)
            assert cell["config"]["name"] and cell["traffic"]["entry"]


def test_benchmark_json_matches_the_files():
    b, cat = bench(), Catalog()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["mrcbench"]
    assert b["command"] == ["python3", "-m", "mrcbench.run"]
    assert {c["name"] for c in b["configs"]} == set(cat.names("configs"))
    for c in b["configs"]:
        f = cat.load("configs", c["name"])
        assert c["file"] == f"mrcbench/configs/{c['name']}.json"
        assert c["source"] == f["source"] and c["reduced"] == f["reduced"]
    # a cell held back (PERF.md, Open questions) keeps its files, and its
    # own metrics stay out of BENCHMARK.json with it
    cells = {w["name"] for w in b["workloads"]}
    assert set(cat.names("workloads")) - cells == HELD_BACK
    for w in b["workloads"]:
        f = cat.load("workloads", w["name"])
        for k in ("config", "traffic", "chips", "why"):
            assert w[k] == f[k]
    metrics = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    assert set(metrics) == {
        n for n in cat.names("metrics")
        if set(cat.load("metrics", n).get("workloads", cells)) & cells}
    for m in b["end_to_end"]:
        assert cat.load("metrics", m["name"])["kind"] == "end_to_end"
    for name, m in metrics.items():
        f = cat.load("metrics", name)
        for k in ("unit", "better", "source", "layer", "moves", "workloads"):
            assert m.get(k) == f.get(k), (name, k)
    for w in b["workloads"]:
        e2e = [m["name"] for m in cat.metrics(w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cat.metrics(w["name"], "per_layer")


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = ([c["name"] for c in b["configs"]]
             + [w[k] for w in b["workloads"] for k in ("name", "config",
                                                       "traffic")]
             + [m["name"] for m in b["end_to_end"] + b["per_layer"]]
             + [k for c in b["configs"] for k in c["reduced"]])
    for n in names:
        assert catalog.NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert catalog.UNIT.match(m["unit"]), m["unit"]
    for w in b["workloads"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for root, _, files in os.walk(PKG):
        for f in files:
            rel = os.path.relpath(os.path.join(root, f), REPO)
            if "__pycache__" not in rel:
                assert re.match(r"^[A-Za-z0-9_./\-]+$", rel), rel


def test_new_cell_mix_and_metric_are_found_from_new_files(tmp_path):
    for kind in catalog.KINDS:
        shutil.copytree(os.path.join(PKG, kind), tmp_path / kind)
    before = {p: p.read_bytes() for p in tmp_path.rglob("*.json")}
    (tmp_path / "traffic" / "music_encode_short.json").write_text(json.dumps(
        dict(json.loads((tmp_path / "traffic" / "music_encode.json")
                        .read_text()), distinct_clips=3, requests=3)))
    (tmp_path / "workloads" / "clip10s.encode.json").write_text(json.dumps(
        {"config": "clip30s_44k1_stereo_128k",
         "traffic": "music_encode_short", "chips": 1, "why": "a test"}))
    # its own end-to-end metrics, as `corpus_rtf` is the batch's: the
    # clip's files with this cell in `workloads`
    for name, like in (("clip10s_rtf", "encode_rtf"),
                       ("clip10s_p95_ms", "encode_p95_ms")):
        (tmp_path / "metrics" / f"{name}.json").write_text(json.dumps(
            dict(json.loads((tmp_path / "metrics" / f"{like}.json")
                            .read_text()), workloads=["clip10s.encode"])))
    (tmp_path / "metrics" / "clip10s.budget_host_ms.json").write_text(
        json.dumps({"kind": "per_layer", "layer": "budget", "unit": "ms",
                    "better": "lower", "source": "program_span",
                    "reader": "host_ms", "moves": "encode_rtf",
                    "spans": ["mrcaudiocodec_tpu_torch.ops.reservoir."
                              "allocate"],
                    "workloads": ["clip10s.encode"]}))
    cat = Catalog(str(tmp_path))
    cell = cat.cell("clip10s.encode")
    assert cell["traffic"]["distinct_clips"] == 3
    assert [m["name"] for m in cat.metrics("clip10s.encode", "per_layer")] \
        == ["clip10s.budget_host_ms"]
    e2e = {"clip10s_rtf", "clip10s_p95_ms", "setup_s"}
    assert {m["name"] for m in
            cat.metrics("clip10s.encode", "end_to_end")} == e2e
    assert all(p.read_bytes() == b for p, b in before.items())
    res, _ = rehearse("clip10s.encode", cat=cat)
    assert res["correct"] and set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for m in res["metrics"].values())
    res, _ = rehearse("clip10s.encode", trace=True, cat=cat)
    assert res["correct"] and "clip10s.budget_host_ms" in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(cell, trace):
    res, checks = rehearse(cell, trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(res) == want
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["checks"]) == set(checks)
    assert all(v <= lim for v, lim in checks.values())
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in Catalog().metrics(cell, kind)}
    assert set(res["metrics"]) <= names
    if trace and cell == "clip30s.encode":
        # the clip's staging copy, `encoder.stage_pcm`, runs on every path;
        # its pad runs as K11's plain version here, so the pad metric, which
        # reads K11's launcher, finds no call on the CPU
        assert res["metrics"]["clip.entry_stage_host_ms"]["value"] > 0
        assert "clip.entry_pad_host_ms" not in res["metrics"]
    if not trace:
        # on the CPU every end-to-end metric is read; the device ones are
        # left out, never written as 0
        assert set(res["metrics"]) == names
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(res["device"]) >= {"platform", "count"}
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_metric_whose_function_is_missing_is_left_out(tmp_path):
    for kind in catalog.KINDS:
        shutil.copytree(os.path.join(PKG, kind), tmp_path / kind)
    (tmp_path / "metrics" / "clip.gone_host_ms.json").write_text(json.dumps(
        {"kind": "per_layer", "layer": "budget", "unit": "ms",
         "better": "lower", "source": "program_span", "reader": "host_ms",
         "moves": "encode_rtf", "workloads": ["clip30s.encode"],
         "spans": ["mrcaudiocodec_tpu_torch.models.encoder.no_such_stage"]}))
    res, _ = rehearse("clip30s.encode", trace=True,
                      cat=Catalog(str(tmp_path)))
    assert res["correct"]
    assert "clip.gone_host_ms" not in res["metrics"]
    assert "clip.budget_host_ms" in res["metrics"]


def stale(call):
    """A step that returns its state unchanged: every request after the
    first gets the output of the one before."""
    last = []

    def broken(inp):
        out = call(inp)
        if last:
            out, last[0] = last[0], out
        else:
            last.append(out)
        return out
    return broken


def half_batch(call):
    """Half of the batch left out: the first half's outputs stand in for
    the rest."""
    def broken(inp):
        half = call(inp[:max(1, len(inp) // 2)])
        return (half * 2)[:len(inp)]
    return broken


def altered(call):
    """An answer altered where it is produced: one byte of each stream, or
    one sample of each PCM, off by one."""
    def broken(inp):
        outs = call(inp)
        if isinstance(outs[0], bytes):
            b = bytearray(outs[0])
            b[len(b) // 2] ^= 1
            return [bytes(b)] + outs[1:]
        pcm = outs[0].copy()
        pcm[len(pcm) // 2, 0] += 1
        return [pcm] + outs[1:]
    return broken


@pytest.mark.parametrize("cell,fault", [
    ("clip30s.encode", stale), ("clip30s.encode", altered),
    ("corpus64.encode", stale), ("corpus64.encode", half_batch),
    ("corpus64.encode", altered),
    ("clip30s.decode", stale), ("clip30s.decode", altered),
])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    # the warm-up call goes through the broken path too, so the window's
    # first request already gets a stale output
    res, checks = rehearse(cell, fault=fault)
    assert res["attempted"] >= 1
    assert res["correct"] is False
    assert any(v > lim for v, lim in checks.values())


class Memo:
    """A result cache put in the timed path: a call whose input has the
    key of an earlier call's gets that call's output back."""

    def __init__(self, key):
        self.key, self.hits = key, 0

    def __call__(self, call):
        seen = {}

        def broken(inp):
            k = self.key(inp)
            if k in seen:
                self.hits += 1
            else:
                seen[k] = call(inp)
            return seen[k]
        return broken


def _buffers(inp):
    return inp if isinstance(inp, list) else [inp]


def by_identity(inp):
    """The input buffers' objects and data pointers."""
    return tuple((id(b), b.__array_interface__["data"][0])
                 if isinstance(b, np.ndarray) else id(b)
                 for b in _buffers(inp))


def by_content(inp):
    """A hash of the input's samples or bytes."""
    return tuple(hashlib.sha256(np.ascontiguousarray(b).tobytes()
                                if isinstance(b, np.ndarray) else b).digest()
                 for b in _buffers(inp))


@pytest.mark.parametrize("cell", ["clip30s.encode", "corpus64.encode"])
def test_a_cache_by_the_input_buffer_is_not_correct(cell):
    # an upload or a result kept by the buffer's identity: every call of
    # the window sends a buffer that an earlier call sent, with its note
    # moved, so the cache hands back stale streams
    memo = Memo(by_identity)
    res, checks = rehearse(cell, fault=memo, traffic={"warmup_calls": 2})
    assert memo.hits >= res["attempted"] >= 1
    assert res["correct"] is False and checks["wrong_streams"][0] > 0


@pytest.mark.parametrize("cell", ["clip30s.encode", "corpus64.encode"])
def test_no_two_encode_calls_send_the_same_audio(cell):
    # a cache by content never hits, so it can show no gain
    memo = Memo(by_content)
    res, _ = rehearse(cell, fault=memo, seconds=0.6,
                      traffic={"warmup_calls": 3})
    assert memo.hits == 0 and res["correct"] and res["attempted"] >= 1


@pytest.mark.parametrize("cell", ["clip30s.encode", "corpus64.encode"])
def test_each_call_sends_the_content_the_reference_works_out(cell):
    from mrcbench.entries import Load
    load = Load(Catalog().cell(cell), SEED, tiny(cell))
    load.setup("cpu")
    sent = []
    for c in range(7):
        inp = load.next_input(c)
        sent.append([x.copy() for x in (inp if isinstance(inp, list)
                                        else [inp])])
    for c, bufs in enumerate(sent):
        for j, x in enumerate(bufs):
            assert np.array_equal(x, load.content(c, j))
            assert not np.array_equal(x, load.base[load.slots[c % len(
                load.slots)][j]])


def test_the_decode_ring_streams_all_differ():
    from mrcbench.entries import Load
    over = tiny("clip30s.decode")
    over["traffic"]["requests"] = 4
    load = Load(Catalog().cell("clip30s.decode"), SEED, over)
    load.setup("cpu")
    assert len(set(load.streams)) == 4
    assert [load.next_input(c) for c in range(8)] == load.streams * 2


def test_rehearsals_load_no_jax():
    code = ("from mrcbench import harness\n"
            "for c in %r:\n"
            "    over = {'config': {'clip_seconds': 0.3, "
            "'clips_per_request': 2 if c.startswith('corpus') else 1}, "
            "'traffic': {'distinct_clips': 2, 'warmup_calls': 1, "
            "'traced_requests': 1, 'requests': 2}}\n"
            "    r, _ = harness.run_cell(c, 5, 0.1, True, 'cpu', 0.0, "
            "overrides=over, workers=2)\n"
            "    assert r['correct'], r\n"
            "print(harness.forbidden_modules())\n" % CELLS)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike", sys)
    monkeypatch.setitem(sys.modules, "mrcaudiocodec_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "mrcaudiocodec_tpu.spec", sys)
    assert harness.forbidden_modules() == ["mrcaudiocodec_tpu.spec"]


def test_the_command_refuses_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "-m", "mrcbench.run", "--workload",
         "clip30s.encode", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def _trace():
    """Two requests; a stage span with a launch, a sync and a copy back."""
    t = Trace(requests=2)
    t.spans = {"request": [(0, 1000), (2000, 3000)],
               "stage": [(100, 600), (2100, 2600)]}
    t.runtime = [("cudaLaunchKernel", 150, 160, 1),
                 ("cudaStreamSynchronize", 200, 400, 2),
                 ("cudaMemcpyAsync", 450, 550, 3),
                 ("cudaLaunchKernel", 2150, 2160, 4),
                 ("cudaLaunchKernel", 800, 810, 5)]
    t.device = [("k1", 170, 370, 1), ("Memcpy DtoH (Device -> Pageable)",
                                      460, 540, 3),
                ("k1", 2170, 2270, 4), ("k2", 820, 900, 5)]
    return t


def test_readers_on_a_known_trace():
    run = harness.RunData(trace=_trace())
    ms = 1e6 * 2
    span = {"spans": ["stage"]}
    assert readers.get("device_ms")(span, run) == pytest.approx(380 / ms)
    # 2 x 500 ns of wall, less the sync (200) and the copy back (100)
    assert readers.get("host_ms")(span, run) == pytest.approx(700 / ms)
    own = {"spans": ["request"], "minus": ["stage"]}
    assert readers.get("self_ms")(own, run) == pytest.approx(1000 / ms)
    idle = readers.get("idle_pct")({}, run)
    assert idle == pytest.approx(100 * (1 - 460 / 3000))
    assert readers.get("roofline_pct")(dict(span, work="analysis"),
                                       run) is None
    assert readers.get("device_ms")({"spans": ["none"]}, run) is None
    b = harness.breakdown(run.trace)
    assert b["device_ops"][0] == ["k1", 300 / 1e9]
    assert b["idle_gaps"][0] == ["request", 1270 / 1e9]
    empty = harness.RunData(trace=Trace())
    assert readers.get("idle_pct")({}, empty) is None
    assert harness.short_name(
        "void (anonymous namespace)::fft_stages_kernel<9>(float const*, "
        "long long)") == "fft_stages_kernel<9>"
    assert harness.short_name("Memcpy DtoH (Device -> Pageable)") \
        == "Memcpy DtoH (Device -> Pageable)"


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    res, _ = harness.run_cell("clip30s.encode", SEED, 1.0, False, card, 0.0,
                              overrides=tiny("clip30s.encode"))
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_a_traced_run_on_the_card_reads_the_clips_pad_and_stage(card):
    res, _ = harness.run_cell("clip30s.encode", SEED, 1.0, True, card, 0.0,
                              overrides=tiny("clip30s.encode"))
    assert res["correct"]
    for name in ("clip.entry_pad_host_ms", "clip.entry_stage_host_ms"):
        assert res["metrics"][name]["value"] > 0


@pytest.mark.cuda
def test_the_command_fails_with_only_the_benchmark(card, tmp_path):
    shutil.copytree(PKG, tmp_path / "mrcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "mrcbench.run", "--workload",
         "clip30s.encode", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
