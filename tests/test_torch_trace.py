"""The port's spans and counters (`mrcaudiocodec_tpu_torch/trace.py`) on
the CPU, and the benchmark's metrics of the encode path's entry, idle
split, syncs, launches and bytes up (`mrcbench/metrics/`, their readers in
`mrcbench/readers/`).

Off: one shared no-op context and no event in a profiler trace. On: the
span names of a clip and of a batch request, the stages siblings under
the top span; the counters against the bytes and reads they count; the
readers on a hand-built trace; a traced rehearsal of both encode cells.
"""
import numpy as np
import pytest
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from mrcaudiocodec_tpu_torch import config as C
from mrcaudiocodec_tpu_torch import corpus, trace
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import encoder
from mrcaudiocodec_tpu_torch.ops import rd
from mrcbench import catalog, harness, readers
from mrcbench import trace as btrace
from mrcbench.catalog import Catalog
from mrcbench.trace import Trace

FS = 44100
CFG = CodecConfig(fs=FS, channels=2, bitrate=128000)
TOP = {"mrc.encode", "mrc.encode_batch"}
STAGES = {"mrc.analyze", "mrc.budget", "mrc.decide", "mrc.pack",
          "mrc.download"}
ENTRY = {"mrc.pad", "mrc.order", "mrc.upload", "mrc.assemble"}
NEW = ["entry_pad_host_ms", "entry_upload_host_ms", "upload_mb",
       "idle_entry_ms", "idle_stages_ms", "idle_outside_ms", "host_syncs",
       "launches", "upload_pinned_mb"]
CELLS = {"clip30s.encode": "clip", "corpus64.encode": "corpus"}


def clip(seconds, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(FS * seconds)) / FS
    x = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal(
        t.size)
    return (np.stack([x, np.roll(x, 11)], 1) * 32767).astype(np.int16)


def clip_request():
    x = clip(0.4)
    return lambda: encoder.encode(x, CFG, device="cpu")


def batch_request():
    xs = [clip(0.4, 1), clip(0.15, 2), clip(0.3, 3)]
    return lambda: corpus.encode_batch(xs, CFG, devices=["cpu"])


def mrc_spans(prof) -> dict:
    """{name: [(start, end, thread)]} of the port's spans in a profiler
    run."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("mrc.") and e.device_type() == DeviceType.CPU:
            s = e.start_ns()
            out.setdefault(e.name(), []).append(
                (s, s + e.duration_ns(), e.start_thread_id()))
    return out


def traced(request):
    """request() with the port's tracing on, under the profiler -> (its
    output, the mrc.* spans, the counters' change)."""
    before = trace.counters()
    trace.enable(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = request()
    finally:
        trace.enable(False)
    after = trace.counters()
    return out, mrc_spans(prof), {
        k: v - before.get(k, 0) for k, v in after.items()}


def test_span_is_one_shared_no_op_while_off():
    assert trace.span("mrc.encode") is trace.span("mrc.decide")
    with trace.span("mrc.pad") as got:
        assert got is None
    run = clip_request()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert mrc_spans(prof) == {}


@pytest.mark.parametrize("make,top", [(clip_request, "mrc.encode"),
                                      (batch_request, "mrc.encode_batch")])
def test_stage_spans_are_siblings_under_the_top_span(make, top):
    run = make()
    want = run()
    got, spans, _ = traced(run)
    assert got == want                      # tracing changes no byte
    assert set(spans) == {top} | STAGES | ENTRY
    threads = {r[2] for rs in spans.values() for r in rs}
    assert len(threads) == 1
    (a, b, _), = spans[top]
    for name, rs in spans.items():
        assert all(a <= s and e <= b for s, e, _ in rs), name
    stages = sorted((s, e, n) for n in STAGES for s, e, _ in spans[n])
    for (_, e, n), (s, _, m) in zip(stages, stages[1:]):
        assert e <= s, f"{n} overlaps {m}"
    chunks = len(spans["mrc.decide"])
    assert len(spans["mrc.analyze"]) == len(spans["mrc.pack"]) == chunks
    assert len(spans["mrc.download"]) == chunks
    assert len(spans["mrc.budget"]) == 1
    # the staged PCM and the clips' offsets and lengths, an order a chunk;
    # a batch also sends its rows' frame counts
    assert len(spans["mrc.upload"]) == 2 + chunks + (top != "mrc.encode")
    # the entry's spans lie between the stages, never inside one
    for n in ENTRY:
        for s, e, _ in spans[n]:
            assert not any(s < se and ss < e for ss, se, _ in stages), n


def test_counters_count_bytes_up_and_blocking_reads(monkeypatch):
    x = clip(0.4)
    nf = C.frames_for_samples(x.shape[0])
    spans = encoder.chunk_spans(nf, CFG.channels)
    # the PCM once, the clip's offset and length, an order a chunk
    want_up = x.nbytes + 16 + sum(
        encoder.stream_order(None, CFG.channels, f0, s, CFG.channels)[
            0].nbytes for f0, s in spans)
    exits = [0]
    orig = rd._sync_any

    def counted(t):
        exits[0] += 1
        return orig(t)
    monkeypatch.setattr(rd, "_sync_any", counted)
    before = trace.counters()
    encoder.encode(x, CFG, device="cpu")
    got = {k: v - before.get(k, 0) for k, v in trace.counters().items()}
    assert got["requests.encode"] == 1
    assert got["bytes_up"] == want_up
    assert got["staging.bytes_up"] == x.nbytes
    assert got["host_syncs.download"] == 2 * len(spans)
    assert exits[0] > 0 and got["host_syncs.rd_exit"] == exits[0]
    # the plain pack on the CPU reads no status from a device
    assert got.get("host_syncs.pack_status", 0) == 0


def test_counters_of_a_batch_count_every_chunk():
    run = batch_request()
    _, spans, got = traced(run)
    chunks = len(spans["mrc.decide"])
    assert got["requests.encode_batch"] == 1
    assert got.get("requests.encode", 0) == 0
    assert got["host_syncs.download"] == 2 * chunks
    rows = 3 * CFG.channels
    # the audio: every clip's int16 samples once; the clips' offsets and
    # lengths: two int64 a clip; the orders: one int32 a real record; the
    # rows' frame counts: an int64 a row
    audio = sum(int(FS * d) * CFG.channels * 2 for d in (0.4, 0.15, 0.3))
    records = sum(C.frames_for_samples(int(FS * d)) for d in (0.4, 0.15, 0.3))
    assert got["bytes_up"] == (audio + 16 * 3 + 4 * records * CFG.channels
                               + 8 * rows)
    assert got["staging.bytes_up"] == audio


# -- the readers on a hand-built trace ----------------------------------------

def hand_trace():
    """Two requests of 1000 ns and 800 ns; device work in both, and
    runtime launches inside and outside the codec's top calls."""
    t = Trace()
    t.requests = 2
    t.spans = {"request": [(0, 1000), (1200, 2000)],
               "stage": [(100, 600), (1300, 1800)]}
    t.runtime = [("cudaLaunchKernel", 120, 130, 1),
                 ("cudaMemcpyAsync", 450, 460, 3),
                 ("cudaStreamSynchronize", 460, 560, 9),
                 ("cudaLaunchKernel", 20, 25, 4),          # outside the top
                 ("cudaLaunchKernel", 1310, 1320, 5),
                 ("cuLaunchKernel", 1500, 1510, 6)]
    t.device = [("k1", 170, 370, 1), ("Memcpy DtoH (Device -> Pageable)",
                                      460, 540, 3),
                ("k2", 30, 60, 4), ("k1", 1400, 1450, 5),
                ("k3", 1520, 1700, 6)]
    return t


def with_codec(t):
    """The calls of the codec's wrapped functions: its top call, the pad
    and two stages inside each request."""
    t.spans.update({"top": [(50, 950), (1250, 1950)],
                    "pad": [(55, 95), (1255, 1290)],
                    "analyze": [(100, 400), (1300, 1600)],
                    "download": [(420, 600), (1620, 1900)]})
    return t


def read(name, metric, t):
    return readers.get(name)(metric, harness.RunData(trace=t))


def test_the_idle_split_sums_to_the_traced_idle():
    t = with_codec(hand_trace())
    stages = ["analyze", "download"]
    parts = {n: read("idle_in", m, t) for n, m in
             [("entry", {"spans": ["top"], "minus": stages}),
              ("stages", {"spans": stages}),
              ("outside", {"minus": ["top"]})]}
    idle = read("idle_pct", {}, t) / 100 * 2000 / 2 / 1e6
    assert sum(parts.values()) == pytest.approx(idle)
    # by hand, ns over both requests: the window's idle is [0, 30),
    # [60, 170), [370, 460), [540, 1400), [1450, 1520), [1700, 2000);
    # 1080 of it inside the top calls, 570 inside the stages
    assert parts["stages"] == pytest.approx(
        (70 + 30 + 40 + 60 + 100 + 70 + 200) / 2e6)
    assert parts["entry"] == pytest.approx((1080 - 570) / 2e6)
    assert parts["outside"] == pytest.approx((30 + 300 + 50) / 2e6)


def test_idle_in_reads_nothing_without_calls_or_device_work():
    t = with_codec(hand_trace())
    assert read("idle_in", {"spans": ["gone"]}, t) is None
    t.device = []
    assert read("idle_in", {"spans": ["top"]}, t) is None
    assert read("idle_in", {"minus": ["top"]}, t) is None


def test_host_ms_of_a_wrapped_entry_function_subtracts_waits():
    t = with_codec(hand_trace())
    # 180 + 280 ns of wall, less the sync (100) and the copy back (10)
    assert read("host_ms", {"spans": ["download"]}, t) == pytest.approx(
        350 / 2e6)
    assert read("host_ms", {"spans": ["pad"]}, t) == pytest.approx(
        75 / 2e6)


def test_launches_count_only_inside_the_top_calls():
    t = with_codec(hand_trace())
    assert read("launches", {"spans": ["top"]}, t) == 1.5
    assert read("launches", {"spans": ["gone"]}, t) is None
    t.runtime = []
    assert read("launches", {"spans": ["top"]}, t) is None


def test_counter_reads_the_codec_counters_a_request(monkeypatch):
    t = hand_trace()
    m = {"counter": "host_syncs.", "per": "requests.encode_batch"}
    monkeypatch.setattr(trace, "_counts", {
        "requests.encode_batch": 2, "bytes_up": 3_000_000,
        "host_syncs.download": 4, "host_syncs.pack_status": 2})
    assert read("counter", m, t) == 3
    assert read("counter", {"counter": "bytes_up", "scale": 1e-6,
                            "per": "requests.encode_batch"},
                t) == pytest.approx(1.5)
    assert read("counter", dict(m, counter="bytes_down"), t) is None
    assert read("counter", dict(m, per="requests.encode"), t) is None
    # another entry point's requests would mix their counts in
    trace.count("requests.encode")
    assert read("counter", m, t) is None


def test_existing_readers_and_breakdown_read_as_before():
    def every(t):
        run = harness.RunData(trace=t)
        span = {"spans": ["stage"]}
        got = harness.breakdown(t)
        return ([readers.get(r)(span, run)
                 for r in ("device_ms", "host_ms")]
                + [readers.get("self_ms")({"spans": ["request"],
                                           "minus": ["stage"]}, run),
                   readers.get("idle_pct")({}, run),
                   readers.get("roofline_pct")(dict(span, work="analysis"),
                                               run),
                   got["device_ops"], [g[1] for g in got["idle_gaps"]]])
    # more wrapped functions can only relabel the idle gaps, which the
    # breakdown names by the innermost call the host was in
    assert every(with_codec(hand_trace())) == every(hand_trace())


# -- the metric files and a traced rehearsal of each encode cell --------------

@pytest.mark.parametrize("cell", list(CELLS))
def test_the_metric_files_name_functions_of_the_port(cell):
    cat = Catalog()
    short = CELLS[cell]
    got = {m["name"]: m for m in cat.metrics(cell, "per_layer")}
    for n in NEW:
        m = got[f"{short}.{n}"]
        assert catalog.UNIT.match(m["unit"]) and m["workloads"] == [cell]
        assert readers.get(m["reader"])
        for path in btrace.span_paths(m):
            assert btrace._resolve(path) is not None, path


@pytest.mark.parametrize("cell", list(CELLS))
def test_a_traced_rehearsal_reports_the_new_metrics(cell, monkeypatch):
    over = {"config": {"clip_seconds": 0.3, "clips_per_request": 1},
            "traffic": {"distinct_clips": 2, "warmup_calls": 1,
                        "traced_requests": 2}}
    if cell.startswith("corpus"):
        over["config"]["clips_per_request"] = 3
        over["traffic"]["traced_requests"] = 1
    monkeypatch.setattr(trace, "_counts", {})
    kept = []
    finish = btrace.Tracer.finish

    def keep(self):
        kept.append(finish(self))
        return kept[-1]
    monkeypatch.setattr(btrace.Tracer, "finish", keep)
    res, _ = harness.run_cell(cell, 2**31 + 41, 0.2, True, "cpu", 0.0,
                              overrides=over, workers=2)
    assert res["correct"]
    short = CELLS[cell]
    # on the CPU the idle split and the launches find no card to read; the
    # clip's main path pads nothing on the host (`_padded_rows` is the
    # oracle's), so its pad metric finds no call
    new = {k.split(".", 1)[1] for k in res["metrics"]
           if k.split(".", 1)[1] in NEW}
    assert new == {"entry_upload_host_ms", "upload_mb", "host_syncs",
                   "upload_pinned_mb"} | (
                       {"entry_pad_host_ms"} if short == "corpus" else set())
    assert f"{short}.entry_self_ms" in res["metrics"]
    assert trace.span("mrc.a") is trace.span("mrc.b")  # the port's: off
    got = trace.counters()
    per = got["requests.encode" if short == "clip" else
              "requests.encode_batch"]
    syncs = sum(v for k, v in got.items() if k.startswith("host_syncs."))
    assert res["metrics"][f"{short}.host_syncs"]["value"] == syncs / per
    assert res["metrics"][f"{short}.upload_mb"]["value"] == pytest.approx(
        got["bytes_up"] / per / 1e6)
    assert res["metrics"][f"{short}.upload_pinned_mb"][
        "value"] == pytest.approx(got["staging.bytes_up"] / per / 1e6)
    # the stage calls lie inside the top calls and never overlap: what
    # makes the idle split whole on the card
    t, = kept
    m = Catalog().load("metrics", f"{short}.idle_entry_ms")
    tops = t.spans[m["spans"][0]]
    stages = sorted(r for n in m["minus"] for r in t.spans.get(n, []))
    assert len(tops) == t.requests and stages
    for s, e in stages:
        assert any(a <= s and e <= b for a, b in tops)
    for (_, e), (s, _) in zip(stages, stages[1:]):
        assert e <= s
