"""The port's multi-process path on the CPU: torch.distributed with gloo.

`GroupShards` in 2 and 4 processes (torch.multiprocessing.spawn), each
running its own shard of a (data, seq) grid, must give the streams of the
single-process encode and the PCM of the single-process decode; `python
-m mrcaudiocodec_tpu_torch.parallel.launch corpus --num-hosts 2` in two
processes must split the corpus by rank (manifests that partition it) and
write the streams `codec.encode` gives. This module imports no JAX: the
spawned processes import it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mrcaudiocodec_tpu_torch import audiofile, corpus
from mrcaudiocodec_tpu_torch.config import CodecConfig
from mrcaudiocodec_tpu_torch.models import codec
from mrcaudiocodec_tpu_torch.parallel import launch, mesh, sharded

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = CodecConfig(fs=44100, channels=2, bitrate=128000)


def _clips():
    """Three stereo clips of 12, 8 and 10 frames."""
    return [corpus._synth_corpus(1, sec, seed=30 + i)[0]
            for i, sec in enumerate([0.25, 0.16, 0.2])]


def _group_worker(rank, world, port, grids, out_dir):
    """One process of a gloo world: for each (n_data, n_seq) grid, its
    shard of the sharded encode of _clips() (the streams it holds to
    out_dir) and of the decode of the first clip's stream."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        clips = _clips()
        for n_data, n_seq in grids:
            grid = mesh.make_grid(n_data, n_seq)
            ex = sharded.GroupShards(grid, "cpu")
            assert ex.local == [grid.coords(rank)] and not ex.staged
            rows, nf_row, n_samples = sharded.pad_rows(clips, n_seq)
            streams = sharded.sharded_encode(rows, nf_row, CFG, grid, ex,
                                             n_samples=n_samples)
            tag = f"{n_data}x{n_seq}"
            for j, s in enumerate(streams):
                if s is not None:
                    with open(os.path.join(out_dir, f"{tag}_r{rank}_c{j}"),
                              "wb") as f:
                        f.write(s)
            if n_data > 1:                 # the decode's data axis too
                pcm, _ = sharded.sharded_decode(
                    codec.encode(clips[0], CFG, device="cpu"), grid, ex)
                np.save(os.path.join(out_dir, f"{tag}_r{rank}_pcm.npy"), pcm)
    finally:
        dist.destroy_process_group()


def _held(out_dir, tag):
    """{clip: [(rank, stream), ...]} of the files the workers wrote."""
    held = {}
    for name in os.listdir(out_dir):
        if name.startswith(tag + "_") and "_c" in name:
            rank, clip = name[len(tag) + 1:].split("_")
            with open(os.path.join(out_dir, name), "rb") as f:
                held.setdefault(int(clip[1:]), []).append((int(rank[1:]),
                                                           f.read()))
    return held


@pytest.mark.parametrize("world,grids", [(2, [(1, 2)]),
                                         (4, [(2, 2), (1, 4)])],
                         ids=["2proc", "4proc"])
def test_group_shards_equal_single_process(world, grids, tmp_path):
    mp.spawn(_group_worker, args=(world, launch.free_port(), grids,
                                  str(tmp_path)), nprocs=world, join=True)
    clips = _clips()
    want = [codec.encode(x, CFG, device="cpu") for x in clips]
    for n_data, n_seq in grids:
        held = _held(str(tmp_path), f"{n_data}x{n_seq}")
        assert sorted(held) == list(range(len(clips)))
        for j, got in held.items():
            # the first seq rank of the clip's data block holds it
            block = -(-len(clips) // n_data)
            assert [r for r, _ in got] == [(j // block) * n_seq], (j, got)
            assert got[0][1] == want[j], (n_data, n_seq, j)
        if n_data > 1:
            y, _ = codec.decode(want[0], device="cpu")
            for rank in range(world):
                pcm = np.load(tmp_path / f"{n_data}x{n_seq}_r{rank}_pcm.npy")
                np.testing.assert_array_equal(pcm.view(np.int32),
                                              y.view(np.int32))


def test_make_grid_spans_the_world():
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:"
                                        f"{launch.free_port()}")
    try:
        with pytest.raises(ValueError, match="world size 1"):
            mesh.make_grid(2, 1)
        grid = mesh.make_grid()
        assert (grid.n_data, grid.n_seq) == (1, 1)
        assert grid.mesh.device_type == "cpu"          # gloo's collectives
        assert dist.get_world_size(grid.seq_group()) == 1
    finally:
        dist.destroy_process_group()
    assert mesh.make_grid(3, 2) == mesh.Grid(3, 2)
    assert mesh.Grid(3, 2).coords(5) == (2, 1)
    assert mesh.data_block(mesh.Grid(3, 2), 1, 6) == slice(2, 4)
    assert mesh.seq_block(mesh.Grid(3, 2), 1, 10) == slice(5, 10)


def test_launch_corpus_two_processes(tmp_path):
    """Two ranks over 4 mixed-length mono WAVs: rank h encodes files h,
    h + 2 with its own manifest; the manifests partition the corpus and
    every .mrc equals codec.encode of its WAV."""
    indir, outdir = tmp_path / "in", tmp_path / "out"
    indir.mkdir()
    paths = []
    for i, sec in enumerate([0.2, 0.3, 0.25, 0.15]):
        p = str(indir / f"clip{i:02d}.wav")
        audiofile.write_wav(p, corpus._synth_corpus(
            1, sec, seed=50 + i, channels=1)[0], 44100)
        paths.append(p)
    port = launch.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "mrcaudiocodec_tpu_torch.parallel.launch",
         "corpus", "--coordinator", f"localhost:{port}", "--num-hosts", "2",
         "--host-id", str(h), "--indir", str(indir), "--outdir", str(outdir),
         "--device", "cpu"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for h in range(2)]
    stats = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        assert "backend gloo, device cpu" in err
        stats.append(json.loads(out.strip().splitlines()[-1]))
    assert [s["encoded"] for s in stats] == [2, 2]
    assert all(s["devices_local"] == 1 and s["devices_global"] == 2
               for s in stats)
    srcs = []
    for h in range(2):
        with open(outdir / f"manifest_h{h}.jsonl") as f:
            srcs.append({json.loads(line)["src"] for line in f})
    assert srcs == [set(paths[0::2]), set(paths[1::2])]
    for p in paths:
        x, fs = audiofile.read_wav(p, raw_int16=True)
        with open(outdir / (os.path.basename(p)[:-4] + ".mrc"), "rb") as f:
            assert f.read() == codec.encode(
                x, CodecConfig(fs=fs, channels=1, bitrate=128000),
                device="cpu"), p


def test_launch_refuses_without_card_or_coordinator():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA card"):
        launch.main(["scaling"])
    with pytest.raises(SystemExit, match="--coordinator"):
        launch.main(["scaling", "--device", "cpu", "--num-hosts", "2"])
    with pytest.raises(SystemExit, match="nccl backend needs"):
        launch.main(["scaling", "--device", "cpu", "--backend", "nccl"])


def test_launch_scaling_world_size_one():
    """The process-group path at world size 1 (gloo on the CPU): one
    JSON line with both cases and the efficiency."""
    res = subprocess.run(
        [sys.executable, "-m", "mrcaudiocodec_tpu_torch.parallel.launch",
         "scaling", "--device", "cpu", "--seconds", "0.2", "--clips", "2",
         "--n-seq", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["1dev"]["devices"] == out["all"]["devices"] == 1
    assert out["backend"] == "gloo" and out["world_size"] == 1
    assert out["scaling_efficiency"] > 0


@pytest.mark.cuda
def test_corpus_devices_on_card():
    """On the card: the data axis over two entries of cuda:0 equals the
    one-device batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    clips = _clips()
    one = corpus.encode_batch(clips, CFG, devices=["cuda:0"])
    two = corpus.encode_batch(clips, CFG, devices=["cuda:0", "cuda:0"])
    assert one == two == [codec.encode(x, CFG, device="cuda") for x in clips]


def test_corpus_devices_split_on_cpu(monkeypatch):
    """Two CPU entries: the batch splits into two blocks of whole clips
    (rows padded to 16 frames, not 64: the CPU runs every pad frame)."""
    monkeypatch.setattr(corpus, "FRAME_BUCKET", 16)
    clips = _clips()
    two = corpus.encode_batch(clips, CFG, devices=["cpu", "cpu"])
    assert two == [codec.encode(x, CFG, device="cpu") for x in clips]
    assert corpus.local_devices("cpu") == ["cpu"]
