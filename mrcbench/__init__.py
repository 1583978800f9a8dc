"""The benchmark of the PyTorch and CUDA codec (`mrcaudiocodec_tpu_torch`).

    python3 -m mrcbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run measures one cell on one card: it builds the cell's inputs from
the seed, warms up the cell's own shapes, drives the codec's entry point
in a closed loop for `--seconds`, compares every output it kept with the
frozen NumPy reference (`reference/`) and prints one JSON line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own (`configs/`, `traffic/`, `workloads/`, `metrics/`),
found by the name `BENCHMARK.json` gives; each statistic is read by one
small reader (`readers/`), and each stage's work count lives in `work/`.
Nothing here imports JAX or the JAX package, and the reference imports
nothing but numpy and the standard library.
"""
