"""The frozen reference: the MRC1 NumPy spec codec.

`config`, `tables`, `bitstream`, `utils/bits` and `spec/` are verbatim
copies of the codec package's normative NumPy spec and the modules it
reads (their docstrings speak of the package they were copied from).
They import numpy and the standard library only, never torch, JAX or
either codec package, and take nothing the codec under test has made.
`spec.codec` is the reference's definition, a whole clip at a time;
`runner` drives the same stages over many clips at once, frame blocks
across a pool of processes, and is held to `spec.codec.encode` and
`spec.codec.decode`, and they to the codec package's spec, by
mrcbench/tests/test_mrcbench_reference.py.

These files are the benchmark's yardstick: they stay as they are.
"""
