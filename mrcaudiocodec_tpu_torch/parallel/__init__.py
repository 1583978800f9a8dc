"""Sharded and multi-process encode and decode over torch.distributed.

Port of mrcaudiocodec_tpu/parallel/: `mesh` (the ("data", "seq") grid of
ranks), `sharded` (frame-sharded encode and decode with halo and
reservoir-carry exchange; one exchange in one process, another over a
process group) and `launch` (the multi-process entry: `corpus`,
`scaling`).
"""
