"""The ("data", "seq") grid of ranks (port of mrcaudiocodec_tpu/parallel/
mesh.py).

  "data" — independent clips: no communication but the final gather.
  "seq"  — the frame axis of one clip: halo exchange and the reservoir
           carry. It is the innermost axis, so rank = d * n_seq + s and a
           seq group's ranks are neighbours (one host's cards where the
           ranks are laid out host by host).

With a process group, `make_grid` builds the grid as a torch DeviceMesh
over the world and reads the seq group from it. Without one, the grid
is virtual: one process runs every shard in turn (`sharded.LocalShards`).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist


@dataclass(frozen=True)
class Grid:
    """n_data x n_seq shards; `mesh` is the DeviceMesh over the process
    group (None: every shard runs in this process)."""
    n_data: int
    n_seq: int
    mesh: object = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_seq

    def coords(self, rank: int) -> tuple[int, int]:
        """Rank -> (data index, seq index); seq is innermost."""
        return divmod(rank, self.n_seq)

    def seq_group(self):
        """The process group of this rank's seq shards."""
        return self.mesh.get_group("seq")


def make_grid(n_data: int | None = None, n_seq: int = 1) -> Grid:
    """A ("data", "seq") grid. With an initialized process group it spans
    the world (n_data defaults to world // n_seq) and raises unless
    n_data * n_seq is the world size; the mesh lives where the backend's
    collectives run ("cuda" under NCCL, "cpu" under gloo). Without one,
    n_data defaults to 1."""
    if not dist.is_initialized():
        return Grid(1 if n_data is None else n_data, n_seq)
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_seq
    if n_data * n_seq != world:
        raise ValueError(f"grid {n_data}x{n_seq} != world size {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = init_device_mesh(device_type, (n_data, n_seq),
                            mesh_dim_names=("data", "seq"))
    return Grid(n_data, n_seq, mesh)


def data_block(grid: Grid, d: int, n: int) -> slice:
    """The contiguous block of n items (clips, or a decode's channel
    rows; n a multiple of n_data) that data index d owns: the clip axis
    sharded over "data" (mesh.data_sharding)."""
    k = n // grid.n_data
    return slice(d * k, (d + 1) * k)


def seq_block(grid: Grid, s: int, n_frames: int) -> slice:
    """The contiguous frames (n_frames a multiple of n_seq) that seq index
    s owns: the frame axis sharded over "seq" (mesh.seq_sharding)."""
    k = n_frames // grid.n_seq
    return slice(s * k, (s + 1) * k)
