"""The 1-D "mesh" a sharded step runs over (counterpart of
gaussiansplatting_tpu/parallel/mesh.py).

JAX shards over a ``Mesh`` of devices driven by one controller; PyTorch runs
one process per rank, each driving one device, so the mesh here is a
``torch.distributed`` process group of ranks: rank r renders tile strip r
(parallel/sharded.py).  Gaussian parameters are replicated and their
gradients all-reduced over the group."""

from __future__ import annotations

from typing import NamedTuple

import torch.distributed as dist

TILE_AXIS = "tiles"


class Mesh(NamedTuple):
    group: object   # torch.distributed process group (None outside it)
    size: int       # ranks in the group (JAX: mesh.devices.size)
    rank: int       # this process's rank in the group, -1 outside it


def require_process_group(what: str) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"{what} needs an initialized torch.distributed process group "
            "(parallel.launch.initialize under a launcher, or parallel.launch.spawn)")


def make_mesh(num_devices: int | None = None) -> Mesh:
    """The group of the first ``num_devices`` ranks (default: every rank)
    of the initialized process group, as JAX's make_mesh takes the first
    num_devices devices.  A smaller group is made with ``new_group``, which
    every rank must call, members or not; a rank outside it gets rank -1
    and must not run the sharded step."""
    require_process_group("make_mesh")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh: {n} ranks requested, the process group has {world}")
    rank = dist.get_rank()
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    return Mesh(group if rank < n else None, n, rank if rank < n else -1)
