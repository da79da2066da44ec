"""Device meshes over ranks (counterpart of solr_tpu/parallel/mesh.py).

The renderer's parallel axis is rays ("tiles"); scenes are replicated.
A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over ranks,
one device per rank, so every function here needs the default process
group (``initialize_distributed``).  ``None`` stands for the mesh of one
process with no process group: the whole frame, no collective.

A rank's linear index is its position in the mesh, row-major over the
mesh's axes (the reference's ``_linear_index``); rank i of an N-rank
mesh renders the i-th of N row bands.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

__all__ = ["make_mesh", "make_host_chip_mesh", "device_count",
           "linear_index", "mesh_size", "mesh_ranks", "mesh_group",
           "TILE_AXIS", "HOST_AXIS", "CHIP_AXIS"]

TILE_AXIS = "tiles"
HOST_AXIS = "host"
CHIP_AXIS = "chip"


def device_count() -> int:
    """The job's devices: its ranks (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_devices: Optional[int] = None, axis_name: str = TILE_AXIS,
              device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default).
    Every rank of the job must call it; a rank past ``n_devices`` gets
    the mesh but is not in it (``linear_index`` is None)."""
    n = device_count() if n_devices is None else int(n_devices)
    if not 1 <= n <= device_count():
        raise ValueError(f"{n} devices asked of a job of {device_count()}")
    return DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis_name,))


def make_host_chip_mesh(n_hosts: Optional[int] = None,
                        device_type: str = "cuda") -> DeviceMesh:
    """2-D ('host', 'chip') mesh over every rank, host-major: the ranks
    of one host form a row, so a contiguous run of row bands stays on
    one host and only the gradient reduction and the image gather cross
    hosts.  ``n_hosts`` defaults to the world size over torchrun's
    ``LOCAL_WORLD_SIZE`` (1 host without it); pass it to test the
    layout on one host."""
    world = device_count()
    if n_hosts is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_hosts = world // local
    if n_hosts < 1 or world % n_hosts:
        raise ValueError(f"{world} ranks do not split into {n_hosts} hosts")
    return DeviceMesh(device_type,
                      [list(range(h * (world // n_hosts),
                                  (h + 1) * (world // n_hosts)))
                       for h in range(n_hosts)],
                      mesh_dim_names=(HOST_AXIS, CHIP_AXIS))


def mesh_ranks(mesh) -> list:
    """The mesh's global ranks in linear order."""
    return [0] if mesh is None else mesh.mesh.flatten().tolist()


def mesh_size(mesh) -> int:
    return 1 if mesh is None else mesh.size()


def linear_index(mesh) -> Optional[int]:
    """This rank's position in the mesh, row-major over its axes (None
    when the rank is not in it)."""
    if mesh is None:
        return 0
    ranks = mesh_ranks(mesh)
    rank = dist.get_rank()
    return ranks.index(rank) if rank in ranks else None


def mesh_group(mesh):
    """The process group over all of the mesh's axes, whose group ranks
    are the linear indices (None for the one-process mesh).  A mesh of
    several axes must span the job."""
    if mesh is None:
        return None
    ranks = mesh_ranks(mesh)
    if ranks != sorted(ranks):
        raise ValueError("a mesh's ranks must ascend in linear order")
    if mesh.ndim == 1:
        return mesh.get_group(0)
    if len(ranks) != dist.get_world_size():
        raise ValueError("a mesh of several axes must span every rank")
    return dist.group.WORLD
