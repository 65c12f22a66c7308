"""Device meshes over the ranks of a ``torch.distributed`` world.

Counterpart of ``cra5_tpu/parallel/mesh.py``. The JAX package builds one
``jax.sharding.Mesh`` over every visible device; the port runs one device
a rank (torch's idiom), so its mesh is a ``DeviceMesh`` over the world's
ranks, resolved under the same rules (``mesh_axes``):

  - no axes: pure data parallelism, ``{"dp": world}``;
  - at most one axis may be -1, and it takes what the others leave;
  - the axes' product may not exceed the visible devices (ranks), and the
    first ``prod(axes)`` of them are used.

In a single process (no world joined), ``make_mesh`` joins a world of one
rank through an in-process store, so the same code runs unchanged from
one device to many.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def local_device_count() -> int:
    """The devices this process sees: its CUDA cards, or 1 (the CPU)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


def mesh_axes(axes: Optional[Dict[str, int]], n: int) -> Dict[str, int]:
    """Axis name -> size of a mesh of ``axes`` over ``n`` devices, as
    ``cra5_tpu/parallel/mesh.py::make_mesh`` resolves it."""
    if not axes:
        return {"dp": n}
    axes = {k: int(v) for k, v in dict(axes).items()}
    sizes = list(axes.values())
    if sizes.count(-1) > 1:
        raise ValueError("at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        if n % known:
            raise ValueError(f"{n} devices not divisible by {known}")
        sizes[sizes.index(-1)] = n // known
        axes = dict(zip(axes.keys(), sizes))
    need = int(np.prod(list(axes.values())))
    if need > n:
        raise ValueError(f"mesh {axes} needs {need} devices, only {n} visible")
    return axes


def _world(device_type: str) -> int:
    """The world's size, joining a world of one rank when none is joined."""
    if not dist.is_initialized():
        backend = "nccl" if device_type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def make_mesh(axes: Optional[Dict[str, int]] = None, devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ``DeviceMesh`` named by ``axes`` (e.g. ``{"dp": 4}``) over the
    ranks ``devices`` (default: every rank of the world). ``device_type``
    defaults to ``cuda`` when a card is visible, else ``cpu``."""
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    ranks = list(devices) if devices is not None else list(range(_world(device_type)))
    axes = mesh_axes(axes, len(ranks))
    need = int(np.prod(list(axes.values())))
    grid = torch.tensor(ranks[:need], dtype=torch.int64).reshape(tuple(axes.values()))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axes.keys()))


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis`` on ``mesh`` (a DeviceMesh or an axis -> size
    mapping), 1 when the mesh has no such axis."""
    if mesh is None:
        return 1
    if isinstance(mesh, DeviceMesh):
        names = mesh.mesh_dim_names or ()
        return mesh.size(names.index(axis)) if axis in names else 1
    return int(dict(mesh).get(axis, 1))


def axis_group(mesh, axis: str):
    """(process group, size, this rank's index) of ``axis`` on a
    DeviceMesh; (None, 1, 0) without a mesh or for an axis of one device."""
    if axis_size(mesh, axis) == 1:
        return None, 1, 0
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)
