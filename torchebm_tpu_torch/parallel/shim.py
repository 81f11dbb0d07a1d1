r"""Guarded distributed helpers (counterpart of :mod:`torchebm_tpu.parallel.shim`).

Reference: ``torchebm/distributed.py:15-88``. Every helper degrades to an
identity or no-op when no process group is up; none of them is required by
any default ``sample()`` or loss path.

The JAX package's helpers name a mesh axis bound inside ``shard_map``. Here
an axis is a dimension of a :class:`~torch.distributed.device_mesh.DeviceMesh`:
pass the mesh with ``mesh=`` and the axis by name; without a mesh the helper
runs over the whole world (the one axis of a 1-D mesh over every process).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

from .mesh import is_dtensor

Tensor = torch.Tensor

__all__ = [
    "is_distributed",
    "get_rank",
    "get_world_size",
    "all_gather_cat",
    "broadcast_object",
    "psum_mean",
]


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_distributed() -> bool:
    """True when a process group of more than one process is up (reference
    ``distributed.py:24-26``). A world of one, which :func:`make_mesh` brings
    up by itself in a single process, is not distributed."""
    return _initialized() and dist.get_world_size() > 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def _group(axis_name: str, mesh):
    """The process group of ``mesh``'s dimension ``axis_name``, the world's
    without a mesh, or None when no group is up."""
    if mesh is not None:
        return mesh.get_group(axis_name)
    return dist.group.WORLD if _initialized() else None


def all_gather_cat(x: Tensor, axis_name: str = "data", tiled: bool = True, *,
                   mesh=None) -> Tensor:
    """Gather equal-shaped tensors from every process of the mesh axis
    ``axis_name`` and concatenate them along dim 0 (``tiled=False`` stacks
    them on a new leading axis), as the reference's ``all_gather_cat``
    (``distributed.py:39-66``).

    A DTensor is gathered over its own mesh's dimension ``axis_name`` (that
    dimension becomes replicated) and returned as this process's local
    tensor. Without a group, or over an axis of one process, ``x`` comes back
    unchanged: the single-process identity."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate

        dm = x.device_mesh
        i = dm.mesh_dim_names.index(axis_name)
        placements = list(x.placements)
        placements[i] = Replicate()
        return x.redistribute(dm, placements).to_local()
    group = _group(axis_name, mesh)
    if group is None or dist.get_world_size(group) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=0) if tiled else torch.stack(parts)


def psum_mean(x: Tensor, axis_name: str = "data", *, mesh=None) -> Tensor:
    """The mean of ``x`` over the processes of the mesh axis ``axis_name`` (a
    new tensor: a sum all-reduce, which every backend has, over the group
    size); identity without a group."""
    group = _group(axis_name, mesh)
    if group is None or dist.get_world_size(group) == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / dist.get_world_size(group)


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Broadcast a picklable host object from rank ``src`` to every process
    (reference ``distributed.py:69-88``); single-process identity."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
