"""The process groups of a device mesh's axes.

The reference's ``compat`` papers over ``shard_map``'s API drift between
jax releases: there a step is one program, manual over some axes and left
to the SPMD partitioner over the others.  The port has no ``shard_map``:
every process runs the whole step and issues each collective by hand over
the axis it concerns.  So this module holds what that needs: the lookup of
an axis's process group, size and this process's index on it, and the two
collectives the training step uses (a mean over some axes, an all-gather
along one dim).  An axis of size 1 moves nothing: no collective is issued
for it.

Between torch 2.11 (the CUDA host's) and 2.13, nothing this slice calls
differs: ``init_device_mesh``, ``DeviceMesh.get_group`` /
``get_local_rank`` / ``mesh_dim_names``, ``dist.all_reduce`` /
``dist.all_gather`` and the DTensor placements ``Shard`` / ``Replicate``
(``torch.distributed.tensor``) have the same spelling in both.
"""

from __future__ import annotations

import math
from typing import Iterable

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_sizes

__all__ = ["axis_group", "axis_size", "axis_index", "all_reduce_mean_", "all_gather_cat"]


def axis_group(mesh, name: str):
    """The process group of the processes that differ only on axis ``name``."""
    return mesh.get_group(mesh_dim=name)


def axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh)[name]


def axis_index(mesh, name: str) -> int:
    """This process's coordinate on axis ``name``."""
    return mesh.get_local_rank(mesh_dim=name)


def all_reduce_mean_(t: torch.Tensor, mesh, axes: Iterable[str]) -> torch.Tensor:
    """``t`` (in place) averaged over the processes of ``axes``: a sum over
    each axis in turn, then one division by their count."""
    live = [a for a in axes if axis_size(mesh, a) > 1]
    for a in live:
        dist.all_reduce(t, group=axis_group(mesh, a))
    if live:
        t.div_(math.prod(axis_size(mesh, a) for a in live))
    return t


def all_gather_cat(t: torch.Tensor, mesh, name: str, dim: int) -> torch.Tensor:
    """Every process's ``t`` along axis ``name``, concatenated on ``dim`` in
    axis order."""
    n = axis_size(mesh, name)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=axis_group(mesh, name))
    return torch.cat(parts, dim=dim)
