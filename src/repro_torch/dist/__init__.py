"""Distributed partitioning layer (port of ``repro.dist``).

``repro_torch.dist.sharding`` holds the partitioning rules (spec
legalization, and the rules for parameters, optimizer moments, batches and
GEAR caches) and :class:`~repro_torch.dist.sharding.Sharding`, a spec on a
``DeviceMesh``; ``repro_torch.dist.compat`` the process groups of a mesh's
axes and the collectives over them; ``repro_torch.dist.whole`` the
whole-model module a process's forward runs on, gathered from its stored
shards (the mesh train step's and the mesh engine's).
"""

from repro_torch.dist import compat, sharding, whole
from repro_torch.dist.sharding import (
    PartitionSpec,
    Sharding,
    batch_pspecs,
    cache_pspecs,
    fit_spec,
    param_pspecs,
    shardings_for,
    zero1_pspecs,
)

__all__ = [
    "compat",
    "sharding",
    "whole",
    "PartitionSpec",
    "Sharding",
    "fit_spec",
    "param_pspecs",
    "zero1_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "shardings_for",
]
