"""Distributed partitioning layer (port of ``repro.dist``).

``repro_torch.dist.sharding`` holds the partitioning rules (spec
legalization, and the rules for parameters, optimizer moments, batches and
GEAR caches) and :class:`~repro_torch.dist.sharding.Sharding`, a spec on a
``DeviceMesh``; ``repro_torch.dist.compat`` the process groups of a mesh's
axes and the collectives over them.
"""

from repro_torch.dist import compat, sharding
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
    "PartitionSpec",
    "Sharding",
    "fit_spec",
    "param_pspecs",
    "zero1_pspecs",
    "batch_pspecs",
    "cache_pspecs",
    "shardings_for",
]
