"""Collective traffic of a traced step (port of ``repro.perf.hlo_stats``).

The reference parses the compiled HLO's all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute instructions.  The port
has no HLO, and this module has no HLO text parser: every collective of the
port is issued by hand (:mod:`repro_torch.dist.compat`), so
:class:`CollectiveCounter`, a ``TorchDispatchMode``, records each ``c10d``
op the traced step dispatches, with the bytes of its operand and result
tensors.  :func:`collective_stats` gives the reference's dict: per kind
``count``, ``operand_bytes`` and ``result_bytes``, then
``total_operand_bytes`` and ``total_count``.  Under a fake process group
(``torch.testing._internal.distributed.fake_pg``) on meta tensors the
collectives move nothing, yet they are dispatched and counted, so one
process traces its share of a production mesh's step.

Which counter is for what: this one reads kinds and bytes, for the dry run
and the CPU tests.  It routes every op of the run through Python, so a timed
run on the card (``chip_smoke.py``'s serving on a 1 × 1 mesh) counts with
``chip_smoke.CollectiveCalls`` instead, which wraps the ``torch.distributed``
functions and reads calls only.
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveCounter", "collective_stats", "dtype_bytes", "COLLECTIVES"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute", "broadcast")

# c10d op (its base name, the overload and the in-place suffix dropped) -> kind
_KIND = {
    "allreduce": "all-reduce", "allreduce_coalesced": "all-reduce", "all_reduce": "all-reduce",
    "allgather": "all-gather", "_allgather_base": "all-gather",
    "allgather_coalesced": "all-gather", "allgather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter": "reduce-scatter", "_reduce_scatter_base": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter", "reduce_scatter_tensor": "reduce-scatter",
    "alltoall": "all-to-all", "alltoall_base": "all-to-all", "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv": "collective-permute",
    "broadcast": "broadcast",
}
_OPERANDS = ("input_tensors", "input_tensor", "input", "tensors", "tensor", "self")
_RESULTS = ("output_tensors", "output_tensor", "output", "tensors", "tensor", "self")
# (a functional collective returns its result; an in-place one writes it
# into its ``output*`` argument, or into its operand)

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "s4": 0.5, "u4": 0.5,
}


def dtype_bytes(dt) -> float:
    """Bytes of one element of ``dt``: a ``torch.dtype``, or an HLO type name
    (``"bf16"``, ``"f32"``, ...; 4 for a name it does not know, as the
    reference's)."""
    if isinstance(dt, torch.dtype):
        return torch.empty((), dtype=dt, device="meta").element_size()
    return _DTYPE_BYTES.get(dt, 4)


def _nbytes(x) -> float:
    if isinstance(x, torch.Tensor):
        return float(x.numel() * x.element_size())
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0.0


class CollectiveCounter(TorchDispatchMode):
    """Records every collective dispatched inside it
    (``with CollectiveCounter() as c: ...``); :meth:`stats` gives the
    reference's dict."""

    def __init__(self):
        super().__init__()
        self._stats = defaultdict(lambda: {"count": 0, "operand_bytes": 0.0, "result_bytes": 0.0})

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
            kind = _KIND.get(func._schema.name.split("::")[-1].rstrip("_"))
            if kind is not None:
                vals = dict(zip((a.name for a in func._schema.arguments), args), **kwargs)
                st = self._stats[kind]
                st["count"] += 1
                st["operand_bytes"] += next((_nbytes(vals[k]) for k in _OPERANDS if k in vals),
                                            0.0)
                st["result_bytes"] += next((_nbytes(vals[k]) for k in _RESULTS if k in vals),
                                           _nbytes(out))
        return out

    def stats(self) -> dict:
        """``{kind: {count, operand_bytes, result_bytes}}`` plus
        ``total_operand_bytes`` and ``total_count``."""
        out = {k: dict(v) for k, v in self._stats.items()}
        out["total_operand_bytes"] = sum(v["operand_bytes"] for v in self._stats.values())
        out["total_count"] = sum(v["count"] for v in self._stats.values())
        return out


def collective_stats(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` and return the collectives it issued
    (:meth:`CollectiveCounter.stats`)."""
    with CollectiveCounter() as c:
        fn(*args, **kwargs)
    return c.stats()
