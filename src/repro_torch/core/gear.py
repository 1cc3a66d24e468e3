"""GEAR composition: X ≈ D̂ + L + S (paper Section 3, Algorithm 1).

Port of ``repro.core.gear.compress_matrix``: outliers first, the backbone
quantizes the remainder, and the power iteration factors the residual
``X - deq(D̂) - S`` (against the stats as stored).  A and B are kept in bf16.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lowrank as lr
from repro_torch.core import outlier as ol
from repro_torch.core import quant as q
from repro_torch.core.policy import CompressionPolicy

__all__ = ["CompressedMatrix", "compress_matrix"]


@dataclasses.dataclass(frozen=True)
class CompressedMatrix:
    qt: q.QuantizedTensor
    sparse: ol.SparseOutliers | None
    a: torch.Tensor | None
    b: torch.Tensor | None


def compress_matrix(x: torch.Tensor, policy: CompressionPolicy, kind: str,
                    rank: int | None = None) -> CompressedMatrix:
    """Compress ``x`` [..., n, d] as the ``kind`` ('k' or 'v') cache tensor;
    leading dims are independent matrices."""
    if policy.is_fp16:
        raise ValueError("fp16 policy has no compressed representation")
    scheme, group = policy.scheme_for(kind)
    axis = "token" if scheme == "per_channel" else "channel"
    sparse = None
    remainder = x
    if policy.use_sparse:
        sparse, remainder = ol.filter_outliers(x, policy.sparsity, axis)
    qt = q.quantize(remainder, policy.bits, scheme, group, stat_dtype=policy.stat_dtype)
    a = b = None
    if policy.use_lowrank:
        r = policy.rank if rank is None else rank
        resid = x.to(torch.float32) - q.dequantize(qt)
        if sparse is not None:
            resid = resid - ol.densify(sparse)
        a, b = lr.power_iteration(resid, r, policy.power_iters)
        a = a.to(torch.bfloat16)
        b = b.to(torch.bfloat16)
    return CompressedMatrix(qt=qt, sparse=sparse, a=a, b=b)
