"""GEAR composition: X ≈ D̂ + L + S (paper Section 3, Algorithm 1).

Port of ``repro.core.gear.compress_matrix``: outliers first, the backbone
quantizes the remainder, and the power iteration factors the residual
``X - deq(D̂) - S`` (against the stats as stored).  A and B are kept in bf16.
``decompress_matrix`` reconstructs ``deq(D̂) + A·Bᵀ + S`` in the reference's
order, and ``approx_error`` is the paper's relative Frobenius error of a
policy on a tensor (its Fig. 1a, Table 8).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import lowrank as lr
from repro_torch.core import outlier as ol
from repro_torch.core import quant as q
from repro_torch.core.policy import CompressionPolicy

__all__ = ["CompressedMatrix", "compress_matrix", "decompress_matrix", "approx_error"]


@dataclasses.dataclass(frozen=True)
class CompressedMatrix:
    qt: q.QuantizedTensor
    sparse: ol.SparseOutliers | None
    a: torch.Tensor | None
    b: torch.Tensor | None

    def size_bytes(self) -> int:
        """Backbone + outliers + 2 bytes a low-rank factor entry."""
        total = self.qt.size_bytes()
        if self.sparse is not None:
            total += self.sparse.size_bytes()
        if self.a is not None:
            total += self.a.numel() * 2 + self.b.numel() * 2
        return total


def compress_matrix(x: torch.Tensor, policy: CompressionPolicy, kind: str,
                    rank: int | None = None, key=None) -> CompressedMatrix:
    """Compress ``x`` [..., n, d] as the ``kind`` ('k' or 'v') cache tensor;
    leading dims are independent matrices.  ``key`` picks the power
    iteration's start matrix (None: the reference's ``PRNGKey(0)``)."""
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
        a, b = lr.power_iteration(resid, r, policy.power_iters, key)
        a = a.to(torch.bfloat16)
        b = b.to(torch.bfloat16)
    return CompressedMatrix(qt=qt, sparse=sparse, a=a, b=b)


def decompress_matrix(cm: CompressedMatrix, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct ``deq(D̂) + A·Bᵀ + S`` (f32 sums), cast to ``dtype``."""
    xh = q.dequantize(cm.qt)
    if cm.a is not None:
        xh = xh + lr.apply_lowrank(cm.a, cm.b)
    if cm.sparse is not None:
        xh = xh + ol.densify(cm.sparse)
    return xh.to(dtype)


def approx_error(x: torch.Tensor, policy: CompressionPolicy, kind: str = "k",
                 rank: int | None = None) -> torch.Tensor:
    """Relative Frobenius error ``‖x − x̂‖ / max(‖x‖, 1e-8)`` of ``policy`` on
    ``x``, in f32, as a 0-d tensor on ``x``'s device (0 for the fp16 policy)."""
    if policy.is_fp16:
        return torch.zeros((), device=x.device)
    xh = decompress_matrix(compress_matrix(x, policy, kind, rank))
    xf = x.to(torch.float32)
    return torch.linalg.vector_norm(xf - xh) / torch.clamp_min(torch.linalg.vector_norm(xf), 1e-8)
