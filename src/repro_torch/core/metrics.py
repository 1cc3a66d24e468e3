"""KV-cache size accounting and masked error reductions (port of
``repro.core.metrics``).

The sizes are *analytic*, derived from the storage layout, as the paper
reports "KV size % of FP16": :func:`kv_size_breakdown` /
:func:`kv_size_fraction` cover every policy on an ``n`` tokens × ``d``
channels cache (one layer; layers scale linearly).  The masked Frobenius
reductions (:func:`masked_rel_frobenius`, :func:`masked_share`) are what the
fidelity probes read (ROADMAP queue 1, item 7).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.outlier import outlier_count
from repro_torch.core.policy import CompressionPolicy

__all__ = ["SizeBreakdown", "kv_size_breakdown", "kv_size_fraction",
           "masked_rel_frobenius", "masked_share"]

_EPS = 1e-12


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x).to(torch.float32).to(torch.float64)


def masked_rel_frobenius(approx, ref, mask) -> torch.Tensor:
    """``||approx − ref||_F / ||ref||_F`` over ``mask`` (broadcastable
    boolean).  The inputs are taken in f32, as the reference does, and the
    sums accumulated in f64, so the f32 result does not depend on the
    summation order; the reference's f32 sums are themselves ~1e-6 off."""
    m, a, r = _f64(mask), _f64(approx), _f64(ref)
    diff = (a.to(torch.float32) - r.to(torch.float32)).to(torch.float64)
    num = torch.sqrt(torch.sum((diff ** 2) * m))
    den = torch.sqrt(torch.sum((r ** 2) * m))
    return (num / torch.clamp(den, min=_EPS)).to(torch.float32)


def masked_share(part, whole, mask) -> torch.Tensor:
    """``||part||_F / ||whole||_F`` over ``mask``: the share a component
    (low-rank residual, sparse outliers) contributes to a reconstruction
    (f32 inputs, f64 sums, f32 result)."""
    m, p, w = _f64(mask), _f64(part), _f64(whole)
    num = torch.sqrt(torch.sum((p ** 2) * m))
    den = torch.sqrt(torch.sum((w ** 2) * m))
    return (num / torch.clamp(den, min=_EPS)).to(torch.float32)


FP16_BYTES = 2
IDX_BYTES = 4
STAT_BYTES = 2  # scale/zero stored bf16


@dataclasses.dataclass
class SizeBreakdown:
    quant_bytes: float = 0.0
    stat_bytes: float = 0.0      # scales + zeros
    buffer_bytes: float = 0.0    # fp16 streaming buffer / residual tokens
    lowrank_bytes: float = 0.0
    sparse_bytes: float = 0.0
    fp16_bytes: float = 0.0

    @property
    def total(self) -> float:
        return (self.quant_bytes + self.stat_bytes + self.buffer_bytes
                + self.lowrank_bytes + self.sparse_bytes + self.fp16_bytes)


def _ngroups(policy: CompressionPolicy, kind: str, n: int, d: int) -> float:
    scheme, group = policy.scheme_for(kind)
    if scheme == "per_token_group":
        return n * (d / group)
    if scheme == "per_channel":
        g = n if group is None else group
        return math.ceil(n / g) * d
    g = d if group is None else group
    return n * (d / g)


def kv_size_breakdown(policy: CompressionPolicy, n: int, d: int, num_heads: int = 1,
                      head_dim: int | None = None, per_chunk_lowrank: bool = False,
                      idealized_sparse: bool = True) -> SizeBreakdown:
    """Bytes to store one K *or* V matrix of n tokens × d channels.

    ``num_heads`` / ``head_dim`` set the head-wise low-rank factor count;
    ``per_chunk_lowrank`` accounts the serving engine's chunked variant
    instead of the paper's whole-prefill one; ``idealized_sparse`` counts
    exactly s·n·d outliers (uint8 index) instead of the fixed per-vector
    capacity."""
    bd = SizeBreakdown()
    if policy.is_fp16:
        bd.fp16_bytes = n * d * FP16_BYTES
        return bd
    if head_dim is None:
        head_dim = d // num_heads

    # the FP16 streaming buffer is accounted at its full allocation
    nb = policy.buffer_size
    compressed_n = (n // nb) * nb if per_chunk_lowrank else max(0, n - n % nb)
    bd.buffer_bytes = nb * d * FP16_BYTES

    bd.quant_bytes = compressed_n * d * policy.bits / 8.0
    bd.stat_bytes = 2 * STAT_BYTES * _ngroups(policy, "k", compressed_n, d)

    if policy.use_lowrank:
        r = policy.rank
        if per_chunk_lowrank:
            nchunks = compressed_n // nb
            r_g = policy.rank_decode
            bd.lowrank_bytes = num_heads * nchunks * (nb * r_g + head_dim * r_g) * FP16_BYTES
        else:
            bd.lowrank_bytes = num_heads * (compressed_n * r + head_dim * r) * FP16_BYTES

    if policy.use_sparse and idealized_sparse:
        bd.sparse_bytes = policy.sparsity * compressed_n * d * (FP16_BYTES + 1)
    elif policy.use_sparse:
        # per-vector fixed capacity 2k entries (value fp16 + uint8 index)
        k = outlier_count(compressed_n if policy.scheme_for("k")[0] == "per_channel" else d,
                          policy.sparsity)
        nvec = d if policy.scheme_for("k")[0] == "per_channel" else compressed_n
        bd.sparse_bytes = nvec * 2 * k * (FP16_BYTES + 1)
    return bd


def kv_size_fraction(policy: CompressionPolicy, n: int, d: int, num_heads: int = 1,
                     head_dim: int | None = None, per_chunk_lowrank: bool = False,
                     idealized_sparse: bool = True) -> float:
    """Compressed size as a fraction of the FP16 cache (the paper's 'KV size')."""
    bd = kv_size_breakdown(policy, n, d, num_heads, head_dim, per_chunk_lowrank,
                           idealized_sparse)
    return bd.total / (n * d * FP16_BYTES)
