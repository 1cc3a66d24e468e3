"""Per-vector outlier extraction (the sparse matrix ``S`` of GEAR, Eq. 4).

Port of ``repro.core.outlier``.  ``Filter_s`` keeps the top and bottom
``k = ceil(s/2 · vec_len)`` entries of each vector in full precision:

* K orientation (``axis="token"``): vectors are channels, filtered along
  the token axis; values/indices are ``[..., d, 2k]``, indices in ``[0, n)``.
* V orientation (``axis="channel"``): vectors are tokens, filtered along
  the channel axis; values/indices are ``[..., n, 2k]``, indices in ``[0, d)``.

Indices must come out in ``lax.top_k`` order (values descending, ties to the
lowest index).  ``torch.topk`` promises no tie order, so selection runs as
``k`` masked max sweeps (:func:`iterative_topk`), which fix it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["SparseOutliers", "outlier_count", "iterative_topk",
           "filter_outliers", "filter_outliers_k", "densify"]


@dataclasses.dataclass(frozen=True)
class SparseOutliers:
    values: torch.Tensor
    indices: torch.Tensor
    axis: str
    n: int
    d: int
    k: int

    def size_bytes(self) -> int:
        """Two bytes a kept value and an int32 index, as the reference counts."""
        return self.values.numel() * 2 + self.indices.numel() * 4


def outlier_count(vec_len: int, s: float) -> int:
    """Entries kept per extreme for sparsity fraction ``s`` (e.g. 0.02)."""
    return max(1, math.ceil(vec_len * s / 2.0))


def iterative_topk(x: torch.Tensor, k: int, dim: int = -1):
    """Top-``k`` of ``x`` along ``dim`` in ``lax.top_k`` order.

    Returns (values f32, indices int64) with ``dim`` removed and ``k``
    appended last.  Each sweep takes the max, picks the lowest index that
    holds it, and masks that entry out.  A vector that holds a NaN has a
    NaN max that equals no entry: each of its sweeps gives (NaN, n) and
    masks nothing, as the reference's ``iterative_topk`` (the one its
    Pallas compression kernel runs) does; index n is a sink column.
    """
    work = x.to(torch.float32).movedim(dim, -1)
    n = work.shape[-1]
    work = torch.cat([work, work.new_full(work.shape[:-1] + (1,), -torch.inf)], dim=-1)
    iota = torch.arange(n + 1, device=x.device).expand(work.shape)
    vals, idxs = [], []
    for _ in range(k):
        v = work.amax(dim=-1, keepdim=True)
        i = torch.where(work == v, iota, n).amin(dim=-1, keepdim=True)
        vals.append(v)
        idxs.append(i)
        work.scatter_(-1, i, -3.4e38)
    return torch.cat(vals, dim=-1), torch.cat(idxs, dim=-1)


def _scatter_last(shape, idx: torch.Tensor, vals: torch.Tensor, dtype) -> torch.Tensor:
    """Scatter ``vals`` at ``idx`` along the last axis of zeros(shape) (set
    semantics; a duplicated index always carries the same value, the entry
    itself).  An index equal to the axis' length (a NaN vector's pick) is
    dropped, as the reference's scatter drops it."""
    out = torch.zeros(shape[:-1] + (shape[-1] + 1,), dtype=dtype, device=vals.device)
    return out.scatter_(-1, idx.to(torch.int64), vals.to(dtype))[..., :shape[-1]]


def filter_outliers(x: torch.Tensor, s: float, axis: str):
    n, d = x.shape[-2], x.shape[-1]
    vec_len = n if axis == "token" else d
    return filter_outliers_k(x, outlier_count(vec_len, s), axis)


def filter_outliers_k(x: torch.Tensor, k: int, axis: str):
    """Split ``x`` [..., n, d] into (outliers S, remainder x - S)."""
    n, d = x.shape[-2], x.shape[-1]
    if axis == "token":
        xt = x.transpose(-1, -2)
        vec_len = n
    elif axis == "channel":
        xt = x
        vec_len = d
    else:
        raise ValueError(f"axis must be 'token' or 'channel', got {axis!r}")
    if 2 * k > vec_len:
        raise ValueError(f"2k={2 * k} exceeds vector length {vec_len}")
    top_v, top_i = iterative_topk(xt, k)
    bot_v_neg, bot_i = iterative_topk(-xt, k)
    values = torch.cat([top_v, -bot_v_neg], dim=-1).to(x.dtype)
    indices = torch.cat([top_i, bot_i], dim=-1)
    dense_t = _scatter_last(xt.shape, indices, values, x.dtype)
    remainder_t = xt - dense_t
    remainder = remainder_t.transpose(-1, -2) if axis == "token" else remainder_t
    sp = SparseOutliers(values=values, indices=indices.to(torch.int32),
                        axis=axis, n=n, d=d, k=k)
    return sp, remainder


def densify(sp: SparseOutliers, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the dense [..., n, d] sparse matrix S (set semantics)."""
    lead = sp.values.shape[:-2]
    if sp.axis == "token":
        dense_t = _scatter_last(lead + (sp.d, sp.n), sp.indices, sp.values, dtype)
        return dense_t.transpose(-1, -2)
    return _scatter_last(lead + (sp.n, sp.d), sp.indices, sp.values, dtype)
