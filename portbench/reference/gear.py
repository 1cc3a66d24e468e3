"""GEAR's compression of one chunk of K or V, in plain PyTorch float32.

GEAR (arXiv:2403.05527, Algorithm 1) writes a chunk X [n_b, d] of the KV
cache as X ≈ D̂ + L + S:

* S, the outliers: the top and bottom ``k = max(1, ceil(s * len / 2))``
  entries of every vector (K: each channel along the chunk's tokens; V: each
  token along its channels) kept exactly, and zeroed in what is quantised;
* D̂, the backbone: asymmetric uniform quantisation of the remainder to
  ``bits`` bits with a min and a scale per group (K: per channel over
  ``k_group`` tokens; V: per token over ``v_group`` channels; a group of
  None is the whole vector), codes ``round((x - min) / scale)`` from the
  float32 scale ``(max - min) / (2**bits - 1)``, then the scale and min
  stored in ``stat_dtype``;
* L, the low rank: ``rank`` factors of the residual ``X - deq(D̂) - S`` by
  ``power_iters`` sweeps of power iteration from a fixed start matrix
  (:func:`portbench.reference.prng.pi_start`), orthonormalised on the last
  sweep.

The cache keeps the outlier values and the factors in ``store_dtype``, so
the reconstruction rounds them there; everything else is float32.  The
reconstruction ``deq(D̂) + A Bᵀ + S`` is all decode ever reads of a closed
chunk.  Written from the paper's description and the policy's parameters;
it shares no code with the program.
"""

from __future__ import annotations

import functools
import math

import torch

from portbench.reference import prng

F32 = torch.float32


def outlier_count(vec_len: int, sparsity: float) -> int:
    return max(1, math.ceil(vec_len * sparsity / 2.0))


def _rounded(x: torch.Tensor, dtype_name: str) -> torch.Tensor:
    """``x`` rounded to the named storage dtype and back to float32."""
    return x.to(getattr(torch, dtype_name)).to(F32)


def _split_outliers(x: torch.Tensor, k: int, vec_dim: int):
    """(S, x - S): the top-k and bottom-k entries of each vector along
    ``vec_dim`` kept in S, zeroed in the remainder; among equal values the
    lowest index is taken first (a stable sort)."""
    top = torch.sort(x, dim=vec_dim, descending=True, stable=True).indices.narrow(vec_dim, 0, k)
    bot = torch.sort(-x, dim=vec_dim, descending=True, stable=True).indices.narrow(vec_dim, 0, k)
    keep = torch.zeros_like(x, dtype=torch.bool)
    keep.scatter_(vec_dim, top, True)
    keep.scatter_(vec_dim, bot, True)
    s = torch.where(keep, x, torch.zeros_like(x))
    return s, x - s


def _quantise(x: torch.Tensor, bits: int, group_dim: int, group: int, stat_dtype: str):
    """Dequantised backbone of ``x`` [..., n, d] with one (min, scale) per
    ``group`` entries along ``group_dim`` (-2: a channel's tokens, -1: a
    token's channels)."""
    n, d = x.shape[-2], x.shape[-1]
    if group_dim == -2:
        xg = x.reshape(x.shape[:-2] + (n // group, group, d))
        red = -2
    else:
        xg = x.reshape(x.shape[:-2] + (n, d // group, group))
        red = -1
    mn = xg.amin(dim=red, keepdim=True)
    mx = xg.amax(dim=red, keepdim=True)
    scale = torch.clamp_min((mx - mn) * (1.0 / (2 ** bits - 1)), 1e-8)
    codes = torch.clamp(torch.round((xg - mn) / scale), 0, 2 ** bits - 1)
    deq = codes * _rounded(scale, stat_dtype) + _rounded(mn, stat_dtype)
    return deq.reshape(x.shape)


def _orthonormal(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of ``x`` [..., m, r]: Gram-Schmidt
    run twice, in float32."""
    cols = []
    for j in range(x.shape[-1]):
        v = x[..., j]
        for _ in range(2):
            for q in cols:
                v = v - (q * v).sum(dim=-1, keepdim=True) * q
        cols.append(v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                                        1e-30))
    return torch.stack(cols, dim=-1)


@functools.lru_cache(maxsize=16)
def _start(d: int, rank: int, device: str) -> torch.Tensor:
    return prng.pi_start(d, rank).to(device)


def _lowrank(r: torch.Tensor, rank: int, iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Factors (A [..., n, rank], B [..., d, rank]) of the residual ``r``
    [..., n, d] by power iteration; A is orthonormal and B = rᵀ A."""
    b = _start(r.shape[-1], rank, str(r.device)).expand(r.shape[:-2] + (r.shape[-1], rank))
    rt = r.transpose(-1, -2)
    for it in range(iters):
        last = it == iters - 1
        if last:
            b = _orthonormal(b)
        a = r @ b
        if last:
            a = _orthonormal(a)
        b = rt @ a
    return a, b


def reconstruct(x: torch.Tensor, kind: str, policy: dict, rank: int) -> torch.Tensor:
    """The reconstruction of chunks ``x`` [..., n_b, d] (float32) compressed
    as the ``kind`` ("k" or "v") cache tensor with ``rank`` low-rank factors
    (the prefill's ``rank`` or the decode close's ``rank_decode``)."""
    x = x.to(F32)
    n, d = x.shape[-2], x.shape[-1]
    vec_dim = -2 if kind == "k" else -1
    s = torch.zeros_like(x)
    rem = x
    if policy["sparse"]:
        s, rem = _split_outliers(x, outlier_count(x.shape[vec_dim], policy["sparsity"]),
                                 vec_dim)
    group = policy["k_group" if kind == "k" else "v_group"] or (n if kind == "k" else d)
    deq = _quantise(rem, policy["bits"], vec_dim, group, policy["stat_dtype"])
    out = deq + _rounded(s, policy["store_dtype"])
    if policy["lowrank"]:
        a, b = _lowrank(x - deq - s, rank, policy["power_iters"])
        out = out + (_rounded(a, policy["store_dtype"])
                     @ _rounded(b, policy["store_dtype"]).transpose(-1, -2))
    return out
