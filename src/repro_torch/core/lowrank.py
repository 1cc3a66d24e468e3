"""Low-rank residual approximation via power iteration (paper Algorithm 2).

Port of ``repro.core.lowrank.power_iteration``: alternating ``A = X B`` /
``B = Xᵀ A`` sweeps with a QR orthonormalization on the final sweep,
batched over leading dims (the paper's head-wise decomposition).

The reference seeds ``B`` with ``jax.random.normal(PRNGKey(0), (d, rank))``,
broadcast over the batch, and every caller on the serving path passes key 0.
Torch cannot reproduce that draw, so the package ships the reference's draws
as a table (``_pi_init.npz``, keyed by ``(d, rank)``); an unknown shape
raises rather than drawing from torch.

The QR is :func:`householder_q`, batched Householder with LAPACK's sign
conventions, on every device; it agrees with LAPACK's Q to rounding.  ``A·Bᵀ``
(and the decode path's ``(q·B)·Aᵀ``) would not depend on column signs or on
the basis of the span in any case.
"""

from __future__ import annotations

import functools
import pathlib

import numpy as np
import torch

__all__ = ["power_iteration", "householder_q", "pi_init", "apply_lowrank"]

_TABLE = pathlib.Path(__file__).with_name("_pi_init.npz")


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    with np.load(_TABLE) as z:
        return {k: z[k] for k in z.files}


def pi_init(d: int, rank: int) -> np.ndarray:
    """The reference's power-iteration init ``normal(PRNGKey(0), (d, rank))``."""
    name = f"d{d}_r{rank}"
    table = _table()
    if name not in table:
        raise KeyError(
            f"no power-iteration init for (d={d}, rank={rank}); the table "
            f"holds {sorted(table)} — regenerate it from jax.random.normal")
    return table[name]


@functools.lru_cache(maxsize=64)
def _pi_init_on(d: int, rank: int, device: torch.device) -> torch.Tensor:
    """:func:`pi_init` as a tensor on ``device``, copied there once (a copy
    from pageable host memory would stall the stream at every compression)."""
    return torch.from_numpy(pi_init(d, rank)).to(device)


def householder_q(x: torch.Tensor) -> torch.Tensor:
    """Thin Q of the batched QR of ``x`` [..., m, r] (r <= m), by Householder
    reflections with LAPACK's ``geqrf``/``orgqr`` conventions.

    Written as ``r`` batched steps instead of ``torch.linalg.qr``, which on
    CUDA runs one cuSOLVER call per matrix: a prefill compresses 32 heads x
    its chunks x K and V, thousands of [64|128, r] matrices per layer.
    """
    m, r = x.shape[-2], x.shape[-1]
    a = x.to(torch.float32).clone()
    vs, taus = [], []
    for j in range(r):
        alpha = a[..., j, j]
        tail = a[..., j + 1:, j]
        tail_norm = torch.linalg.vector_norm(tail, dim=-1)
        beta = -torch.copysign(torch.hypot(alpha, tail_norm), alpha)
        live = tail_norm > 0                       # else H_j = I (LAPACK: tau = 0)
        tau = torch.where(live, (beta - alpha) / beta, torch.zeros_like(beta))
        inv = torch.where(live, 1.0 / (alpha - beta), torch.zeros_like(beta))
        v = torch.cat([torch.ones_like(alpha)[..., None], tail * inv[..., None]], dim=-1)
        if j + 1 < r:                              # reflect the remaining columns
            rest = a[..., j:, j + 1:]
            w = (v[..., :, None] * rest).sum(dim=-2)
            a[..., j:, j + 1:] = rest - (tau[..., None] * w)[..., None, :] * v[..., :, None]
        vs.append(v)
        taus.append(tau)
    q = torch.eye(m, r, dtype=torch.float32, device=x.device).expand(x.shape[:-2] + (m, r)).clone()
    for j in reversed(range(r)):                   # Q = H_0 H_1 ... H_{r-1} I[:, :r]
        v, tau = vs[j], taus[j]
        rows = q[..., j:, :]
        w = (v[..., :, None] * rows).sum(dim=-2)
        q[..., j:, :] = rows - (tau[..., None] * w)[..., None, :] * v[..., :, None]
    return q


def power_iteration(x: torch.Tensor, rank: int, iters: int = 4):
    """Approximate top-``rank`` factors of ``x`` [..., n, d].

    Returns (A [..., n, rank], B [..., d, rank]) in f32 with ``A @ Bᵀ ≈ x_r``.
    """
    n, d = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    xf = x.to(torch.float32)
    b = _pi_init_on(d, rank, xf.device).expand(lead + (d, rank))
    a = torch.zeros(lead + (n, rank), dtype=torch.float32, device=xf.device)
    for it in range(iters):
        last = it == iters - 1
        if last:
            b = householder_q(b)
        a = xf @ b
        if last:
            a = householder_q(a)
        b = xf.transpose(-1, -2) @ a
    return a, b


def apply_lowrank(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Materialize ``A @ Bᵀ`` in f32."""
    return a.to(torch.float32) @ b.to(torch.float32).transpose(-1, -2)
