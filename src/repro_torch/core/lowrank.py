"""Low-rank residual approximation via power iteration (paper Algorithm 2).

Port of ``repro.core.lowrank.power_iteration``: alternating ``A = X B`` /
``B = Xᵀ A`` sweeps with a QR orthonormalization on the final sweep,
batched over leading dims (the paper's head-wise decomposition).

The reference seeds ``B`` with ``jax.random.normal(key, (d, rank))``
(``key`` defaults to ``PRNGKey(0)``, which every caller on the serving path
takes), broadcast over the batch.  :func:`pi_init` draws the same values, bit
for bit, with :mod:`repro_torch.core.prng`, for any shape and key.

The QR is :func:`householder_q`, batched Householder with LAPACK's sign
conventions, on every device; it agrees with LAPACK's Q to rounding.  ``A·Bᵀ``
(and the decode path's ``(q·B)·Aᵀ``) would not depend on column signs or on
the basis of the span in any case.  ``orthonormalizer="mgs"`` takes the
reference's modified Gram-Schmidt (:func:`_mgs_q`) instead, as its gradient
compressor (:mod:`repro_torch.optim.grad_compress`) does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.core import prng

__all__ = ["power_iteration", "householder_q", "pi_init", "apply_lowrank",
           "lowrank_approx", "svd_topr"]

ORTHONORMALIZERS = ("qr", "mgs")


def pi_init(d: int, rank: int, key=None) -> np.ndarray:
    """The reference's power-iteration start ``jax.random.normal(key, (d,
    rank))`` in f32 (``key`` None: ``PRNGKey(0)``)."""
    return _pi_init_on(d, rank, _words(key), torch.device("cpu")).numpy().copy()


def _words(key) -> tuple[int, int]:
    return prng.key_words(prng.PRNGKey(0) if key is None else key)


@functools.lru_cache(maxsize=64)
def _pi_init_on(d: int, rank: int, words: tuple[int, int], device: torch.device) -> torch.Tensor:
    """:func:`pi_init` under the key ``words`` as a tensor on ``device``: drawn
    on the host and copied there once (every compression reuses it; a copy
    from pageable host memory at each one would stall the stream).  A
    constant of the process, so drawn outside any active dispatch mode: the
    dry run's op counter must not charge it to the step that first asks."""
    with _disable_current_modes():
        host = prng.normal(np.array(words, np.uint32), (d, rank))
    return host.to(device)


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


def _mgs_q(x: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the columns of ``x`` [..., m, r] by modified
    Gram-Schmidt, the reference's arithmetic: each column less its
    projections on the earlier basis vectors in turn, divided by its norm
    floored at 1e-12, in f32."""
    xf = x.to(torch.float32)
    cols = []
    for j in range(xf.shape[-1]):
        v = xf[..., j]
        for q in cols:
            v = v - torch.sum(q * v, dim=-1, keepdim=True) * q
        norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        cols.append(v / torch.clamp(norm, min=1e-12))
    return torch.stack(cols, dim=-1)


def power_iteration(x: torch.Tensor, rank: int, iters: int = 4, key=None,
                    orthonormalizer: str = "qr", init: torch.Tensor | None = None):
    """Approximate top-``rank`` factors of ``x`` [..., n, d] from the start
    matrix :func:`pi_init` ``(d, rank, key)`` (the reference's draw; ``key``
    None is its ``PRNGKey(0)``), or from ``init`` [d, rank] where the caller
    draws its own (not both), broadcast over the leading dims; the final sweep's
    orthonormalizer is :func:`householder_q` (``"qr"``) or :func:`_mgs_q`
    (``"mgs"``, which the reference runs unscaled, so no rescale here).

    Returns (A [..., n, rank], B [..., d, rank]) in f32 with ``A @ Bᵀ ≈ x_r``.
    """
    if orthonormalizer not in ORTHONORMALIZERS:
        raise ValueError(f"orthonormalizer must be one of {ORTHONORMALIZERS}, "
                         f"got {orthonormalizer!r}")
    n, d = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    xf = x.to(torch.float32)
    if init is not None and key is not None:
        raise ValueError("power_iteration: pass a key or an init, not both")
    b0 = (_pi_init_on(d, rank, _words(key), xf.device) if init is None
          else torch.as_tensor(init, dtype=torch.float32, device=xf.device))
    if tuple(b0.shape) != (d, rank):
        raise ValueError(f"power_iteration: init has shape {tuple(b0.shape)}, "
                         f"expected {(d, rank)}")
    b = b0.expand(lead + (d, rank))
    a = torch.zeros(lead + (n, rank), dtype=torch.float32, device=xf.device)
    for it in range(iters):
        last = it == iters - 1
        if last and orthonormalizer == "mgs":
            b = _mgs_q(b)
        elif last:
            # Q does not change when a column is scaled by a power of two (every
            # rounding scales with it), and at unit scale the QR's norms cannot
            # overflow: b has grown by sigma^2 a sweep (LAPACK's norms rescale)
            b = torch.ldexp(b, -torch.frexp(b.abs().amax(dim=-2, keepdim=True)).exponent)
            b = householder_q(b)
        a = xf @ b
        if last:
            a = _mgs_q(a) if orthonormalizer == "mgs" else householder_q(a)
        b = xf.transpose(-1, -2) @ a
    return a, b


def apply_lowrank(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Materialize ``A @ Bᵀ`` in f32."""
    return a.to(torch.float32) @ b.to(torch.float32).transpose(-1, -2)


def lowrank_approx(x: torch.Tensor, rank: int, iters: int = 4, key=None) -> torch.Tensor:
    """``A @ Bᵀ`` of :func:`power_iteration` on ``x`` [..., n, d] from the
    start matrix of ``key``, in f32."""
    return apply_lowrank(*power_iteration(x, rank, iters, key))


def svd_topr(x: torch.Tensor, rank: int) -> torch.Tensor:
    """Exact best rank-``rank`` approximation of ``x`` [..., n, d] in f32 (an
    oracle for tests and benchmarks, as in the reference)."""
    u, s, vh = torch.linalg.svd(x.to(torch.float32), full_matrices=False)
    return (u[..., :rank] * s[..., None, :rank]) @ vh[..., :rank, :]
