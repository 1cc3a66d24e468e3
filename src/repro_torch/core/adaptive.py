"""Adaptive low-rank budget allocation across heads (port of
``repro.core.adaptive``; beyond the paper, its §6.1 future work).

A uniform rank per Key/Value matrix ignores how unevenly residual energy is
spread over heads.  Given per-head quantization residuals, the total budget
``H * r_avg`` is shared by greedy water-filling on the residual spectra:
each rank unit goes to the head whose next singular value removes the most
energy.  Storage stays static-shaped (factors padded to ``max_rank`` columns,
those past a head's rank zeroed), and the budget equals uniform rank's.

``key`` picks the power iteration's start matrix, the reference's draw
(:func:`repro_torch.core.lowrank.pi_init`; None: ``PRNGKey(0)``).
``adaptive_error_vs_uniform`` is the evaluation entry point of
``benchmarks/bench_adaptive.py``.
"""

from __future__ import annotations

import torch

from repro_torch.core import lowrank

__all__ = ["allocate_ranks", "adaptive_lowrank", "adaptive_error_vs_uniform"]


def _head_spectra(resid: torch.Tensor, max_rank: int) -> torch.Tensor:
    """Top-``max_rank`` singular values per head.  resid [H, n, d] -> [H, max_rank]."""
    return torch.linalg.svdvals(resid.to(torch.float32))[..., :max_rank]


def allocate_ranks(spectra: torch.Tensor, budget: int) -> torch.Tensor:
    """Greedy water-filling.  spectra [H, max_rank] singular values (desc).

    Returns int32 ranks [H] summing to ``budget`` (<= H * max_rank).  The
    k-th rank unit of head h gains sigma_{h,k}^2, so giving the budget to the
    globally largest sigma^2 is the optimal assignment for Frobenius error
    under a total-rank constraint.  Ties go to the lower head-major index, as
    the reference's stable ``jnp.argsort``."""
    H, R = spectra.shape
    gains = torch.square(spectra).reshape(-1)
    order = torch.argsort(-gains, stable=True)
    chosen = torch.zeros(H * R, dtype=torch.bool, device=spectra.device)
    chosen[order[:budget]] = True
    return chosen.reshape(H, R).sum(dim=1).to(torch.int32)


def adaptive_lowrank(resid: torch.Tensor, avg_rank: int, max_rank: int | None = None,
                     iters: int = 6, key=None):
    """Per-head factors under a shared budget.  resid [H, n, d].

    Returns (A [H, n, max_rank], B [H, d, max_rank], ranks [H]); columns past
    each head's allocated rank are zeroed (A Bᵀ uses only rank_h of them)."""
    H, n, d = resid.shape
    max_rank = max_rank or min(4 * avg_rank, n, d)
    ranks = allocate_ranks(_head_spectra(resid, max_rank), budget=avg_rank * H)
    a, b = lowrank.power_iteration(resid, max_rank, iters=iters, key=key)
    mask = (torch.arange(max_rank, device=a.device)[None, :] < ranks[:, None]).to(a.dtype)
    return a * mask[:, None, :], b * mask[:, None, :], ranks


def adaptive_error_vs_uniform(resid: torch.Tensor, rank: int, key=None) -> dict:
    """Relative Frobenius error of uniform rank-``rank`` factors and of
    adaptive ones at the same budget."""
    base = torch.linalg.vector_norm(resid.to(torch.float32))
    a_u, b_u = lowrank.power_iteration(resid, rank, iters=6, key=key)
    err_u = torch.linalg.vector_norm(resid - lowrank.apply_lowrank(a_u, b_u)) / base
    a_a, b_a, ranks = adaptive_lowrank(resid, avg_rank=rank, key=key)
    err_a = torch.linalg.vector_norm(resid - lowrank.apply_lowrank(a_a, b_a)) / base
    return {"uniform": float(err_u), "adaptive": float(err_a),
            "ranks": [int(r) for r in ranks]}
