"""PowerSGD low-rank gradient compression across the ``pod`` axis (port of
``repro.optim.grad_compress``).

Vogels et al. (2019), the power-iteration solver GEAR cites for its
SVDSolver (Algorithm 2), applied to distributed training: each pod's
gradient (already exact over ``data`` within the pod) is factored as
``G ≈ A Bᵀ`` (rank r, with error feedback), and only the factors cross the
inter-pod links (``r·(n+m)`` elements instead of ``n·m``).

The arithmetic is the reference's, step for step: the mean of A and the
mean of B over the pods are taken separately and then multiplied; the error
feedback stays local to each pod; matrices of fewer than ``min_size``
elements, and 1-D leaves, take an exact mean.  Each leaf collapses its
leading dims (``[..., n, m] -> [n', m]``), and the final sweep orthonormalizes
by modified Gram-Schmidt.

Start matrices.  The reference draws leaf ``i``'s ``B₀ [m, r]`` from
``normal(fold_in(fold_in(PRNGKey(17), step), i))``, a draw torch cannot
repeat, so :func:`compressed_psum` takes them as an argument keyed by
parameter name; :func:`draw_inits` is the training step's draw: a CPU
``torch.Generator`` seeded from (17, step, i), ``i`` the leaf's index in
``named_parameters()`` order, the same on every process and device.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from repro_torch.core import lowrank

__all__ = ["CompressorConfig", "init_error_feedback", "draw_inits", "compressed_psum"]


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    rank: int = 8
    power_iters: int = 2
    min_size: int = 65536
    axis: str = "pod"

    def compressible(self, leaf) -> bool:
        """A leaf (tensor or shape) of >= 2 dims and >= ``min_size`` elements."""
        shape = tuple(getattr(leaf, "shape", leaf))
        return len(shape) >= 2 and math.prod(shape) >= self.min_size


def init_error_feedback(params: dict, cfg: CompressorConfig) -> dict:
    """f32 zeros for each compressible leaf of ``params`` (name -> tensor)."""
    return {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items() if cfg.compressible(p)}


def _seed(*parts: int) -> int:
    s = 0
    for p in parts:
        s = (s * 1_000_003 + int(p)) % (1 << 62)
    return s


def draw_inits(shapes: dict, cfg: CompressorConfig, step: int, device=None) -> dict:
    """Start matrices ``B₀ [m, rank]`` (standard normal, f32) of the
    compressible leaves of ``shapes`` (name -> shape, in
    ``named_parameters()`` order), drawn on the CPU from a generator seeded
    from (17, ``step``, the leaf's index) and moved to ``device``."""
    out = {}
    for i, (name, shape) in enumerate(shapes.items()):
        if cfg.compressible(shape):
            gen = torch.Generator().manual_seed(_seed(17, step, i))
            out[name] = torch.randn(tuple(shape)[-1], cfg.rank, generator=gen).to(device)
    return out


def _pmean(t: torch.Tensor, group, n_dev: int) -> torch.Tensor:
    if n_dev > 1:
        dist.all_reduce(t, group=group)
        t = t / n_dev
    return t


def compressed_psum(grads: dict, ef: dict, cfg: CompressorConfig, group, inits: dict):
    """Mean of ``grads`` (name -> tensor) over the processes of ``group``
    (a process group: the ``pod`` axis's) with PowerSGD compression, from
    the error feedback ``ef`` (name -> f32, compressible leaves) and the
    start matrices ``inits`` (name -> [m, rank]).  Every process of the
    group must call it with the same leaves in the same order.

    Returns (mean grads, new error feedback, {"exact_bytes",
    "compressed_bytes", "n_dev"}: f32 scalars, the bytes that crossed the
    group exactly and as factors, and the group's size)."""
    n_dev = dist.get_world_size(group)
    exact_bytes, comp_bytes = 0, 0
    out, new_ef = {}, {}
    for name, g in grads.items():
        if not cfg.compressible(g):
            out[name] = _pmean(g.clone() if n_dev > 1 else g, group, n_dev)
            exact_bytes += g.numel() * 4
            continue
        m = g.shape[-1]
        gm = g.to(torch.float32).reshape(-1, m) + ef[name].reshape(-1, m)
        a, b = lowrank.power_iteration(gm, cfg.rank, cfg.power_iters, init=inits[name],
                                       orthonormalizer="mgs")
        a = _pmean(a.contiguous(), group, n_dev)
        b = _pmean(b.contiguous(), group, n_dev)
        approx = lowrank.apply_lowrank(a, b)
        new_ef[name] = (gm - approx).reshape(g.shape)          # local error feedback
        out[name] = approx.reshape(g.shape).to(g.dtype)
        comp_bytes += (a.numel() + b.numel()) * 4
    metrics = {"exact_bytes": torch.tensor(float(exact_bytes), dtype=torch.float32),
               "compressed_bytes": torch.tensor(float(comp_bytes), dtype=torch.float32),
               "n_dev": torch.tensor(float(n_dev), dtype=torch.float32)}
    return out, new_ef, metrics
