"""Shared model components: device choice, RMSNorm, LayerNorm, SiLU, the
tanh GELU, RoPE (port of ``repro.models.common``)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "rmsnorm", "layernorm", "apply_norm", "silu", "gelu_tanh",
           "rope_freqs", "rope_tables", "rotate", "apply_rope", "MIN_GEMM_ROWS", "rowwise"]

# cuBLAS chooses a GEMM's kernel, and with it the order of its sums, by the
# row count: on the H100 a token's row of a 64-row [64, 11008] x [11008,
# 4096] bf16 product differs in its last bits from the same row inside 128
# or more rows (every count from 128 to 1152 gives the same bits).  The
# streaming prefill runs its row-wise products on at least this many rows,
# so a token's activations do not depend on how many tokens share its
# prefill: a one-chunk prefix-cache suffix equals the cold prefill bit for bit.
MIN_GEMM_ROWS = 128


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent —
    nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is present; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def rowwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for a row-wise ``fn`` of x [B, S, d], run on at least
    ``MIN_GEMM_ROWS`` rows: zero rows are appended and their outputs dropped."""
    S = x.shape[1]
    if S >= MIN_GEMM_ROWS:
        return fn(x)
    return fn(torch.nn.functional.pad(x, (0, 0, 0, MIN_GEMM_ROWS - S)))[:, :S]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the reference's gemma-style ``(1 + scale)`` gain, in f32."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm ``scale * (x - mean) / sqrt(var + eps) + bias`` in f32,
    returned in x's dtype."""
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.to(torch.float32) + bias.to(torch.float32)
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None,
               kind: str) -> torch.Tensor:
    """The config's norm: ``"rmsnorm"`` (``bias`` unused) or ``"layernorm"``."""
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    if kind == "layernorm":
        return layernorm(x, scale, bias)
    raise ValueError(f"unknown norm {kind!r}")


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype, as ``jax.nn.silu`` (in bf16 the
    sigmoid is rounded before the product, unlike ``F.silu``)."""
    return x * torch.sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` in x's dtype and in its order of
    operations: ``x * (0.5 * (1 + tanh(c * (x + 0.044715 * x**3))))`` with
    ``c = sqrt(2 / pi)`` and every constant and intermediate in x's dtype (in
    bf16 each product and sum is rounded, unlike ``F.gelu``, which rounds
    once).  ``x**3`` is ``x * x * x``, as XLA expands the integer power."""
    def const(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device).to(x.dtype)
    cube = x * x * x
    inner = const(np.sqrt(2 / np.pi)) * (x + const(0.044715) * cube)
    cdf = const(0.5) * (const(1.0) + torch.tanh(inner))
    return x * cdf


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float):
    """RoPE (cos, sin) tables for ``positions`` [S] or [B, S]: [.., S, Dh/2]
    f32.  A forward computes them once and every layer rotates with them."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE tables from :func:`rope_tables` to x [B, S, H, Dh] or [B, S, Dh]."""
    if cos.dim() == 2:                          # shared positions -> [1, S, Dh/2]
        cos, sin = cos[None], sin[None]
    if x.dim() == 4:                            # head axis present
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding.  x [B, S, H, Dh] or [B, S, Dh]; positions [S]
    (shared across the batch) or [B, S] (per-slot, continuous batching)."""
    return rotate(x, *rope_tables(positions, x.shape[-1], theta))
