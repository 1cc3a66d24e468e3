"""Shared model components: device choice, RMSNorm, LayerNorm, SiLU, RoPE
(port of ``repro.models.common``)."""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "rmsnorm", "layernorm", "silu", "rope_freqs", "rope_tables",
           "rotate", "apply_rope"]


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


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in x's dtype, as ``jax.nn.silu`` (in bf16 the
    sigmoid is rounded before the product, unlike ``F.silu``)."""
    return x * torch.sigmoid(x)


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
