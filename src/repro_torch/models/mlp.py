"""SwiGLU feed-forward (port of ``repro.models.mlp.mlp_apply``, llama kind)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["mlp_apply"]


def mlp_apply(layer, x: torch.Tensor) -> torch.Tensor:
    """``silu(x W_gate) * (x W_up) W_down`` in the activation dtype; ``layer``
    holds ``w_gate``/``w_up`` [d, ff] and ``w_down`` [ff, d]."""
    h = F.silu(x @ layer.w_gate) * (x @ layer.w_up)
    return h @ layer.w_down
