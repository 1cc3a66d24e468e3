"""Feed-forward variants (port of ``repro.models.mlp.mlp_apply``): SwiGLU
(llama), GeGLU (gemma) and the plain GELU MLP (starcoder2)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import gelu_tanh

__all__ = ["mlp_apply", "GATED_KINDS", "MLP_KINDS"]

GATED_KINDS = ("swiglu", "geglu")          # kinds with a ``w_gate``
MLP_KINDS = GATED_KINDS + ("gelu_mlp",)


def mlp_apply(layer, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    """The ``kind`` feed-forward in the activation dtype; ``layer`` holds
    ``w_up`` [d, ff], ``w_down`` [ff, d] and, for the gated kinds,
    ``w_gate`` [d, ff]: ``silu(x W_gate) * (x W_up) W_down`` (swiglu),
    ``gelu(x W_gate) * (x W_up) W_down`` (geglu), ``gelu(x W_up) W_down``
    (gelu_mlp), with the tanh GELU of ``jax.nn.gelu(approximate=True)``."""
    if kind == "swiglu":
        h = F.silu(x @ layer.w_gate.to(x.dtype)) * (x @ layer.w_up.to(x.dtype))
    elif kind == "geglu":
        h = gelu_tanh(x @ layer.w_gate.to(x.dtype)) * (x @ layer.w_up.to(x.dtype))
    elif kind == "gelu_mlp":
        h = gelu_tanh(x @ layer.w_up.to(x.dtype))
    else:
        raise ValueError(f"unknown mlp kind {kind!r}")
    return h @ layer.w_down.to(x.dtype)
