"""Token sampling for the serving engine (port of ``repro.serving.sampling``)."""

from __future__ import annotations

import torch

__all__ = ["sample"]


def sample(logits: torch.Tensor, temperature: float = 0.0, top_k: int = 0,
           generator: torch.Generator | None = None) -> torch.Tensor:
    """logits [..., V] -> int32 token ids [...].

    Temperature 0 is greedy (ties to the lowest id, as ``jnp.argmax``).
    Above 0 draws from ``generator``; its stream is not the reference's
    ``jax.random`` stream, so sampled tokens do not match the reference.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.to(torch.float32) / temperature
    if top_k:
        kth = torch.sort(lg, dim=-1).values[..., -top_k][..., None]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    probs = torch.softmax(lg, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    ids = torch.multinomial(flat, 1, generator=generator)
    return ids.reshape(probs.shape[:-1]).to(torch.int32)
