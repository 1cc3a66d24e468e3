"""Token sampling for the serving engine (port of ``repro.serving.sampling``)."""

from __future__ import annotations

import torch

from repro_torch.core import prng

__all__ = ["sample"]


def sample(logits: torch.Tensor, key, temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [..., V] -> int32 token ids [...] (text [B, V], audio [B, K, V]).

    Temperature 0 is greedy (ties to the lowest id, as ``jnp.argmax``).
    Above 0 the logits are divided by the temperature, all but the
    ``top_k`` largest (0: all) set to -1e30, and the token drawn with
    :func:`repro_torch.core.prng.categorical` under ``key`` (two uint32
    words, the reference's key data) on the logits' device: the reference's
    ``jax.random.categorical`` draw, bit for bit, on equal logits.
    """
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = logits.to(torch.float32)
    # a divisor on the logits' device: CUDA divides by a host scalar as a
    # product with its reciprocal, which rounds otherwise than the reference
    lg = lg / torch.full((), temperature, dtype=torch.float32, device=lg.device)
    if top_k:
        # past the vocabulary the reference's sort index clamps to the least: all kept
        kth = torch.topk(lg, min(top_k, lg.shape[-1]), dim=-1).values[..., -1:]
        lg = torch.where(lg < kth, torch.full_like(lg, -1e30), lg)
    return prng.categorical(key, lg).to(torch.int32)
