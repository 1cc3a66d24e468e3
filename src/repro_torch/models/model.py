"""Public model facade: prefill / decode / caches (port of
``repro.models.model.Model``'s serving half).  A hybrid model's per-layer
cache is the pair (GEAR cache, SSM state), an RWKV6 model's its
:class:`~repro_torch.models.rwkv.RWKVState` (the compression policy touches
none of its layers); the facade passes them through."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device

__all__ = ["Model", "build_model"]


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        tfm.check_supported(self.cfg)

    def init(self, seed: int = 0, device=None) -> tfm.Transformer:
        """Random weights from a seeded generator (CUDA unless ``device``
        names another)."""
        return tfm.Transformer.random(self.cfg, seed, device)

    @torch.inference_mode()
    def prefill(self, params: tfm.Transformer, batch: dict, policy: CompressionPolicy,
                capacity: int, prefill_mode: str = "monolithic", padded_tail: bool = False,
                true_len: int | None = None):
        """Prefill of ``batch["tokens"]`` [B, S] on the weights' device,
        ``prefill_mode`` "monolithic" or "streaming" (same caches; see
        :func:`repro_torch.models.transformer.forward_prefill`, also for the
        bucketing hooks ``padded_tail`` / ``true_len``).  Returns (logits
        [B, 1, V], per-layer caches)."""
        tokens = torch.as_tensor(batch["tokens"], device=params.device)
        return tfm.forward_prefill(params, tokens, policy, capacity, prefill_mode,
                                   padded_tail, true_len)

    @torch.inference_mode()
    def decode_step(self, params: tfm.Transformer, token_batch: dict, caches, pos,
                    policy: CompressionPolicy, capacity: int, lengths=None, block_tables=None):
        """One decode step; ``pos`` is a scalar or a per-slot [B] vector of
        absolute positions; ``block_tables`` (a
        :class:`~repro_torch.core.cache.BlockTables`) is required for caches
        built with ``layout="paged"``.  The caches advance in place; returns
        (logits [B, 1, V], caches)."""
        tokens = torch.as_tensor(token_batch["tokens"], device=params.device)
        logits = tfm.decode_tokens(params, tokens, caches, pos, policy, capacity, lengths,
                                   block_tables)
        return logits, caches

    def init_caches(self, policy: CompressionPolicy, batch: int, capacity: int, device=None,
                    layout: str = "dense", pool_pages: int = 0):
        return tfm.init_caches(self.cfg, policy, batch, capacity, resolve_device(device),
                               layout=layout, pool_pages=pool_pages)


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
