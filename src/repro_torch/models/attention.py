"""Multi-head attention with GQA and RoPE: full-sequence prefill through
``flash_prefill``, streaming prefill into a GEAR layer cache, and cached
decode over a dense or paged GEAR layer cache (port of
``repro.models.attention``'s flash, streaming and fused-decode paths).

Monolithic prefill always takes the flash path, on the card and on the CPU —
the path the reference takes on a TPU (and under ``fused="interpret"``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.kernels import ops
from repro_torch.models.common import rotate

__all__ = ["attention_prefill", "streaming_prefill_supported", "attention_prefill_streaming",
           "attention_decode"]


def _project_qkv(cfg: ModelConfig, layer, x: torch.Tensor, rope):
    """x [B, S, d] -> q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]; ``rope`` is the
    forward's (cos, sin) tables (``common.rope_tables``) for q and k."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    q = (x @ layer.wq).reshape(B, S, cfg.num_heads, dh)
    k = (x @ layer.wk).reshape(B, S, cfg.num_kv_heads, dh)
    v = (x @ layer.wv).reshape(B, S, cfg.num_kv_heads, dh)
    return rotate(q, *rope), rotate(k, *rope), v


def _sdpa_flash(cfg: ModelConfig, q, k, v):
    """q [B, S, Hq, Dh]; k, v [B, S, Hkv, Dh] -> [B, S, Hq, Dh].  Query rows
    are laid out (B, Hkv, G), so ``kv_repeat = G`` points each group at its
    shared K/V row without a broadcast copy."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qh = q.transpose(1, 2).reshape(B * Hq, S, Dh).contiguous()
    kh = k.transpose(1, 2).reshape(B * Hkv, S, Dh).contiguous()
    vh = v.transpose(1, 2).reshape(B * Hkv, S, Dh).contiguous()
    out = ops.flash_attention(qh, kh, vh, softcap=cfg.attn_logit_softcap, kv_repeat=Hq // Hkv)
    return out.reshape(B, Hq, S, Dh).transpose(1, 2)


def attention_prefill(cfg: ModelConfig, layer, x: torch.Tensor, rope):
    """Full-sequence causal attention.  Returns (out [B, S, d], (k, v)) with
    k/v laid out [B, Hkv, S, Dh] for the cache build."""
    q, k, v = _project_qkv(cfg, layer, x, rope)
    out = _sdpa_flash(cfg, q, k, v)
    B, S = x.shape[:2]
    out = out.reshape(B, S, cfg.q_dim).to(x.dtype) @ layer.wo
    return out, (k.transpose(1, 2), v.transpose(1, 2))


def streaming_prefill_supported(cfg: ModelConfig, cache_cfg: cache_lib.CacheConfig) -> bool:
    """Layers that can take the streaming prefill: the streaming cache layout
    (:func:`repro_torch.core.cache.streaming_supported`) and plain causal
    attention (the history scorer has no logit softcap)."""
    return cache_lib.streaming_supported(cache_cfg) and cfg.attn_logit_softcap == 0.0


def attention_prefill_streaming(cfg: ModelConfig, layer, x: torch.Tensor, rope,
                                cache_cfg: cache_lib.CacheConfig, *, padded_tail: bool = False,
                                true_len: int | None = None):
    """Streaming prefill of one attention layer: Q/K/V are projected one
    chunk at a time, so the full-sequence FP16 K/V never exists; every
    closed chunk is compressed in one fused event, and each chunk's queries
    attend the compressed history before it plus the chunk itself
    (:func:`repro_torch.core.cache.streaming_prefill_pipeline`).
    ``padded_tail`` / ``true_len`` take the length-bucketed path.  Returns
    (out [B, S, d], layer cache)."""
    B, S, _ = x.shape
    cos, sin = rope

    def project(t0: int, t1: int):
        q, k, v = _project_qkv(cfg, layer, x[:, t0:t1], (cos[t0:t1], sin[t0:t1]))
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    cache = cache_lib.init_layer_cache(cache_cfg, torch.bfloat16, x.device)
    cache, out = cache_lib.streaming_prefill_pipeline(
        cache_cfg, cache, S, cfg.num_heads, project, cfg.head_dim ** -0.5,
        tail_is_padded=padded_tail, true_n=true_len)
    out = out.transpose(1, 2).reshape(B, S, cfg.q_dim).to(x.dtype)
    return out @ layer.wo, cache


def attention_decode(cfg: ModelConfig, layer, x_t: torch.Tensor, rope, cache,
                     cache_cfg: cache_lib.CacheConfig, lengths: np.ndarray,
                     block_tables: cache_lib.BlockTables | None = None):
    """One-token attention against a layer cache.  x_t [B, 1, d]; ``rope``
    the (cos, sin) tables of the per-slot positions [B, 1]; ``lengths`` the
    host copy of the cache's per-slot lengths before this step.  Appends
    this token's K/V to ``cache`` in place and returns out [B, 1, d].  A
    :class:`~repro_torch.core.cache.PagedGEARLayerCache` needs the engine's
    ``block_tables``."""
    B = x_t.shape[0]
    q, k, v = _project_qkv(cfg, layer, x_t, rope)
    scale = cfg.head_dim ** -0.5
    if isinstance(cache, cache_lib.PagedGEARLayerCache):
        if block_tables is None:
            raise ValueError("paged cache decode needs block_tables")
        cache_lib.append_token_paged(cache_cfg, cache, block_tables.host, k[:, 0], v[:, 0],
                                     lengths)
        out = ops.gear_attend_paged(cache_cfg, cache, block_tables.device, q[:, 0], scale)
    else:
        cache_lib.append_token(cache_cfg, cache, k[:, 0], v[:, 0], lengths)
        out = ops.gear_attend(cache_cfg, cache, q[:, 0], scale=scale)
    return out.reshape(B, 1, cfg.q_dim) @ layer.wo
