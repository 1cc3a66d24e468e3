"""Multi-head attention with GQA, RoPE and QK-norm: full-sequence prefill
through ``flash_prefill`` (causal, a local layer's sliding window, a VLM's
bidirectional prefix), streaming prefill into a GEAR layer cache, cached
decode over a dense or paged layer cache of any kind, and the training
path's differentiable full-sequence attention (port of
``repro.models.attention``'s flash, streaming, decode and chunked paths).

On a device mesh whose ``model`` axis splits the KV heads of the serving
cache, each serving path takes a :class:`HeadSplit`: the process projects
Q/K/V as usual, keeps its contiguous block of KV heads (and their
``kv_repeat`` query heads each), attends over its own cache slice, and
all-gathers the per-head outputs over ``model`` before the output
projection.  A head is computed exactly as without the split.

Monolithic prefill always takes the flash path, on the card and on the CPU —
the path the reference takes on a TPU (and under ``fused="interpret"``).
Training takes :func:`attention_train`, plain PyTorch that autograd
differentiates, as the reference trains through its XLA ``_sdpa_chunked``;
the ``flash_prefill`` kernel has no backward.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.kernels import ops
from repro_torch.models.common import rmsnorm, rotate, rowwise

__all__ = ["HeadSplit", "rope_theta_for", "attention_prefill", "attention_train",
           "streaming_prefill_supported", "attention_prefill_streaming", "attention_decode"]

NEG_INF = -1e30


def rope_theta_for(cfg: ModelConfig, kind: str) -> float:
    """gemma3-style dual RoPE: a local layer of a local:global stack rotates
    with the short-range base 10,000, every other layer with ``rope_theta``."""
    if kind == "local" and cfg.attn_pattern == "local_global":
        return 10_000.0
    return cfg.rope_theta


@dataclasses.dataclass(frozen=True)
class HeadSplit:
    """One process's share of every layer's heads on a mesh's ``model``
    axis: of ``count`` contiguous blocks of heads it computes block
    ``index``.  ``gather(t, dim)`` concatenates every process's ``t`` along
    ``dim`` in axis order (a collective over ``model``)."""

    index: int
    count: int
    gather: Callable

    def block(self, n: int) -> slice:
        """This process's block of ``n`` heads."""
        w = n // self.count
        return slice(self.index * w, (self.index + 1) * w)


def local_heads(n: int, heads: HeadSplit | None) -> int:
    """How many of ``n`` heads this process computes."""
    return n if heads is None else n // heads.count


def merge_heads(out: torch.Tensor, heads: HeadSplit | None) -> torch.Tensor:
    """Per-head outputs [..., H_local, Dh] -> [..., H * Dh]: flattened, and
    on a split gathered over ``model`` in head order."""
    out = out.reshape(out.shape[:-2] + (-1,))
    return out if heads is None else heads.gather(out, out.dim() - 1)


def _project_qkv(cfg: ModelConfig, layer, x: torch.Tensor, rope, heads: HeadSplit | None = None):
    """x [B, S, d] -> q [B, S, Hq, Dh], k/v [B, S, Hkv, Dh]; ``rope`` is the
    forward's (cos, sin) tables of this layer's kind (``common.rope_tables``)
    for q and k.  With QK-norm, q and k are RMS-normed over each head's Dh
    (the ``(1 + scale)`` gain) before the rotation, as the reference.  With
    ``heads``, only this process's block of KV heads and of query heads."""
    B, S, _ = x.shape
    dh = cfg.head_dim
    q = (x @ layer.wq.to(x.dtype)).reshape(B, S, cfg.num_heads, dh)
    k = (x @ layer.wk.to(x.dtype)).reshape(B, S, cfg.num_kv_heads, dh)
    v = (x @ layer.wv.to(x.dtype)).reshape(B, S, cfg.num_kv_heads, dh)
    if cfg.qk_norm:
        q, k = rmsnorm(q, layer.q_norm), rmsnorm(k, layer.k_norm)
    q, k = rotate(q, *rope), rotate(k, *rope)
    if heads is not None:
        q = q[:, :, heads.block(cfg.num_heads)]
        k, v = (t[:, :, heads.block(cfg.num_kv_heads)] for t in (k, v))
    return q, k, v


def _sdpa_flash(cfg: ModelConfig, q, k, v, kind: str, prefix_len: int):
    """q [B, S, Hq, Dh]; k, v [B, S, Hkv, Dh] -> [B, S, Hq, Dh].  Query rows
    are laid out (B, Hkv, G), so ``kv_repeat = G`` points each group at its
    shared K/V row without a broadcast copy.  The mask is the reference's:
    causal, a local layer's sliding window of ``local_window`` keys, and the
    first ``prefix_len`` positions attending each other both ways."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qh = q.transpose(1, 2).reshape(B * Hq, S, Dh).contiguous()
    kh = k.transpose(1, 2).reshape(B * Hkv, S, Dh).contiguous()
    vh = v.transpose(1, 2).reshape(B * Hkv, S, Dh).contiguous()
    out = ops.flash_attention(qh, kh, vh, window=cfg.local_window if kind == "local" else 0,
                              prefix_len=prefix_len, softcap=cfg.attn_logit_softcap,
                              kv_repeat=Hq // Hkv)
    return out.reshape(B, Hq, S, Dh).transpose(1, 2)


def attention_prefill(cfg: ModelConfig, layer, x: torch.Tensor, rope, kind: str = "global",
                      prefix_len: int = 0, heads: HeadSplit | None = None):
    """Full-sequence attention of a layer of ``kind`` ("global" or "local"),
    with a bidirectional prefix of ``prefix_len`` positions (a VLM's image
    tokens).  Returns (out [B, S, d], (k, v)) with k/v laid out [B, Hkv, S,
    Dh] for the cache build (this process's KV heads under ``heads``)."""
    q, k, v = _project_qkv(cfg, layer, x, rope, heads)
    out = merge_heads(_sdpa_flash(cfg, q, k, v, kind, prefix_len), heads)
    out = out.to(x.dtype) @ layer.wo.to(x.dtype)
    return out, (k.transpose(1, 2), v.transpose(1, 2))


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, kind: str, window: int,
          prefix_len: int) -> torch.Tensor:
    """[Sq, Sk] boolean, True = attend: causal, within ``window`` keys on a
    local layer, and both ways among the first ``prefix_len`` positions."""
    ok = q_pos[:, None] >= k_pos[None, :]
    if kind == "local":
        ok = ok & (q_pos[:, None] - k_pos[None, :] < window)
    if prefix_len:
        ok = ok | ((q_pos[:, None] < prefix_len) & (k_pos[None, :] < prefix_len))
    return ok


def _sdpa_chunked(cfg: ModelConfig, q, k, v, positions, kind: str, prefix_len: int,
                  q_chunk: int):
    """q [B, S, Hq, Dh]; k, v [B, S, Hkv, Dh] -> [B, S, Hq, Dh], by chunks of
    ``q_chunk`` queries against every key (port of the reference's
    ``_sdpa_chunked``).  The reference's mixed precision: bf16 scores scaled
    in bf16 (the optional softcap in f32), a row max that carries no
    gradient, an f32 exp and sum, bf16 weights and a bf16 product with V.
    A group's G query heads are stacked as G * q_chunk rows against their
    K/V head, so K and V are never repeated."""
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    bf = torch.bfloat16
    scale = torch.tensor(Dh ** -0.5, dtype=bf, device=q.device)
    neg = torch.tensor(NEG_INF, dtype=bf, device=q.device)
    cap = cfg.attn_logit_softcap
    kT = k.to(bf).permute(0, 2, 3, 1)                       # [B, Hkv, Dh, S]
    vT = v.to(bf).transpose(1, 2)                           # [B, Hkv, S, Dh]

    def block(q_blk, pos_blk):
        qc = q_blk.shape[1]
        qg = q_blk.to(bf).permute(0, 2, 1, 3).reshape(B, Hkv, G * qc, Dh)   # rows (g, q)
        s = (qg @ kT) * scale
        if cap:
            s = (cap * torch.tanh(s.to(torch.float32) / cap)).to(bf)
        m = _mask(pos_blk, positions, kind, cfg.local_window, prefix_len)
        s = torch.where(m.expand(G, qc, S).reshape(G * qc, S), s, neg)
        mx = s.amax(dim=-1, keepdim=True).detach()
        ex = torch.exp((s - mx).to(torch.float32))
        w = (ex / ex.sum(dim=-1, keepdim=True)).to(bf)
        o = (w @ vT).reshape(B, Hq, qc, Dh)
        return o.transpose(1, 2)

    if S <= q_chunk:
        return block(q, positions).to(q.dtype)
    if S % q_chunk:
        raise ValueError(f"q_chunk {q_chunk} does not divide S={S}")
    outs = [block(q[:, i:i + q_chunk], positions[i:i + q_chunk])
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1).to(q.dtype)


def attention_train(cfg: ModelConfig, layer, x: torch.Tensor, rope, positions: torch.Tensor,
                    kind: str = "global", prefix_len: int = 0,
                    q_chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention of the training forward (the reference's
    ``attention_train`` with ``impl="chunked"``): x [B, S, d] -> out [B, S,
    d].  ``rope`` holds the (cos, sin) tables of ``positions`` [S] for this
    layer's kind; the mask is the reference's (causal, a local layer's
    window, a VLM's bidirectional prefix) with the config's logit softcap.
    Never calls a kernel, so autograd sees every operation."""
    q, k, v = _project_qkv(cfg, layer, x, rope)
    out = _sdpa_chunked(cfg, q, k, v, positions, kind, prefix_len, q_chunk)
    B, S = x.shape[:2]
    return out.reshape(B, S, cfg.q_dim).to(x.dtype) @ layer.wo.to(x.dtype)


def streaming_prefill_supported(cfg: ModelConfig, kind: str,
                                cache_cfg: cache_lib.CacheConfig) -> bool:
    """Layers that can take the streaming prefill: the streaming cache layout
    (:func:`repro_torch.core.cache.streaming_supported`: not an FP16 or
    window cache, nor per-token K stats) and plain causal attention (the
    history scorer has no sliding window, bidirectional prefix or logit
    softcap).  Other layers fall back to the monolithic prefill inside the
    same forward, as in the reference."""
    return (cache_lib.streaming_supported(cache_cfg) and kind != "local"
            and cfg.attn_logit_softcap == 0.0
            and not (cfg.modality == "vlm" and cfg.num_prefix_tokens))


def attention_prefill_streaming(cfg: ModelConfig, layer, x: torch.Tensor, rope,
                                cache_cfg: cache_lib.CacheConfig, *, cache=None,
                                start_pos: int = 0, padded_tail: bool = False,
                                true_len: int | None = None, heads: HeadSplit | None = None):
    """Streaming prefill of one attention layer: Q/K/V are projected one
    chunk at a time, so the full-sequence FP16 K/V never exists; every
    closed chunk is compressed in one fused event, and each chunk's queries
    attend the compressed history before it plus the chunk itself
    (:func:`repro_torch.core.cache.streaming_prefill_pipeline`).

    ``start_pos`` > 0 is the suffix entry (prefix cache): ``x`` and ``rope``
    cover only the tokens after a chunk-aligned cached prefix, ``cache``
    holds the ``start_pos / n_b`` prefix chunks already spliced in, and the
    new chunks are stored after them.  ``padded_tail`` / ``true_len`` take
    the length-bucketed path (``true_len`` counts this call's tokens).
    ``heads``: this process's KV heads only (``cache_cfg`` counts them).
    Returns (out [B, S, d], layer cache)."""
    B, S, _ = x.shape
    nb = cache_cfg.chunk
    if start_pos % nb:
        raise ValueError(f"start_pos {start_pos} not aligned to chunk {nb}")
    if padded_tail and S % nb:
        raise ValueError(f"padded_tail needs S % n_b == 0 (S={S}, n_b={nb})")
    cos, sin = rope

    def project(t0: int, t1: int):
        q, k, v = _project_qkv(cfg, layer, x[:, t0:t1], (cos[t0:t1], sin[t0:t1]), heads)
        return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    if cache is None:
        cache = cache_lib.init_layer_cache(cache_cfg, torch.bfloat16, x.device)
    cache, out = cache_lib.streaming_prefill_pipeline(
        cache_cfg, cache, S, local_heads(cfg.num_heads, heads), project, cfg.head_dim ** -0.5,
        start_chunk=start_pos // nb, tail_is_padded=padded_tail, true_n=true_len)
    out = merge_heads(out.transpose(1, 2), heads).to(x.dtype)
    return rowwise(lambda o: o @ layer.wo.to(o.dtype), out), cache


def attention_decode(cfg: ModelConfig, layer, x_t: torch.Tensor, rope, cache,
                     cache_cfg: cache_lib.CacheConfig, lengths: np.ndarray,
                     block_tables: cache_lib.BlockTables | None = None, fused: str = "auto",
                     heads: HeadSplit | None = None):
    """One-token attention against a layer cache.  x_t [B, 1, d]; ``rope``
    the (cos, sin) tables of the per-slot positions [B, 1]; ``lengths`` the
    host copy of the cache's per-slot lengths before this step.  Appends
    this token's K/V to ``cache`` in place and returns out [B, 1, d].  A
    :class:`~repro_torch.core.cache.PagedGEARLayerCache` needs the engine's
    ``block_tables``.

    The attend path follows the reference's static, layout-based choice:
    with ``fused`` other than "off" and a cache in the kernel layout
    (:func:`repro_torch.kernels.ops.fused_supported`), ``gear_attend`` /
    ``gear_attend_paged`` (the ``gear_decode`` kernels on the card);
    otherwise the portable :func:`repro_torch.core.cache.attend` /
    ``attend_paged``.  It never depends on whether a kernel builds: a
    kernel that fails raises.  ``heads``: this process's KV heads only
    (``cache_cfg`` and ``cache`` count them)."""
    q, k, v = _project_qkv(cfg, layer, x_t, rope, heads)
    scale = cfg.head_dim ** -0.5
    kernel = fused != "off" and ops.fused_supported(cache_cfg)
    if isinstance(cache, cache_lib.PagedGEARLayerCache):
        if block_tables is None:
            raise ValueError("paged cache decode needs block_tables")
        cache_lib.append_token_paged(cache_cfg, cache, block_tables.host, k[:, 0], v[:, 0],
                                     lengths)
        attend = ops.gear_attend_paged if kernel else cache_lib.attend_paged
        out = attend(cache_cfg, cache, block_tables.device, q[:, 0], scale)
    else:
        cache_lib.append_token(cache_cfg, cache, k[:, 0], v[:, 0], lengths)
        attend = ops.gear_attend if kernel else cache_lib.attend
        out = attend(cache_cfg, cache, q[:, 0], scale)
    return merge_heads(out[:, None], heads) @ layer.wo.to(out.dtype)
