"""Decoder stack: weights, monolithic or streaming prefill and one decode
step over dense or paged caches (port of ``repro.models.transformer`` for
the dense llama2, minicpm (RMSNorm + SwiGLU), starcoder2 (LayerNorm + GELU
MLP) and gemma (RMSNorm + GeGLU, its embedding scaled by sqrt(d_model));
gemma3, whose 5:1 local:global stack adds QK-norm, a RoPE base per layer
kind and sliding-window ring caches on its local layers; the VLM
paligemma, whose prompt is a bidirectional prefix of image embeddings
before the text; the audio musicgen, whose tokens are 4 codebook ids a
frame, embedded by 4 tables and read out by one head of 4 x vocab logits;
the MoE qwen3-moe and llama4-scout, whose blocks route each token to its
top-k experts in place of the MLP (:mod:`repro_torch.models.moe`); the
hybrid hymba, whose blocks run Mamba-2 SSM heads beside attention; and the
attention-free RWKV6, whose blocks are time mix + channel mix), and the
training forward of all of them (:func:`forward_train`).

Where the reference stacks per-layer parameters and caches over repeats and
drives them with ``lax.scan``, the port holds one :class:`Block` and one
layer cache per layer and loops in Python.  A hybrid layer's cache is the
pair ``(GEARLayerCache, SSMState)``, as the reference's; an RWKV6 layer's
is its :class:`~repro_torch.models.rwkv.RWKVState`; a local layer's is a
:class:`~repro_torch.core.cache.WindowLayerCache` (:func:`cache_cfg_for`).  Activations run in
bf16 (``COMPUTE_DTYPE``, as the reference); every product casts its weight
matrix to the activations' dtype at use, as the reference does.  Serving
stores the matrices in bf16, which is what the reference computes with
after that cast (the cast is then a no-op); training keeps f32 masters
(``Transformer(..., dtype=torch.float32)``), as the reference's
``init_params``.  Norm scales and biases, the SSM's per-head vectors, an MoE router and an
audio model's embedding tables stay f32.  The SSM's ``conv_w``
stays f32 too: the reference's prefill casts it to bf16 at use, its decode
uses it in f32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (apply_norm, layernorm, resolve_device, rope_tables,
                                      rowwise)
from repro_torch.models.mlp import GATED_KINDS, MLP_KINDS, mlp_apply

__all__ = ["COMPUTE_DTYPE", "Block", "RWKVBlock", "Transformer", "check_supported",
           "check_serving", "is_hybrid", "layer_kinds", "cache_cfg_for", "init_caches",
           "local_cache_cfg", "embed_tokens", "final_norm", "logits_from_hidden", "forward_prefill",
           "decode_tokens", "pick_q_chunk", "forward_train"]

COMPUTE_DTYPE = torch.bfloat16


def is_hybrid(cfg: ModelConfig) -> bool:
    """Blocks run SSM heads in parallel with attention (hymba)."""
    return cfg.ssm and cfg.hybrid_parallel


def layer_kinds(cfg: ModelConfig) -> list:
    """The kind of every layer, in order: layer ``i`` is position
    ``i % len(layer_pattern)`` of the pattern ("global", "local" or "rwkv")."""
    unit = cfg.layer_pattern
    return [unit[i % len(unit)] for i in range(cfg.num_layers)]


def check_serving(cfg: ModelConfig, layout: str = "dense") -> None:
    """Raise for a cache layout this model cannot take, with the reference's
    reasons: a hybrid and an RWKV6 model serve on the dense layout only (a
    hybrid takes either prefill mode, unbucketed; an RWKV6 model's streaming
    prefill is its monolithic one, as in the reference)."""
    if cfg.rwkv and layout == "paged":
        raise ValueError("paged layout: no GEAR-compressible attention layer in "
                         f"pattern {cfg.layer_pattern!r}")
    if is_hybrid(cfg) and layout == "paged":
        raise NotImplementedError("hybrid SSM recurrent state is not chunk-decomposable; "
                                  "serve it with layout='dense'")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves every family of the reference: dense decoders
    (llama2, minicpm, starcoder2, gemma, gemma3: SwiGLU / GeGLU / GELU MLP
    under RMSNorm or LayerNorm, global or 5:1 local:global attention,
    optional QK-norm), the VLM paligemma (a dense decoder behind a
    bidirectional prefix of image embeddings), the audio musicgen (a dense
    decoder over ``num_codebooks`` codebooks), the MoE qwen3-moe and
    llama4-scout (text, SwiGLU / RMSNorm, optional QK-norm, global layers),
    the hybrid hymba (global attention beside parallel SSM heads, RMSNorm /
    SwiGLU) and attention-free RWKV6 stacks; any other combination raises."""
    modality = {"vlm": "vlm", "audio": "audio"}.get(cfg.family, "text")
    dense_ok = (cfg.family in ("dense", "vlm", "audio") and not cfg.ssm and not cfg.moe
                and cfg.mlp_kind in MLP_KINDS and cfg.norm in ("rmsnorm", "layernorm")
                and cfg.modality == modality and (cfg.num_codebooks > 0) == (modality == "audio"))
    moe_ok = (cfg.family == "moe" and cfg.moe and not cfg.ssm and cfg.mlp_kind == "swiglu"
              and cfg.norm == "rmsnorm" and cfg.layer_pattern == ("global",)
              and cfg.modality == "text" and 0 < cfg.moe_top_k <= cfg.num_experts)
    hybrid_ok = (cfg.family == "hybrid" and is_hybrid(cfg) and cfg.mlp_kind == "swiglu"
                 and cfg.norm == "rmsnorm" and cfg.layer_pattern == ("global",)
                 and not cfg.qk_norm and cfg.modality == "text")
    rwkv_ok = (cfg.family == "ssm" and cfg.rwkv and cfg.mlp_kind == "rwkv_cm"
               and cfg.norm == "rmsnorm" and cfg.modality == "text")
    if not ((dense_ok and not cfg.rwkv) or moe_ok or hybrid_ok or rwkv_ok):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense decoders (SwiGLU / GeGLU / GELU MLP, RMSNorm / "
            "LayerNorm, global or local:global attention, optional QK-norm) with text, a VLM "
            "prefix or audio codebooks, MoE RMSNorm/SwiGLU global-attention decoders, hybrid "
            "(parallel SSM) RMSNorm/SwiGLU ones and RWKV6; this combination is none of them")


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


def _norm_params(cfg: ModelConfig, device):
    """(scale, bias) of one norm at the reference's init (``norm_params``):
    RMSNorm's gemma-style ``(1 + scale)`` gain has scale 0 and no bias;
    LayerNorm has scale 1 and bias 0, in f32."""
    d = cfg.d_model
    if cfg.norm == "layernorm":
        return (_param(torch.ones(d, dtype=torch.float32, device=device)),
                _param(torch.zeros(d, dtype=torch.float32, device=device)))
    return _param(torch.zeros(d, dtype=torch.float32, device=device)), None


class Block(nn.Module):
    """One decoder layer's weights (``[d_in, d_out]`` matrices, as the
    reference): norms ``ln1`` / ``ln2`` (scales; ``ln1_bias`` / ``ln2_bias``
    for LayerNorm, else None), attention (``q_norm`` / ``k_norm`` with
    QK-norm, else None), and the MLP (``w_gate`` for the gated kinds only,
    else None) or, in an MoE model, ``moe`` (a
    :class:`~repro_torch.models.moe.MoE`; the MLP's matrices are then None)."""

    def __init__(self, cfg: ModelConfig, device, dtype=COMPUTE_DTYPE):
        super().__init__()
        d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff

        def mat(*shape):
            return _param(torch.zeros(shape, dtype=dtype, device=device))

        self.cfg, self.norm, self.mlp_kind = cfg, cfg.norm, cfg.mlp_kind
        self.ln1, self.ln1_bias = _norm_params(cfg, device)
        self.ln2, self.ln2_bias = _norm_params(cfg, device)
        self.wq, self.wk, self.wv, self.wo = mat(d, qd), mat(d, kvd), mat(d, kvd), mat(qd, d)
        # QK-norm scales over a head's Dh, f32 zeros (the (1 + scale) gain), as the reference
        self.q_norm = self.k_norm = None
        if cfg.qk_norm:
            self.q_norm, self.k_norm = (
                _param(torch.zeros(cfg.head_dim, dtype=torch.float32, device=device))
                for _ in range(2))
        self.moe = moe_lib.MoE(cfg, device, dtype) if cfg.moe else None
        self.w_gate = self.w_up = self.w_down = None
        if not cfg.moe:
            self.w_gate = mat(d, ff) if cfg.mlp_kind in GATED_KINDS else None
            self.w_up, self.w_down = mat(d, ff), mat(ff, d)
        if is_hybrid(cfg):
            H, dinner = cfg.num_heads, cfg.q_dim

            def vec(fill):
                return _param(torch.full((H,), fill, dtype=torch.float32, device=device))

            self.w_in, self.w_out = mat(d, 2 * dinner), mat(dinner, d)
            self.w_bcdt = mat(dinner, H * (2 * cfg.ssm_state + 1))
            self.conv_w = _param(torch.zeros(cfg.ssm_conv, dinner, dtype=torch.float32,
                                              device=device))
            # the reference's init (ssm.ssm_params): exp(a_log) = 1, softplus(-1) decay
            self.a_log, self.dt_bias, self.d_skip = vec(0.0), vec(-1.0), vec(1.0)

    def norm1(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.ln1, self.ln1_bias, self.norm)

    def norm2(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(x, self.ln2, self.ln2_bias, self.norm)

    def mlp(self, x: torch.Tensor) -> torch.Tensor:
        """The MLP, or the MoE layer's output (its aux loss is not served)."""
        if self.moe is not None:
            return moe_lib.moe_apply(self.cfg, self.moe, x)[0]
        return mlp_apply(self, x, self.mlp_kind)


class RWKVBlock(nn.Module):
    """One RWKV6 layer's weights: LayerNorms ``ln1`` / ``ln2`` (scale 1,
    bias 0 in f32, applied by :meth:`ln1` / :meth:`ln2`) and the time-mix /
    channel-mix weights."""

    def __init__(self, cfg: ModelConfig, device, dtype=COMPUTE_DTYPE):
        super().__init__()
        d = cfg.d_model

        def vec(fill):
            return _param(torch.full((d,), fill, dtype=torch.float32, device=device))

        self.ln1_scale, self.ln1_bias = vec(1.0), vec(0.0)
        self.ln2_scale, self.ln2_bias = vec(1.0), vec(0.0)
        self.tm = rwkv_lib.TimeMix(cfg, device, dtype)
        self.cm = rwkv_lib.ChannelMix(cfg, device, dtype)

    def ln1(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.ln1_scale, self.ln1_bias)

    def ln2(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.ln2_scale, self.ln2_bias)


class Transformer(nn.Module):
    """All weights of a decoder; build with :meth:`random` or
    :func:`repro_torch.models.convert.params_from_reference`."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=COMPUTE_DTYPE):
        super().__init__()
        check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        d, v = cfg.d_model, cfg.vocab_size
        if cfg.modality == "audio":
            # one f32 table per codebook: the K lookups sum in f32 and round
            # once, as the reference's (f32 master) embedding does
            self.embed = _param(torch.zeros(cfg.num_codebooks, v, d, dtype=torch.float32,
                                            device=device))
            v = v * cfg.num_codebooks                  # the head's logits: K x vocab
        else:
            self.embed = _param(torch.zeros(v, d, dtype=dtype, device=device))
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(torch.zeros(d, v, dtype=dtype, device=device)))
        self.final_norm, self.final_norm_bias = _norm_params(cfg, device)
        block = RWKVBlock if cfg.rwkv else Block
        self.blocks = nn.ModuleList(block(cfg, device, dtype) for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @classmethod
    def random(cls, cfg: ModelConfig, seed: int = 0, device=None,
               dtype=COMPUTE_DTYPE) -> "Transformer":
        """Random weights from a seeded ``torch.Generator`` on the target
        device: normal draws scaled by ``fan_in ** -0.5`` as the reference's
        init (untruncated), drawn in place in the parameter's dtype (the
        matrices' ``dtype``: bf16 to serve, f32 masters to train).
        ``fan_in`` is the reference's: its ``dense_init`` default
        ``shape[0]`` (also the expert count E of an MoE's ``w_up`` /
        ``w_gate`` [E, d, ffe]), ``d`` for the embedding (``[V, d]``, an
        audio model's ``[K, V, d]``), and the dim a module's ``FAN_IN``
        names where the reference passes one: the LoRA rank 32 of RWKV6's
        ``mix_lora_b [5, 32, d]``, ffe of an MoE's ``w_down [E, ffe, d]``
        (a 2-D ``w_down`` / ``wo`` already has its input dim first); norms
        at the reference's
        ``norm_params``: RMSNorm scales zero (unit gain), LayerNorm scales 1
        and biases 0.
        Everything else keeps the reference's constants, set by the modules:
        the SSM's per-head vectors (``a_log`` 0, ``dt_bias`` -1, ``d_skip``
        1), RWKV6's mixes (0.5), ``w0`` (-2), ``u`` (0) and its norms' scale
        1 and bias 0."""
        model = cls(cfg, device, dtype)
        gen = torch.Generator(device=model.device).manual_seed(seed)
        fixed, fan_dim = set(), {"embed": -1}
        for prefix, mod in model.named_modules():
            fixed.update(f"{prefix}.{name}" for name in getattr(mod, "FIXED", ()))
            fan_dim.update({f"{prefix}.{name}": dim
                            for name, dim in getattr(mod, "FAN_IN", {}).items()})
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.dim() >= 2 and name not in fixed:
                    fan_in = p.shape[fan_dim.get(name, 0)]
                    p.normal_(0.0, fan_in ** -0.5, generator=gen)
        return model


def cache_cfg_for(cfg: ModelConfig, kind: str, policy: CompressionPolicy, batch: int,
                  capacity: int) -> cache_lib.CacheConfig:
    """The cache geometry of an attention layer of ``kind``, by the
    reference's rule: a local layer keeps a ring of its last
    ``local_window`` tokens (``kind="window"``, capacity ``min(capacity,
    local_window)``) whatever the policy; a global layer an FP16 cache under
    the fp16 policy and a GEAR cache under any other."""
    if kind == "local":
        return cache_lib.CacheConfig(batch=batch, kv_heads=cfg.num_kv_heads,
                                     head_dim=cfg.head_dim,
                                     capacity=min(capacity, cfg.local_window), policy=policy,
                                     kind="window", window=cfg.local_window)
    return cache_lib.CacheConfig(batch=batch, kv_heads=cfg.num_kv_heads,
                                 head_dim=cfg.head_dim, capacity=capacity, policy=policy,
                                 kind="fp16" if policy.is_fp16 else "gear")


def local_cache_cfg(ccfg: cache_lib.CacheConfig,
                    heads: attn_lib.HeadSplit | None) -> cache_lib.CacheConfig:
    """``ccfg`` with only this process's KV heads under a head split."""
    if heads is None:
        return ccfg
    return dataclasses.replace(ccfg, kv_heads=attn_lib.local_heads(ccfg.kv_heads, heads))


def init_caches(cfg: ModelConfig, policy: CompressionPolicy, batch: int, capacity: int,
                device, dtype=torch.bfloat16, layout: str = "dense", pool_pages: int = 0) -> list:
    """One empty layer cache per layer, by its kind (:func:`cache_cfg_for`):
    a dense :class:`~repro_torch.core.cache.GEARLayerCache` (an
    :class:`~repro_torch.core.cache.FP16LayerCache` under the fp16 policy)
    or a :class:`~repro_torch.core.cache.WindowLayerCache` ring for a local
    layer.  With ``layout="paged"`` every layer that can be paged (a GEAR
    cache) becomes a :class:`~repro_torch.core.cache.PagedGEARLayerCache`
    whose pool holds ``pool_pages`` pages (page 0 reserved), all addressed
    by one engine-owned block table, while window rings stay dense in the
    mixed tree, as the reference's ``_unit_cache``; a model with no such
    layer (the fp16 policy) raises the reference's ``ValueError``.  A hybrid
    layer's cache is the pair (attention cache, zero
    :class:`~repro_torch.models.ssm.SSMState`); hybrids are dense-only.  An
    RWKV6 layer's is a zero :class:`~repro_torch.models.rwkv.RWKVState`
    whatever the policy (it touches no RWKV layer); RWKV6 is dense-only
    too."""
    if layout not in ("dense", "paged"):
        raise ValueError(f"layout must be dense/paged, got {layout!r}")
    check_serving(cfg, layout=layout)
    if cfg.rwkv:
        return [rwkv_lib.init_rwkv_state(cfg, batch, dtype, device)
                for _ in range(cfg.num_layers)]
    ccfgs = {kind: cache_cfg_for(cfg, kind, policy, batch, capacity)
             for kind in cfg.layer_pattern}
    pooled = {kind: layout == "paged" and cache_lib.paged_supported(c)
              for kind, c in ccfgs.items()}
    if layout == "paged" and not any(pooled.values()):
        raise ValueError("paged layout requires a compressed (GEAR) policy: fp16 caches "
                         "have no chunk pages to pool")
    caches = []
    for kind in layer_kinds(cfg):
        if pooled[kind]:
            caches.append(cache_lib.init_paged_layer_cache(ccfgs[kind], pool_pages, dtype,
                                                           device))
            continue
        c = cache_lib.init_layer_cache(ccfgs[kind], dtype, device)
        caches.append((c, ssm_lib.init_ssm_state(cfg, batch, dtype, device))
                      if is_hybrid(cfg) else c)
    return caches


def final_norm(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    return apply_norm(x, model.final_norm, model.final_norm_bias, model.cfg.norm)


def embed_tokens(model: Transformer, tokens: torch.Tensor,
                 img_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Rows of the embedding table in ``COMPUTE_DTYPE``; a GeGLU model
    (gemma) scales them by ``sqrt(d_model)`` in f32 first, as the reference
    (whose table is f32: on the port's bf16 table the scaled embedding may
    differ from the reference's by one bf16 ulp).  A VLM given
    ``img_embeds`` [B, P, d] puts them, unscaled, before the text rows: [B,
    P + S, d]; any other model ignores them, as the reference does.  An
    audio model's ``tokens`` [B, S, K] hold one id per codebook: the K rows
    of its f32 tables sum in codebook order and round to bf16 once, bit for
    bit the reference's embedding."""
    if model.cfg.modality == "audio":
        x = model.embed[0][tokens[..., 0].to(torch.int64)]
        for i in range(1, model.cfg.num_codebooks):
            x = x + model.embed[i][tokens[..., i].to(torch.int64)]
        return x.to(COMPUTE_DTYPE)
    x = model.embed[tokens.to(torch.int64)]
    if model.cfg.mlp_kind == "geglu":
        x = x.to(torch.float32) * (model.cfg.d_model ** 0.5)
    if model.cfg.modality == "vlm" and img_embeds is not None:
        x = torch.cat([img_embeds.to(device=x.device, dtype=x.dtype), x], dim=1)
    return x.to(COMPUTE_DTYPE)


def logits_from_hidden(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    """Logits [..., V] of ``h`` [..., d]; an audio model's (its head untied,
    as musicgen's) [..., K, V]."""
    if model.lm_head is None:
        return h @ model.embed.to(h.dtype).T
    out = h @ model.lm_head.to(h.dtype)
    if model.cfg.modality == "audio":
        return out.reshape(out.shape[:-1] + (model.cfg.num_codebooks, model.cfg.vocab_size))
    return out


def pick_q_chunk(s: int, target: int = 512) -> int:
    """The largest of ``target``, ``target / 2``, ... that divides ``s``
    (at most ``s``), as the reference's query chunk."""
    c = min(target, s)
    while s % c:
        c //= 2
    return max(c, 1)


def _rope_by_kind(cfg: ModelConfig, positions: torch.Tensor) -> dict:
    """One RoPE (cos, sin) table per layer kind of the call (gemma3's local
    and global layers rotate with different bases), not one per layer."""
    return {kind: rope_tables(positions, cfg.head_dim, attn_lib.rope_theta_for(cfg, kind))
            for kind in set(cfg.layer_pattern)}


def forward_prefill(model: Transformer, tokens: torch.Tensor, policy: CompressionPolicy,
                    capacity: int, prefill_mode: str = "monolithic", padded_tail: bool = False,
                    true_len: int | None = None, start_pos: int = 0, init_caches=None,
                    img_embeds: torch.Tensor | None = None,
                    heads: attn_lib.HeadSplit | None = None):
    """Prefill of ``tokens`` [B, S] (an audio model's [B, S, K]; a VLM's
    ``img_embeds`` [B, P, d] before them: :func:`embed_tokens`).  Returns
    (logits [B, 1, V] of the last real position, [B, 1, K, V] for audio, one
    filled layer cache per layer).

    ``prefill_mode="monolithic"``: full-sequence attention, then one batched
    compression event per layer.  ``"streaming"``: each layer that can
    (:func:`~repro_torch.models.attention.streaming_prefill_supported`)
    compresses its closed chunks first and attends the history in compressed
    form; any other layer (a local layer's window, a VLM's prefix) takes the
    monolithic prefill inside the same forward, as the reference's.  Both
    build the same caches.  A hybrid's streaming layer runs attention
    through the streaming pipeline and its SSM heads on the whole normed
    input beside it, as the reference does.  A VLM's first
    ``num_prefix_tokens`` positions attend each other both ways, whether or
    not they hold image rows (the reference's rule: a continuous-batching
    request carries no image).

    ``start_pos`` > 0 is the suffix entry of the prefix cache (streaming
    only): ``tokens`` are the tokens after a chunk-aligned cached prefix,
    ``init_caches`` the per-layer caches with the prefix chunks spliced in,
    and positions start at ``start_pos``.  ``padded_tail`` / ``true_len``
    (streaming only) are the length-bucketing hooks: ``tokens`` is
    right-padded to a chunk multiple, the padded block stays out of
    compression, lengths and the returned logits come from position
    ``true_len - 1`` of this call's tokens.  Both need every layer to
    stream, and neither can resume a recurrent state, so both raise for
    RWKV6, hybrid, local:global and VLM models (which therefore prefill
    unbucketed), as in the reference.

    ``heads`` (a mesh's ``model`` axis splitting the cache's KV heads, or
    RWKV6's per-head state): each attention layer computes this process's
    block of heads and caches only those
    (:class:`~repro_torch.models.attention.HeadSplit`)."""
    if prefill_mode not in ("monolithic", "streaming"):
        raise ValueError(f"prefill_mode must be monolithic/streaming, got {prefill_mode!r}")
    if start_pos and prefill_mode != "streaming":
        raise ValueError("start_pos > 0 requires prefill_mode='streaming'")
    if padded_tail and prefill_mode != "streaming":
        raise ValueError("padded_tail requires prefill_mode='streaming'")
    cfg = model.cfg
    if cfg.rwkv and (start_pos or padded_tail):
        raise ValueError("suffix/bucketed prefill cannot resume an RWKV state")
    x = embed_tokens(model, tokens, img_embeds)
    if cfg.rwkv:
        caches = []
        for blk in model.blocks:
            h, (shift_tm, wkv) = rwkv_lib.time_mix_apply(cfg, blk, blk.ln1(x), heads=heads)
            x = x + h
            h, shift_cm = rwkv_lib.channel_mix_apply(cfg, blk, blk.ln2(x))
            x = x + h
            caches.append(rwkv_lib.RWKVState(shift_tm=shift_tm.to(torch.bfloat16),
                                             shift_cm=shift_cm.to(torch.bfloat16), wkv=wkv))
        return logits_from_hidden(model, final_norm(model, x)[:, -1:, :]), caches
    hybrid = is_hybrid(cfg)
    B, S, _ = x.shape
    positions = torch.arange(start_pos, start_pos + S, dtype=torch.int32, device=x.device)
    ropes = _rope_by_kind(cfg, positions)
    prefix_len = cfg.num_prefix_tokens if cfg.modality == "vlm" else 0   # image rows
    ccfgs = {kind: local_cache_cfg(cache_cfg_for(cfg, kind, policy, B, capacity), heads)
             for kind in cfg.layer_pattern}
    stream = {kind: prefill_mode == "streaming"
              and attn_lib.streaming_prefill_supported(cfg, kind, c) for kind, c in ccfgs.items()}
    if start_pos or padded_tail:
        for kind, ok in stream.items():
            if not ok:
                raise ValueError("suffix/bucketed prefill requires every layer to support the "
                                 f"streaming pipeline (kind={kind!r} does not)")
    if hybrid and (start_pos or padded_tail):
        raise ValueError("suffix/bucketed prefill cannot resume a hybrid SSM state")
    if init_caches is not None and len(init_caches) != len(model.blocks):
        raise ValueError(f"{len(init_caches)} initial caches for {len(model.blocks)} layers")
    caches = []
    for i, (blk, kind) in enumerate(zip(model.blocks, layer_kinds(cfg))):
        ccfg, rope = ccfgs[kind], ropes[kind]
        xin = blk.norm1(x)
        if stream[kind]:
            h, cache = attn_lib.attention_prefill_streaming(
                cfg, blk, xin, rope, ccfg, start_pos=start_pos, padded_tail=padded_tail,
                true_len=true_len, cache=None if init_caches is None else init_caches[i],
                heads=heads)
        else:
            h, (k, v) = attn_lib.attention_prefill(cfg, blk, xin, rope, kind, prefix_len, heads)
            cache = cache_lib.prefill_layer_cache(
                ccfg, cache_lib.init_layer_cache(ccfg, torch.bfloat16, x.device), k, v)
        if hybrid:
            h2, ssm_state = ssm_lib.ssm_apply(cfg, blk, xin)
            h = (h + h2) * 0.5
            cache = (cache, ssm_state)
        x = x + h
        xin2 = blk.norm2(x)
        # an MoE layer's capacity couples the rows and its expert products run
        # on [E, C, d] whatever the row count, so it takes no rowwise padding
        x = x + (rowwise(blk.mlp, xin2) if stream[kind] and not cfg.moe else blk.mlp(xin2))
        caches.append(cache)
    x = final_norm(model, x)
    last = S if true_len is None else int(true_len)
    return logits_from_hidden(model, x[:, last - 1:last, :]), caches


def decode_tokens(model: Transformer, tokens: torch.Tensor, caches: list, pos,
                  policy: CompressionPolicy, capacity: int, lengths=None,
                  block_tables: cache_lib.BlockTables | None = None,
                  fused: str = "auto", heads: attn_lib.HeadSplit | None = None) -> torch.Tensor:
    """One decode step.  tokens [B, 1] ([B, 1, K] for audio); ``pos`` [B]
    per-slot absolute
    positions; ``lengths`` the host copy of the caches' per-slot lengths
    (read from the first layer cache, one device sync per step, when not
    given: every layer's ``length``, a window ring's included, advances by
    one token per step); ``block_tables`` addresses the pool of every paged
    layer (window rings in a mixed tree stay dense and ignore it); ``fused``
    picks the attend path
    (:func:`~repro_torch.models.attention.attention_decode`).
    Updates ``caches`` in place; returns logits [B, 1, V] ([B, 1, K, V] for
    audio).  An RWKV6 model
    reads neither ``pos`` nor lengths: each layer advances its
    :class:`~repro_torch.models.rwkv.RWKVState` by one token.  ``heads``:
    the caches hold this process's KV heads (as :func:`forward_prefill`)."""
    cfg = model.cfg
    x = embed_tokens(model, tokens)
    if cfg.rwkv:
        for blk, st in zip(model.blocks, caches):
            h, new = rwkv_lib.time_mix_decode(cfg, blk, blk.ln1(x), st, heads=heads)
            x = x + h
            h, new = rwkv_lib.channel_mix_decode(cfg, blk, blk.ln2(x), new)
            x = x + h
            for name, t in new.tensors().items():
                getattr(st, name).copy_(t)
        return logits_from_hidden(model, final_norm(model, x))
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).reshape(-1).expand(B)
    ropes = _rope_by_kind(cfg, pos[:, None])                         # [B, 1, Dh/2] each
    hybrid = is_hybrid(cfg)
    if lengths is None:
        lengths = (caches[0][0] if hybrid else caches[0]).length.cpu().numpy()
    # a copy: for a CPU cache ``.cpu().numpy()`` shares the first layer's
    # ``length``, which its append advances before the next layer reads it
    lengths = np.array(lengths, dtype=np.int64)
    ccfgs = {kind: local_cache_cfg(cache_cfg_for(cfg, kind, policy, B, capacity), heads)
             for kind in cfg.layer_pattern}
    for blk, kind, cache in zip(model.blocks, layer_kinds(cfg), caches):
        gear, st = cache if hybrid else (cache, None)
        xin = blk.norm1(x)
        h = attn_lib.attention_decode(cfg, blk, xin, ropes[kind], gear, ccfgs[kind], lengths,
                                      block_tables, fused, heads)
        if hybrid:
            h2, new = ssm_lib.ssm_decode(cfg, blk, xin, st)
            st.conv.copy_(new.conv)
            st.state.copy_(new.state)
            h = (h + h2) * 0.5
        x = x + h
        x = x + blk.mlp(blk.norm2(x))
    x = final_norm(model, x)
    return logits_from_hidden(model, x)


def _save_products(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of the 2-D matrix products (every ``x @ W``; JAX's
    ``dots_with_no_batch_dims_saveable``) and recompute everything else,
    the attention's batched products included."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _block_train(cfg: ModelConfig, blk, kind: str, x: torch.Tensor, rope, positions,
                 prefix_len: int, q_chunk: int):
    """One layer of the training forward (the reference's
    ``_apply_block_train``): returns (x, aux), aux the layer's MoE
    load-balance loss (an f32 zero for any other layer)."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.rwkv:
        h, _ = rwkv_lib.time_mix_apply(cfg, blk, blk.ln1(x))
        x = x + h
        h, _ = rwkv_lib.channel_mix_apply(cfg, blk, blk.ln2(x))
        return x + h, zero
    xin = blk.norm1(x)
    h = attn_lib.attention_train(cfg, blk, xin, rope, positions, kind, prefix_len, q_chunk)
    if is_hybrid(cfg):
        h2, _ = ssm_lib.ssm_apply(cfg, blk, xin)
        h = (h + h2) * 0.5
    x = x + h
    xin2 = blk.norm2(x)
    if blk.moe is not None:
        m, aux = moe_lib.moe_apply(cfg, blk.moe, xin2)
        return x + m, aux
    return x + mlp_apply(blk, xin2, blk.mlp_kind), zero


def forward_train(model: Transformer, tokens: torch.Tensor,
                  img_embeds: torch.Tensor | None = None, remat: bool = False,
                  remat_policy: str = "full", q_chunk_target: int = 512):
    """The training forward (the reference's ``forward(mode="train")``):
    ``tokens`` [B, S] ([B, S, K] for audio; a VLM's text after its
    ``img_embeds`` [B, P, d]) -> (logits [B, S(+P), V] ([..., K, V] for
    audio) in bf16, aux), aux the MoE load-balance losses summed over layers
    (f32).  Attention is :func:`~repro_torch.models.attention.attention_train`;
    a hybrid's SSM heads run beside it and an RWKV6 layer runs its time and
    channel mix, their scans through ``models.linear_scan.chunked_scan`` (on
    a card the ``linear_scan_chunked`` kernel and its backward kernel).

    ``remat`` recomputes each layer in the backward
    (``torch.utils.checkpoint``); ``remat_policy="dots"`` keeps the outputs
    of the layer's matrix products (:func:`_save_products`), ``"full"``
    keeps nothing."""
    if remat_policy not in ("full", "dots"):
        raise ValueError(f"remat_policy must be full/dots, got {remat_policy!r}")
    cfg = model.cfg
    x = embed_tokens(model, tokens, img_embeds)
    S = x.shape[1]
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    ropes = {} if cfg.rwkv else _rope_by_kind(cfg, positions)
    prefix_len = cfg.num_prefix_tokens if cfg.modality == "vlm" else 0
    q_chunk = pick_q_chunk(S, q_chunk_target)
    context = (functools.partial(ckpt.create_selective_checkpoint_contexts, _save_products)
               if remat_policy == "dots" else ckpt.noop_context_fn)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for blk, kind in zip(model.blocks, layer_kinds(cfg)):
        args = (cfg, blk, kind, x, ropes.get(kind), positions, prefix_len, q_chunk)
        if remat:
            x, a = ckpt.checkpoint(_block_train, *args, use_reentrant=False, context_fn=context)
        else:
            x, a = _block_train(*args)
        aux = aux + a
    return logits_from_hidden(model, final_norm(model, x)), aux
