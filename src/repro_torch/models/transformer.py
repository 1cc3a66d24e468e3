"""Decoder stack: weights, monolithic or streaming prefill and one decode
step over dense or paged caches (port of ``repro.models.transformer`` for
global-attention RMSNorm/SwiGLU text decoders: dense llama2 and the hybrid
hymba, whose blocks run Mamba-2 SSM heads beside attention; and for the
attention-free RWKV6, whose blocks are time mix + channel mix).

Where the reference stacks per-layer parameters and caches over repeats and
drives them with ``lax.scan``, the port holds one :class:`Block` and one
layer cache per layer and loops in Python.  A hybrid layer's cache is the
pair ``(GEARLayerCache, SSMState)``, as the reference's; an RWKV6 layer's
is its :class:`~repro_torch.models.rwkv.RWKVState`.  Activations run in
bf16 (``COMPUTE_DTYPE``, as the reference); weight matrices are stored in
bf16, which is what the reference computes with after its cast at use, and
norm scales and the SSM's per-head vectors stay f32.  The SSM's ``conv_w``
stays f32 too: the reference's prefill casts it to bf16 at use, its decode
uses it in f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cache as cache_lib
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import attention as attn_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import layernorm, resolve_device, rmsnorm, rope_tables
from repro_torch.models.mlp import mlp_apply

__all__ = ["COMPUTE_DTYPE", "Block", "RWKVBlock", "Transformer", "check_supported",
           "check_serving", "is_hybrid", "cache_cfg_for", "init_caches", "embed_tokens",
           "logits_from_hidden", "forward_prefill", "decode_tokens"]

COMPUTE_DTYPE = torch.bfloat16


def is_hybrid(cfg: ModelConfig) -> bool:
    """Blocks run SSM heads in parallel with attention (hymba)."""
    return cfg.ssm and cfg.hybrid_parallel


def check_serving(cfg: ModelConfig, layout: str = "dense",
                  prefill_mode: str = "monolithic") -> None:
    """Raise for a cache layout or prefill mode this model cannot take: a
    hybrid serves dense and monolithic only, an RWKV6 model dense only (the
    paged reasons are the reference's own; an RWKV6 model's streaming
    prefill is its monolithic one, unbucketed, as in the reference)."""
    if cfg.rwkv and layout == "paged":
        raise ValueError("paged layout: no GEAR-compressible attention layer in "
                         f"pattern {cfg.layer_pattern!r}")
    if not is_hybrid(cfg):
        return
    if layout == "paged":
        raise NotImplementedError("hybrid SSM recurrent state is not chunk-decomposable; "
                                  "serve it with layout='dense'")
    if prefill_mode == "streaming":
        raise NotImplementedError("streaming prefill of a hybrid SSM model is not ported yet "
                                  "(ROADMAP queue item 10: hybrid streaming prefill)")


def check_supported(cfg: ModelConfig) -> None:
    """The port serves text decoders with global RMSNorm/SwiGLU attention
    blocks, dense (llama2) or hybrid with parallel SSM heads (hymba), and
    attention-free RWKV6 stacks; other families raise."""
    attn_ok = (((cfg.family == "dense" and not cfg.ssm)
                or (cfg.family == "hybrid" and is_hybrid(cfg)))
               and not cfg.rwkv and cfg.layer_pattern == ("global",)
               and cfg.mlp_kind == "swiglu" and not cfg.qk_norm)
    rwkv_ok = cfg.family == "ssm" and cfg.rwkv and cfg.mlp_kind == "rwkv_cm"
    if (not (attn_ok or rwkv_ok) or cfg.moe or cfg.modality != "text"
            or cfg.norm != "rmsnorm"):
        raise NotImplementedError(
            f"{cfg.name}: only dense or hybrid (parallel SSM) global-attention RMSNorm/SwiGLU "
            "text decoders and RWKV6 are ported (other families: ROADMAP queue item 10)")


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class Block(nn.Module):
    """One decoder layer's weights (``[d_in, d_out]`` matrices, as the reference)."""

    def __init__(self, cfg: ModelConfig, device, dtype=COMPUTE_DTYPE):
        super().__init__()
        d, qd, kvd, ff = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.d_ff

        def mat(*shape):
            return _param(torch.zeros(shape, dtype=dtype, device=device))

        self.ln1 = _param(torch.zeros(d, dtype=torch.float32, device=device))
        self.ln2 = _param(torch.zeros(d, dtype=torch.float32, device=device))
        self.wq, self.wk, self.wv, self.wo = mat(d, qd), mat(d, kvd), mat(d, kvd), mat(qd, d)
        self.w_gate, self.w_up, self.w_down = mat(d, ff), mat(d, ff), mat(ff, d)
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
        self.embed = _param(torch.zeros(v, d, dtype=dtype, device=device))
        self.lm_head = (None if cfg.tie_embeddings
                        else _param(torch.zeros(d, v, dtype=dtype, device=device)))
        self.final_norm = _param(torch.zeros(d, dtype=torch.float32, device=device))
        block = RWKVBlock if cfg.rwkv else Block
        self.blocks = nn.ModuleList(block(cfg, device, dtype) for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @classmethod
    def random(cls, cfg: ModelConfig, seed: int = 0, device=None) -> "Transformer":
        """Random weights from a seeded ``torch.Generator`` on the target
        device: normal draws scaled by ``fan_in ** -0.5`` as the reference's
        init (untruncated; ``fan_in`` is the input dim, the LoRA rank 32 for
        RWKV6's ``mix_lora_b [5, 32, d]``); norm scales zero, i.e. unit gain.
        Everything else keeps the reference's constants, set by the modules:
        the SSM's per-head vectors (``a_log`` 0, ``dt_bias`` -1, ``d_skip``
        1), RWKV6's mixes (0.5), ``w0`` (-2), ``u`` (0) and its norms' scale
        1 and bias 0."""
        model = cls(cfg, device)
        gen = torch.Generator(device=model.device).manual_seed(seed)
        fixed = {f"{prefix}.{name}" for prefix, mod in model.named_modules()
                 for name in getattr(mod, "FIXED", ())}
        with torch.no_grad():
            for name, p in model.named_parameters():
                if p.dim() >= 2 and name not in fixed:
                    fan_in = p.shape[1] if name == "embed" else p.shape[-2 if p.dim() == 3 else 0]
                    p.normal_(0.0, fan_in ** -0.5, generator=gen)
        return model


def cache_cfg_for(cfg: ModelConfig, policy: CompressionPolicy, batch: int,
                  capacity: int) -> cache_lib.CacheConfig:
    return cache_lib.CacheConfig(batch=batch, kv_heads=cfg.num_kv_heads,
                                 head_dim=cfg.head_dim, capacity=capacity, policy=policy)


def init_caches(cfg: ModelConfig, policy: CompressionPolicy, batch: int, capacity: int,
                device, dtype=torch.bfloat16, layout: str = "dense", pool_pages: int = 0) -> list:
    """One empty layer cache per layer: a dense
    :class:`~repro_torch.core.cache.GEARLayerCache`, or for ``layout="paged"``
    a :class:`~repro_torch.core.cache.PagedGEARLayerCache` whose pool holds
    ``pool_pages`` pages (page 0 reserved).  Every layer's pool is addressed
    by one engine-owned block table.  A hybrid layer's cache is the pair
    (GEAR cache, zero :class:`~repro_torch.models.ssm.SSMState`); hybrids
    are dense-only.  An RWKV6 layer's is a zero
    :class:`~repro_torch.models.rwkv.RWKVState` whatever the policy (it
    touches no RWKV layer); RWKV6 is dense-only too."""
    if layout not in ("dense", "paged"):
        raise ValueError(f"layout must be dense/paged, got {layout!r}")
    if cfg.rwkv:
        check_serving(cfg, layout=layout)
        return [rwkv_lib.init_rwkv_state(cfg, batch, dtype, device)
                for _ in range(cfg.num_layers)]
    if policy.is_fp16:
        raise NotImplementedError("fp16 caches are not ported yet (ROADMAP queue item 10)")
    check_serving(cfg, layout=layout)
    ccfg = cache_cfg_for(cfg, policy, batch, capacity)
    if layout == "paged":
        return [cache_lib.init_paged_layer_cache(ccfg, pool_pages, dtype, device)
                for _ in range(cfg.num_layers)]
    if is_hybrid(cfg):
        return [(cache_lib.init_layer_cache(ccfg, dtype, device),
                 ssm_lib.init_ssm_state(cfg, batch, dtype, device))
                for _ in range(cfg.num_layers)]
    return [cache_lib.init_layer_cache(ccfg, dtype, device) for _ in range(cfg.num_layers)]


def embed_tokens(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    return model.embed[tokens.to(torch.int64)].to(COMPUTE_DTYPE)


def logits_from_hidden(model: Transformer, h: torch.Tensor) -> torch.Tensor:
    if model.lm_head is None:
        return h @ model.embed.to(h.dtype).T
    return h @ model.lm_head


def forward_prefill(model: Transformer, tokens: torch.Tensor, policy: CompressionPolicy,
                    capacity: int, prefill_mode: str = "monolithic", padded_tail: bool = False,
                    true_len: int | None = None):
    """Prefill of ``tokens`` [B, S].  Returns (logits [B, 1, V] of the last
    real position, one filled layer cache per layer).

    ``prefill_mode="monolithic"``: full-sequence attention, then one batched
    compression event per layer.  ``"streaming"``: each layer compresses its
    closed chunks first and attends the history in compressed form (a layer
    that cannot stream falls back to monolithic); both build the same
    caches.  ``padded_tail`` / ``true_len`` (streaming only) are the
    length-bucketing hooks: ``tokens`` is right-padded to a chunk multiple,
    the padded block stays out of compression, lengths and the returned
    logits come from position ``true_len - 1``.  An RWKV6 model runs its
    blocks over the whole prompt in either mode (no compression, no
    bucketing: a padded tail would enter its recurrent state)."""
    if prefill_mode not in ("monolithic", "streaming"):
        raise ValueError(f"prefill_mode must be monolithic/streaming, got {prefill_mode!r}")
    if padded_tail and prefill_mode != "streaming":
        raise ValueError("padded_tail requires prefill_mode='streaming'")
    cfg = model.cfg
    check_serving(cfg, prefill_mode=prefill_mode)
    x = embed_tokens(model, tokens)
    if cfg.rwkv:
        if padded_tail:
            raise ValueError("suffix/bucketed prefill cannot resume an RWKV state")
        caches = []
        for blk in model.blocks:
            h, (shift_tm, wkv) = rwkv_lib.time_mix_apply(cfg, blk, blk.ln1(x))
            x = x + h
            h, shift_cm = rwkv_lib.channel_mix_apply(cfg, blk, blk.ln2(x))
            x = x + h
            caches.append(rwkv_lib.RWKVState(shift_tm=shift_tm.to(torch.bfloat16),
                                             shift_cm=shift_cm.to(torch.bfloat16), wkv=wkv))
        return logits_from_hidden(model, rmsnorm(x, model.final_norm)[:, -1:, :]), caches
    hybrid = is_hybrid(cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    ccfg = cache_cfg_for(cfg, policy, B, capacity)
    stream = prefill_mode == "streaming" and attn_lib.streaming_prefill_supported(cfg, ccfg)
    if padded_tail and not stream:
        raise ValueError("bucketed prefill needs every layer to support streaming")
    caches = []
    for blk in model.blocks:
        xin = rmsnorm(x, blk.ln1)
        if stream:
            h, cache = attn_lib.attention_prefill_streaming(
                cfg, blk, xin, rope, ccfg, padded_tail=padded_tail, true_len=true_len)
        else:
            h, (k, v) = attn_lib.attention_prefill(cfg, blk, xin, rope)
            cache = cache_lib.prefill_layer_cache(
                ccfg, cache_lib.init_layer_cache(ccfg, torch.bfloat16, x.device), k, v)
        if hybrid:
            h2, ssm_state = ssm_lib.ssm_apply(cfg, blk, xin)
            h = (h + h2) * 0.5
            cache = (cache, ssm_state)
        x = x + h
        x = x + mlp_apply(blk, rmsnorm(x, blk.ln2))
        caches.append(cache)
    x = rmsnorm(x, model.final_norm)
    last = S if true_len is None else int(true_len)
    return logits_from_hidden(model, x[:, last - 1:last, :]), caches


def decode_tokens(model: Transformer, tokens: torch.Tensor, caches: list, pos,
                  policy: CompressionPolicy, capacity: int, lengths=None,
                  block_tables: cache_lib.BlockTables | None = None) -> torch.Tensor:
    """One decode step.  tokens [B, 1]; ``pos`` [B] per-slot absolute
    positions; ``lengths`` the host copy of the caches' per-slot lengths
    (read from the first layer cache, one device sync per step, when not
    given); ``block_tables`` addresses every layer's pool for paged caches.
    Updates ``caches`` in place; returns logits [B, 1, V].  An RWKV6 model
    reads neither ``pos`` nor lengths: each layer advances its
    :class:`~repro_torch.models.rwkv.RWKVState` by one token."""
    cfg = model.cfg
    x = embed_tokens(model, tokens)
    if cfg.rwkv:
        for blk, st in zip(model.blocks, caches):
            h, new = rwkv_lib.time_mix_decode(cfg, blk, blk.ln1(x), st)
            x = x + h
            h, new = rwkv_lib.channel_mix_decode(cfg, blk, blk.ln2(x), new)
            x = x + h
            for name, t in new.tensors().items():
                getattr(st, name).copy_(t)
        return logits_from_hidden(model, rmsnorm(x, model.final_norm))
    B = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.int32, device=x.device).reshape(-1).expand(B)
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)      # [B, 1, Dh/2]
    hybrid = is_hybrid(cfg)
    if lengths is None:
        lengths = (caches[0][0] if hybrid else caches[0]).length.cpu().numpy()
    lengths = np.asarray(lengths)
    ccfg = cache_cfg_for(cfg, policy, B, capacity)
    for blk, cache in zip(model.blocks, caches):
        gear, st = cache if hybrid else (cache, None)
        xin = rmsnorm(x, blk.ln1)
        h = attn_lib.attention_decode(cfg, blk, xin, rope, gear, ccfg, lengths, block_tables)
        if hybrid:
            h2, new = ssm_lib.ssm_decode(cfg, blk, xin, st)
            st.conv.copy_(new.conv)
            st.state.copy_(new.state)
            h = (h + h2) * 0.5
        x = x + h
        x = x + mlp_apply(blk, rmsnorm(x, blk.ln2))
    x = rmsnorm(x, model.final_norm)
    return logits_from_hidden(model, x)
