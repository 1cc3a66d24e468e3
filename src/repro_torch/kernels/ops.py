"""Attention entry points over the kernels (port of ``repro.kernels.ops``).

``gear_attend`` is decode attention over a GEAR layer cache: the compressed
region goes through ``gear_decode`` (the CUDA kernel for CUDA tensors, its
plain version for CPU tensors), and the FP16 streaming buffer is merged
with one softmax rescale.  ``flash_attention`` is full-sequence causal
attention through ``flash_prefill``.
"""

from __future__ import annotations

import torch

from repro_torch.core.cache import CacheConfig, GEARLayerCache
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.gear_decode import gear_decode

__all__ = ["fused_supported", "gear_attend", "flash_attention"]

# -1e30, never -inf: the merge relies on exp(-1e30 - m) == 0 without NaN.
NEG_INF = -1e30


def fused_supported(cfg: CacheConfig) -> bool:
    """True when this layer cache has the ``gear_decode`` layout: a GEAR
    cache with per-channel K stats at chunk granularity (both recommended
    policies, gear_kcvt4 and gear_kivi2, qualify)."""
    if cfg.kind != "gear" or cfg.policy.is_fp16:
        return False
    scheme, group = cfg.k_scheme()
    return scheme == "per_channel" and (cfg.chunk if group is None else group) == cfg.chunk


def _flat(x, bh):
    return None if x is None else x.reshape((bh,) + tuple(x.shape[2:]))


def _gear_operands(cfg: CacheConfig, cache: GEARLayerCache, BH: int):
    """Flatten a layer cache into the [BH]-leading operands of ``gear_decode``."""
    pol = cfg.policy
    lr = dict(k_a=_flat(cache.k_a, BH), k_b=_flat(cache.k_b, BH),
              v_a=_flat(cache.v_a, BH), v_b=_flat(cache.v_b, BH)) if pol.use_lowrank else {}
    sp = dict(k_sp_val=_flat(cache.k_sp_val, BH), k_sp_idx=_flat(cache.k_sp_idx, BH),
              v_sp_val=_flat(cache.v_sp_val, BH),
              v_sp_idx=_flat(cache.v_sp_idx, BH)) if pol.use_sparse else {}
    arrays = (_flat(cache.k_packed, BH), _flat(cache.k_scale, BH), _flat(cache.k_zero, BH),
              _flat(cache.v_packed, BH), _flat(cache.v_scale, BH), _flat(cache.v_zero, BH))
    return arrays, lr, sp


def _merge_buffer(cfg: CacheConfig, cache: GEARLayerCache, qf, acc, m, l, n_buf, scale):
    """Merge the FP16 streaming-buffer region into a history (acc, m, l)
    triple and normalize.  qf [BH, G, Dh] f32; returns [BH, G, Dh] f32."""
    BH = qf.shape[0]
    nb = cfg.chunk
    s_buf = torch.einsum("xgd,xnd->xgn", qf, _flat(cache.buf_k, BH).to(torch.float32)) * scale
    buf_valid = torch.arange(nb, device=qf.device)[None, None, :] < n_buf[:, None, None]
    s_buf = torch.where(buf_valid, s_buf, torch.full_like(s_buf, NEG_INF))
    m_tot = torch.maximum(m, s_buf.amax(dim=-1))
    p_buf = torch.exp(s_buf - m_tot[..., None])
    acc_buf = torch.einsum("xgn,xnd->xgd", p_buf, _flat(cache.buf_v, BH).to(torch.float32))
    corr = torch.exp(m - m_tot)
    l_tot = l * corr + p_buf.sum(dim=-1)
    return (acc * corr[..., None] + acc_buf) / torch.clamp_min(l_tot[..., None], 1e-30)


def gear_attend(cfg: CacheConfig, cache: GEARLayerCache, q: torch.Tensor,
                scale: float) -> torch.Tensor:
    """Decode attention over a GEAR layer cache.  q [B, Hq, Dh] -> [B, Hq, Dh].

    Ragged-aware: every slot attends over exactly its own compressed extent
    and buffer fill, read from the device-side ``cache.length`` (no sync).
    """
    if not fused_supported(cfg):
        raise NotImplementedError(
            "this cache layout needs the portable attend path (fused='off'), "
            "not ported yet (ROADMAP queue item 3)")
    pol = cfg.policy
    B, Hq, Dh = q.shape
    H = cfg.kv_heads
    G = Hq // H
    BH = B * H
    qf = q.to(torch.float32).reshape(BH, G, Dh)
    nb = cfg.chunk
    len_bh = cache.length.repeat_interleave(H)          # [BH]
    n_comp = torch.div(len_bh, nb, rounding_mode="floor") * nb
    n_buf = len_bh - n_comp
    arrays, lr, sp = _gear_operands(cfg, cache, BH)
    acc, m, l = gear_decode(qf, *arrays, n_comp.to(torch.int32), bits=pol.bits, chunk=nb,
                            scale_factor=scale, **lr, **sp)
    out = _merge_buffer(cfg, cache, qf, acc, m, l, n_buf, scale)
    return out.reshape(B, Hq, Dh).to(q.dtype)


def flash_attention(q, k, v, *, window: int = 0, prefix_len: int = 0,
                    softcap: float = 0.0, kv_repeat: int = 1):
    """q [BHq, S, Dh], k/v [BHq / kv_repeat, S, Dh] causal attention."""
    return flash_prefill(q, k, v, window=window, prefix_len=prefix_len,
                         softcap=softcap, kv_repeat=kv_repeat)
