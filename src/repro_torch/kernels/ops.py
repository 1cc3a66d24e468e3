"""Attention and compression entry points over the kernels (port of
``repro.kernels.ops``).

``gear_attend`` / ``gear_attend_paged`` are decode attention over a dense /
paged GEAR layer cache: the compressed region goes through ``gear_decode``
/ ``gear_decode_paged`` (the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors), and the FP16 streaming buffer is merged with one
softmax rescale.  ``gear_attend_block`` is the streaming prefill's attention
of in-flight blocks (compressed history + the block itself).
``flash_attention`` is full-sequence causal attention through
``flash_prefill``.  ``quantize_chunk`` is the fused per-column quantize +
pack of a chunk batch through ``quant_pack``.
"""

from __future__ import annotations

import torch

from repro_torch.core.cache import (CacheConfig, GEARLayerCache, PagedGEARLayerCache,
                                    chunk_prefix_view, streaming_supported)
from repro_torch.kernels import ref
from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_block
from repro_torch.kernels.gear_decode import (device_extents, gear_decode, gear_decode_history,
                                              gear_decode_paged)
from repro_torch.kernels.quant_pack import quant_pack

__all__ = ["gear_attend", "gear_attend_paged", "gear_attend_block",
           "flash_attention", "quantize_chunk"]

# -1e30, never -inf: the merge relies on exp(-1e30 - m) == 0 without NaN.
NEG_INF = -1e30


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


def _pool_flat(x):
    """Pool leaf [P, H, ...] -> kernel row layout [P*H, ...] (page p, head h
    at row p*H + h)."""
    return None if x is None else x.reshape((-1,) + tuple(x.shape[2:]))


def _paged_operands(cfg: CacheConfig, pcache: PagedGEARLayerCache):
    """Paged twin of :func:`_gear_operands`: head-flattened pool pages in the
    ``gear_decode_paged`` operand order."""
    pol = cfg.policy
    lr = dict(k_a=_pool_flat(pcache.k_a), k_b=_pool_flat(pcache.k_b),
              v_a=_pool_flat(pcache.v_a), v_b=_pool_flat(pcache.v_b)) if pol.use_lowrank else {}
    sp = dict(k_sp_val=_pool_flat(pcache.k_sp_val), k_sp_idx=_pool_flat(pcache.k_sp_idx),
              v_sp_val=_pool_flat(pcache.v_sp_val),
              v_sp_idx=_pool_flat(pcache.v_sp_idx)) if pol.use_sparse else {}
    arrays = (_pool_flat(pcache.k_packed), _pool_flat(pcache.k_scale),
              _pool_flat(pcache.k_zero), _pool_flat(pcache.v_packed),
              _pool_flat(pcache.v_scale), _pool_flat(pcache.v_zero))
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
    return _attend_decode(cfg, cache, q, scale, None)


def gear_attend_paged(cfg: CacheConfig, pcache: PagedGEARLayerCache,
                      block_tables: torch.Tensor, q: torch.Tensor, scale: float) -> torch.Tensor:
    """Paged twin of :func:`gear_attend`: the compressed history lives in
    pool pages named by ``block_tables [B, C]`` (int32, on q's device) and
    goes through ``gear_decode_paged``; the per-slot FP16 buffer merges
    through the same tail, so a paged slot's output equals the dense
    slot's for the same history."""
    return _attend_decode(cfg, pcache, q, scale, block_tables)


def _attend_decode(cfg: CacheConfig, cache, q: torch.Tensor, scale: float, block_tables):
    if not streaming_supported(cfg):       # the gear_decode layout
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
    n_comp = (torch.div(len_bh, nb, rounding_mode="floor") * nb).to(torch.int32)
    n_buf = len_bh - n_comp
    kw = dict(bits=pol.bits, chunk=nb, scale_factor=scale)
    if block_tables is None:
        arrays, lr, sp = _gear_operands(cfg, cache, BH)
        acc, m, l = gear_decode(qf, *arrays, n_comp, **kw, **lr, **sp)
    else:
        arrays, lr, sp = _paged_operands(cfg, cache)
        acc, m, l = gear_decode_paged(qf, *arrays, n_comp, block_tables, **kw, **lr, **sp)
    out = _merge_buffer(cfg, cache, qf, acc, m, l, n_buf, scale)
    return out.reshape(B, Hq, Dh).to(q.dtype)


def gear_attend_block(cfg: CacheConfig, cache: GEARLayerCache, q: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor, n_comp: list, blk_len,
                      scale: float) -> torch.Tensor:
    """Streaming-prefill attention of a stack of in-flight blocks: each
    block's queries attend the compressed history before it plus the block
    itself (causal), merged with a two-piece online softmax.

    q [B, H, NB, G, T, Dh] f32 (query head h * G + g); k, v [B, H, NB, T, Dh]
    f32 (the blocks' uncompressed K/V); ``n_comp[i]`` is block i's
    compressed extent (tokens in chunks closed before it) and ``blk_len``
    the valid tokens of every block (an int), or of each block (a sequence
    of NB ints).  On the card the history of every block is one
    ``gear_decode_history`` launch (the ``gear_decode`` kernel's tensor-core
    regime, G*T query rows per (batch, kv-head) row and block); the blocks
    themselves are one ``flash_prefill_block`` launch over rows (b, h,
    block, g), which read K/V row (b, h, block) through ``kv_repeat``.  CPU
    tensors take the plain versions, the history through
    ``gear_hist_block_ref`` (the reference's CPU history scorer) per block
    over the chunk prefix its extent covers.  Returns [B, H, NB, G, T, Dh]
    f32.
    """
    pol = cfg.policy
    B, H, NB, G, T, Dh = q.shape
    BH = B * H
    nb = cfg.chunk
    kw = dict(bits=pol.bits, chunk=nb, scale_factor=scale)

    # --- compressed history: one unnormalized (acc, m, l) per block --------
    if q.device.type == "cpu":
        hist = []
        for i in range(NB):
            view = chunk_prefix_view(cfg, cache, max(-(-n_comp[i] // nb), 1))
            v_arrays, v_lr, v_sp = _gear_operands(cfg, view, BH)
            hist.append(ref.gear_hist_block_ref(q[:, :, i].reshape(BH, G * T, Dh), *v_arrays,
                                                n_comp[i], **kw, **v_lr, **v_sp))
        acc_h, m_h, l_h = (torch.stack([h[j] for h in hist], dim=1) for j in range(3))
    else:
        arrays, lr, sp = _gear_operands(cfg, cache, BH)
        acc_h, m_h, l_h = gear_decode_history(q.reshape(BH, NB, G * T, Dh).contiguous(),
                                              *arrays, n_comp, **kw, **lr, **sp)
    acc_h = acc_h.reshape(B, H, NB, G, T, Dh)
    m_h = m_h.reshape(B, H, NB, G, T)
    l_h = l_h.reshape(B, H, NB, G, T)

    # --- in-flight blocks, causal -------------------------------------------
    q_blk = q.reshape(BH * NB * G, T, Dh).contiguous()
    k_blk = k.reshape(BH * NB, T, Dh).contiguous()
    v_blk = v.reshape(BH * NB, T, Dh).contiguous()
    if isinstance(blk_len, int):
        kv_len = torch.full((BH * NB * G,), blk_len, dtype=torch.int32, device=q.device)
    else:
        lens = (torch.tensor(blk_len, dtype=torch.int32) if q.device.type == "cpu"
                else device_extents(tuple(int(n) for n in blk_len), q.device))
        kv_len = lens.view(1, NB, 1).expand(BH, NB, G).reshape(-1)
    acc_b, m_b, l_b = flash_prefill_block(q_blk, k_blk, v_blk, kv_len, scale=scale,
                                          kv_repeat=G)
    acc_b = acc_b.reshape(B, H, NB, G, T, Dh)
    m_b = m_b.reshape(B, H, NB, G, T)
    l_b = l_b.reshape(B, H, NB, G, T)

    # --- two-piece merge + normalize ----------------------------------------
    m_tot = torch.maximum(m_h, m_b)
    c_h = torch.exp(m_h - m_tot)
    c_b = torch.exp(m_b - m_tot)
    l_tot = l_h * c_h + l_b * c_b
    return (acc_h * c_h[..., None] + acc_b * c_b[..., None]) / torch.clamp_min(
        l_tot[..., None], 1e-30)


def flash_attention(q, k, v, *, window: int = 0, prefix_len: int = 0,
                    softcap: float = 0.0, kv_repeat: int = 1):
    """q [BHq, S, Dh], k/v [BHq / kv_repeat, S, Dh] causal attention."""
    return flash_prefill(q, k, v, window=window, prefix_len=prefix_len,
                         softcap=softcap, kv_repeat=kv_repeat)


def quantize_chunk(x: torch.Tensor, bits: int):
    """Fused per-column quantize + pack of a chunk batch x [N, n, d] (f32 or
    bf16): (packed [N, n, d * bits / 32] int32, scale [N, d], zero [N, d])."""
    return quant_pack(x, bits)
