"""Plain PyTorch versions of the ported kernels (same contracts, no tiling).

Port of the matching oracles in ``repro.kernels.ref``.  CPU tensors take
these in place of the CUDA kernels; ``chip_smoke.py`` holds each kernel
against them on the card.  Never on the main path when a card is present.
"""

from __future__ import annotations

import torch

from repro_torch.core import packing

__all__ = ["gear_decode_ref", "flash_prefill_ref"]

NEG_INF = -1e30


def _dequant(packed, scale_full, zero_full, bits, d):
    codes = packing.unpack(packed, bits, d).to(torch.float32)
    return codes * scale_full + zero_full


def gear_decode_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp, *,
                    bits: int, chunk: int, scale_factor: float,
                    k_a=None, k_b=None, v_a=None, v_b=None,
                    k_sp_val=None, k_sp_idx=None, v_sp_val=None, v_sp_idx=None):
    """Unnormalized online-softmax decode attention over a GEAR cache.

    q [BH, G, Dh]; k_packed/v_packed [BH, S, L] int32; k_scale/k_zero
    [BH, C, Dh]; v_scale/v_zero [BH, S, Gv]; k_a/v_a [BH, S, r]; k_b/v_b
    [BH, C, Dh, r]; k_sp_* [BH, C, Dh, Ks] (token index); v_sp_*
    [BH, S, Kv] (channel index); n_comp [BH] int32 (or a scalar).

    Scores past each row's ``n_comp`` are masked to -1e30 (not -inf), so a
    row with ``n_comp = 0`` gets a uniform softmax over its rows, exactly as
    the reference.  An outlier index that occurs twice adds its value twice,
    as the reference's one-hot sum does.  Returns (acc [BH, G, Dh] f32,
    m [BH, G], l [BH, G]).
    """
    BH, S, _ = k_packed.shape
    Dh = k_scale.shape[-1]
    C = S // chunk
    f32 = torch.float32
    dev = q.device

    sc = k_scale.to(f32).repeat_interleave(chunk, dim=1)
    zr = k_zero.to(f32).repeat_interleave(chunk, dim=1)
    k_hat = _dequant(k_packed, sc, zr, bits, Dh)                          # [BH, S, Dh]
    if k_sp_val is not None:
        oh = (k_sp_idx.unsqueeze(-1) == torch.arange(chunk, device=dev)).to(f32)
        k_hat = k_hat + torch.einsum("xcdk,xcdkn->xcnd", k_sp_val.to(f32), oh).reshape(BH, S, Dh)
    qf = q.to(f32)
    s = torch.einsum("xgd,xsd->xgs", qf, k_hat)
    if k_a is not None:
        qb = torch.einsum("xgd,xcdr->xgcr", qf, k_b.to(f32))
        a_c = k_a.to(f32).reshape(BH, C, chunk, -1)
        s = s + torch.einsum("xgcr,xcnr->xgcn", qb, a_c).reshape(BH, -1, S)
    s = s * scale_factor
    n_comp = torch.as_tensor(n_comp, dtype=torch.int32, device=dev).expand(BH)
    valid = torch.arange(S, device=dev)[None, :] < n_comp[:, None]
    s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))

    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)

    gv = v_scale.shape[-1]
    vsc = v_scale.to(f32).repeat_interleave(Dh // gv, dim=-1)
    vzr = v_zero.to(f32).repeat_interleave(Dh // gv, dim=-1)
    v_hat = _dequant(v_packed, vsc, vzr, bits, Dh)
    if v_sp_val is not None:
        oh = (v_sp_idx.unsqueeze(-1) == torch.arange(Dh, device=dev)).to(f32)
        v_hat = v_hat + torch.einsum("xsk,xskd->xsd", v_sp_val.to(f32), oh)
    acc = torch.einsum("xgs,xsd->xgd", p, v_hat)
    if v_a is not None:
        pa = torch.einsum("xgcn,xcnr->xgcr", p.reshape(BH, -1, C, chunk),
                          v_a.to(f32).reshape(BH, C, chunk, -1))
        acc = acc + torch.einsum("xgcr,xcdr->xgd", pa, v_b.to(f32))
    return acc, m, l


def flash_prefill_ref(q, k, v, *, window: int = 0, prefix_len: int = 0,
                      softcap: float = 0.0, kv_repeat: int = 1):
    """Causal attention.  q [BHq, S, Dh]; k, v [BHq / kv_repeat, S, Dh] ->
    normalized [BHq, S, Dh] in q's dtype, computed in f32.

    Query row ``x`` reads K/V row ``x // kv_repeat`` (GQA, rows laid out
    (B, Hkv, G)).  Mask family as the reference: causal, optional sliding
    ``window``, bidirectional ``prefix_len`` block, tanh ``softcap`` applied
    to the scaled scores.
    """
    f32 = torch.float32
    S, Dh = q.shape[1], q.shape[2]
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=0)
        v = v.repeat_interleave(kv_repeat, dim=0)
    s = torch.einsum("xqd,xkd->xqk", q.to(f32), k.to(f32)) * Dh**-0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    qp, kp = pos[:, None], pos[None, :]
    ok = qp >= kp
    if window:
        ok = ok & (qp - kp < window)
    if prefix_len:
        ok = ok | ((qp < prefix_len) & (kp < prefix_len))
    s = torch.where(ok[None], s, torch.full_like(s, NEG_INF))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("xqk,xkd->xqd", w, v.to(f32)).to(q.dtype)
