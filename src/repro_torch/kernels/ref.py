"""Plain PyTorch versions of the ported kernels (same contracts, no tiling).

Port of the matching oracles in ``repro.kernels.ref``.  CPU tensors take
these in place of the CUDA kernels; ``chip_smoke.py`` holds each kernel
against them on the card.  Never on the main path when a card is present.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import outlier as ol
from repro_torch.core import packing
from repro_torch.core import quant as q_lib

__all__ = ["gear_decode_ref", "gear_decode_paged_ref", "gather_paged_operands",
           "gear_decode_history_ref", "gear_hist_block_ref", "flash_prefill_ref", "flash_block_ref",
           "gear_compress_ref", "linear_scan_ref", "quant_pack_ref"]

NEG_INF = -1e30


def _dequant(packed, scale_full, zero_full, bits, d):
    codes = packing.unpack(packed, bits, d).to(torch.float32)
    return codes * scale_full + zero_full


def quant_pack_ref(x, bits: int):
    """Per-column asymmetric quantize + pack of x [N, n, d] (f32 or bf16),
    each column's group the tile's n rows: (packed int32 [N, n, d*bits/32],
    scale [N, d] f32, zero [N, d] f32).  This is the cache's own quantizer
    (:func:`repro_torch.core.quant.quantize`, ``per_channel``, f32 stats):
    the scale multiplies by ``f32(1 / (2**bits - 1))`` as the reference's
    jitted programs and its Pallas kernel do, so it equals them bit for bit
    (the eager ``repro.kernels.ref.quant_pack_ref`` divides instead; ROADMAP
    §3)."""
    qt = q_lib.quantize(x, bits, "per_channel")
    return qt.packed, qt.scale[:, 0], qt.zero[:, 0]


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


def gather_paged_operands(block_tables, BH: int, pools: dict) -> dict:
    """Gather head-flattened pool operands ``[P*H, pg0, ...]`` back to the
    dense ``[BH, C*pg0, ...]`` row layout through ``block_tables [B, C]``:
    page ``bt[b, c]``, head ``h`` is pool row ``bt[b, c]*H + h``.  None
    leaves pass through."""
    bt = block_tables.to(torch.int64)
    B, C = bt.shape
    H = BH // B
    rows = (bt[:, None, :] * H + torch.arange(H, device=bt.device)[None, :, None]).reshape(BH, C)

    def gather(pool):
        if pool is None:
            return None
        g = pool[rows]                                   # [BH, C, pg0, ...]
        return g.reshape((BH, C * g.shape[2]) + tuple(g.shape[3:]))

    return {name: gather(pool) for name, pool in pools.items()}


def gear_decode_paged_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp,
                          block_tables, *, bits: int, chunk: int, scale_factor: float,
                          k_a=None, k_b=None, v_a=None, v_b=None,
                          k_sp_val=None, k_sp_idx=None, v_sp_val=None, v_sp_idx=None):
    """:func:`gear_decode_ref` over head-flattened pool pages ``[P*H, ...]``
    addressed through ``block_tables [B, C]``: gathers the dense operands
    (exact under the pool's zero-page invariant) and defers to it."""
    g = gather_paged_operands(
        block_tables, q.shape[0],
        dict(k_packed=k_packed, k_scale=k_scale, k_zero=k_zero, v_packed=v_packed,
             v_scale=v_scale, v_zero=v_zero, k_a=k_a, k_b=k_b, v_a=v_a, v_b=v_b,
             k_sp_val=k_sp_val, k_sp_idx=k_sp_idx, v_sp_val=v_sp_val, v_sp_idx=v_sp_idx))
    arrays = [g.pop(n) for n in ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale",
                                 "v_zero")]
    return gear_decode_ref(q, *arrays, n_comp, bits=bits, chunk=chunk,
                           scale_factor=scale_factor, **g)


def gear_decode_history_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, extents,
                            *, bits: int, chunk: int, scale_factor: float, **factors):
    """Plain version of ``gear_decode_history``: :func:`gear_decode_ref` of
    each in-flight block in turn.  q [BH, NB, R, Dh]; ``extents[i]`` block
    ``i``'s compressed extent.  Returns (acc [BH, NB, R, Dh], m [BH, NB, R],
    l [BH, NB, R])."""
    outs = [gear_decode_ref(q[:, i], k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, e,
                            bits=bits, chunk=chunk, scale_factor=scale_factor, **factors)
            for i, e in enumerate(extents)]
    return tuple(torch.stack([o[j] for o in outs], dim=1) for j in range(3))


def gear_hist_block_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp, *,
                        bits: int, chunk: int, scale_factor: float,
                        k_a=None, k_b=None, v_a=None, v_b=None,
                        k_sp_val=None, k_sp_idx=None, v_sp_val=None, v_sp_idx=None):
    """Block-query twin of :func:`gear_decode_ref` (the streaming prefill's
    history scorer on CPU tensors): the same contract and f32 math, with the
    low-rank term densified as ``A·Bᵀ`` per chunk and the outliers densified
    by a select chain in slot order (set semantics: an index stored twice
    counts once, where ``gear_decode`` adds it twice).  Returns (acc
    [BH, G, Dh], m [BH, G], l [BH, G])."""
    BH, S, _ = k_packed.shape
    Dh = k_scale.shape[-1]
    C = S // chunk
    f32 = torch.float32
    dev = q.device
    qf = q.to(f32)

    sc = k_scale.to(f32).repeat_interleave(chunk, dim=1)
    zr = k_zero.to(f32).repeat_interleave(chunk, dim=1)
    k_hat = _dequant(k_packed, sc, zr, bits, Dh)                          # [BH, S, Dh]
    if k_a is not None:
        a_c = k_a.to(f32).reshape(BH, C, chunk, -1)
        k_hat = k_hat + torch.einsum("xcnr,xcdr->xcnd", a_c, k_b.to(f32)).reshape(BH, S, Dh)
    if k_sp_val is not None:
        iota_n = torch.arange(chunk, device=dev)[None, None, None, :]
        sp = torch.zeros((BH, C, Dh, chunk), dtype=f32, device=dev)
        for j in range(k_sp_val.shape[-1]):
            sp = torch.where(iota_n == k_sp_idx[..., j:j + 1], k_sp_val[..., j:j + 1].to(f32), sp)
        k_hat = k_hat + sp.transpose(2, 3).reshape(BH, S, Dh)
    s = torch.einsum("xgd,xsd->xgs", qf, k_hat) * scale_factor
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
    if v_a is not None:
        a_c = v_a.to(f32).reshape(BH, C, chunk, -1)
        v_hat = v_hat + torch.einsum("xcnr,xcdr->xcnd", a_c, v_b.to(f32)).reshape(BH, S, Dh)
    if v_sp_val is not None:
        iota_d = torch.arange(Dh, device=dev)[None, None, :]
        sp_v = torch.zeros((BH, S, Dh), dtype=f32, device=dev)
        for j in range(v_sp_val.shape[-1]):
            sp_v = torch.where(iota_d == v_sp_idx[..., j:j + 1], v_sp_val[..., j:j + 1].to(f32),
                               sp_v)
        v_hat = v_hat + sp_v
    acc = torch.einsum("xgs,xsd->xgd", p, v_hat)
    return acc, m, l


def flash_block_ref(q, k, v, kv_len, *, scale: float, softcap: float = 0.0, kv_repeat: int = 1):
    """Causal attention of in-flight blocks against themselves, unnormalized.

    q [N, T, Dh]; k, v [N / kv_repeat, T, Dh] (query row ``n`` reads K/V
    row ``n // kv_repeat``); kv_len [N] (or a scalar): query ``t`` of row
    ``n`` sees keys ``j <= t`` with ``j < kv_len[n]``.  Returns (acc
    [N, T, Dh], m [N, T], l [N, T]) in f32."""
    f32 = torch.float32
    N, T, _ = q.shape
    if kv_repeat > 1:
        k = k.repeat_interleave(kv_repeat, dim=0)
        v = v.repeat_interleave(kv_repeat, dim=0)
    s = torch.einsum("ntd,nsd->nts", q.to(f32), k.to(f32)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(T, device=q.device)[:, None]
    ki = torch.arange(T, device=q.device)[None, :]
    kv_len = torch.as_tensor(kv_len, dtype=torch.int32, device=q.device).expand(N)
    ok = (ki <= qi)[None] & (ki[None] < kv_len[:, None, None])
    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    return torch.einsum("nts,nsd->ntd", p, v.to(f32)), m, l


def gear_compress_ref(x, *, bits: int, scheme: str, group: int | None = None, n_out: int = 0,
                      stat_dtype="bfloat16"):
    """Fused chunk compression of ``x`` [N, nb, d] (f32): top/bottom-``n_out``
    outliers per vector (``iterative_topk`` order, set-semantics densify),
    the remainder quantized and packed, and the f32 residual
    ``x - deq - S`` against the stats rounded through ``stat_dtype``.

    Returns (packed int32 [N, nb, d/per], scale f32, zero f32 (unrounded
    compact stats: [N, nb/g, d] per channel, [N, nb, d/g] per token),
    sp_val f32, sp_idx int32 ([N, d, 2k] per channel, [N, nb, 2k] per
    token; None without outliers), resid f32 [N, nb, d]).  Built on
    ``core.quant`` / ``core.outlier``, so it equals the pieces of
    ``core.gear.compress_matrix`` bit for bit."""
    per_channel = scheme == "per_channel"
    sp_val = sp_idx = None
    remainder = x
    dense = 0.0
    if n_out:
        sp, remainder = ol.filter_outliers_k(x, n_out, "token" if per_channel else "channel")
        sp_val, sp_idx = sp.values.to(torch.float32), sp.indices
        dense = ol.densify(sp)
    qt = q_lib.quantize(remainder, bits, scheme, group, stat_dtype=torch.float32)
    sd = q_lib.as_dtype(stat_dtype)
    scale_r = qt.scale.to(sd).to(torch.float32)
    zero_r = qt.zero.to(sd).to(torch.float32)
    deq = q_lib.dequantize(dataclasses.replace(qt, scale=scale_r, zero=zero_r))
    resid = x.to(torch.float32) - deq - dense
    return qt.packed, qt.scale, qt.zero, sp_val, sp_idx, resid


# ---------------------------------------------------------------------------
# linear_scan_chunked

SCAN_CLAMP = 30.0


def linear_scan_ref(r, k, v, log_w, u=None, *, chunk: int, mode: str = "inclusive",
                    state0=None):
    """Chunked linear recurrence S_t = diag(w_t) S_{t-1} + k_t v_t^T, the math
    of the reference's ``models.linear_scan.chunked_scan`` with the leading
    dims flattened, in f32.

    r, k [BH, S, Dk]; v [BH, S, Dv]; log_w broadcastable to r (``[BH, S, 1]``:
    one decay per head); u [BH, Dk] (``mode="bonus"``); state0 [BH, Dk, Dv]
    or None.  ``inclusive``: y_t = r_t^T S_t; ``bonus``: y_t = r_t^T (S_{t-1}
    + diag(u) k_t v_t^T).  Within a chunk the factored form clamps the query
    factor at e^-30 and the key factor at e^+30, as the reference does, so
    a chunk whose cumulative decay passes e^-30 does not compute the exact
    recurrence.  Returns (y [BH, S, Dv] in v's dtype, state [BH, Dk, Dv] f32).
    """
    BH, S, Dk = r.shape
    Dv = v.shape[-1]
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} not divisible by chunk={chunk}")
    if mode not in ("inclusive", "bonus"):
        raise ValueError(f"mode must be inclusive/bonus, got {mode!r}")
    C, W = S // chunk, chunk
    f32 = torch.float32
    rc = r.to(f32).reshape(BH, C, W, Dk)
    kc = k.to(f32).reshape(BH, C, W, Dk)
    vc = v.to(f32).reshape(BH, C, W, Dv)
    lw = torch.broadcast_to(log_w.to(f32), (BH, S, Dk)).reshape(BH, C, W, Dk)
    state = (torch.zeros((BH, Dk, Dv), dtype=f32, device=r.device) if state0 is None
             else state0.to(f32).clone())

    cum = torch.cumsum(lw, dim=2)                         # inclusive prod_{u<=t} w_u
    q_cum = cum if mode == "inclusive" else cum - lw
    tri = torch.tril(torch.ones((W, W), dtype=f32, device=r.device),
                     0 if mode == "inclusive" else -1)
    q_fac = rc * torch.exp(torch.clamp(q_cum, min=-SCAN_CLAMP))
    k_fac = kc * torch.exp(torch.clamp(-cum, max=SCAN_CLAMP))
    att = torch.einsum("xcwk,xcyk->xcwy", q_fac, k_fac) * tri
    y = torch.einsum("xcwy,xcyv->xcwv", att, vc)
    if mode == "bonus":
        bonus = torch.einsum("xcwk,xk,xcwk->xcw", rc, u.to(f32), kc)
        y = y + bonus[..., None] * vc

    decay_last = torch.exp(torch.clamp(cum[:, :, -1, :], min=-SCAN_CLAMP))          # [BH, C, Dk]
    k_state = kc * torch.exp(torch.clamp(cum[:, :, -1:, :] - cum, min=-SCAN_CLAMP))
    state_inc = torch.einsum("xcwk,xcwv->xckv", k_state, vc)
    y_cross = []
    for c in range(C):
        y_cross.append(torch.einsum("xwk,xkv->xwv", q_fac[:, c], state))
        state = state * decay_last[:, c, :, None] + state_inc[:, c]
    y = y + torch.stack(y_cross, dim=1)
    return y.reshape(BH, S, Dv).to(v.dtype), state
