"""Static-shape GEAR-compressed KV cache with streaming buffer (dense layout).

Port of the dense GEAR half of ``repro.core.cache``.  The cache is divided
into chunks of ``n_b`` tokens; prefill compresses ``n // n_b`` chunks in one
batched event and leaves the rest in the FP16 streaming buffer, and decode
appends to the buffer and compresses it into its chunk slot when it fills.

Every leaf keeps the reference's shape and dtype (H = kv heads, S =
capacity, C = S / n_b, r = policy.rank, per = 32 // bits):

  k_packed  int32 [B, H, S, Dh/per]      v_packed  int32 [B, H, S, Dh/per]
  k_scale   bf16  [B, H, C, Dh]          v_scale   bf16  [B, H, S, Gv]
  k_zero            (same as k_scale)    v_zero            (same as v_scale)
  k_a       bf16  [B, H, S, r]           v_a       bf16  [B, H, S, r]
  k_b       bf16  [B, H, C, Dh, r]       v_b       bf16  [B, H, C, Dh, r]
  k_sp_val  bf16  [B, H, C, Dh, 2ks]     v_sp_val  bf16  [B, H, S, 2kv]
  k_sp_idx  int32   (same)               v_sp_idx  int32   (same)
  buf_k/buf_v bf16 [B, H, n_b, Dh]       length    int32 [B]

(shown for per-channel K at chunk granularity; the per-token-group backbone
stores K in the V layout.)  Where the reference returns a new pytree, the
port writes into the cache's tensors in place and returns the same object;
each such write says so.  FP16 and sliding-window caches are not ported yet
(ROADMAP queue item 10).

Two more ways in and one more layout come from the reference:

* streaming prefill (:func:`streaming_prefill_layer_cache`): the prompt's
  closed chunks are compressed in one fused event, and each chunk's queries
  attend the compressed history before it plus the chunk itself — decode's
  semantics.  The cache equals a monolithic prefill's bit for bit.
* the paged pool (:class:`PagedGEARLayerCache`): closed chunks live in
  pages of a pool shared by all slots, named by per-slot block tables;
  page 0 stays zero, so gathering a slot's pages gives the dense cache bit
  for bit (:func:`paged_to_dense`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gear as gear_lib
from repro_torch.core import lowrank as lr_lib
from repro_torch.core.outlier import outlier_count
from repro_torch.core.policy import CompressionPolicy
from repro_torch.kernels.gear_compress import gear_compress
from repro_torch.models.common import resolve_device

__all__ = [
    "CacheConfig", "GEARLayerCache", "NumericFault",
    "init_layer_cache", "prefill_layer_cache", "append_token",
    "splice_slot", "reset_slot", "tree_finite", "FIELDS",
    "streaming_supported", "chunk_prefix_view", "streaming_prefill_layer_cache",
    "PagedGEARLayerCache", "BlockTables", "POOLED_FIELDS", "paged_supported",
    "page_field_shapes", "page_nbytes", "init_paged_layer_cache", "paged_to_dense",
    "extract_prefix_chunks", "gather_pool_chunks", "scatter_pool_chunks",
    "zero_pool_pages", "append_token_paged",
]

NEG_INF = -1e30

FIELDS = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero",
          "k_a", "k_b", "v_a", "v_b",
          "k_sp_val", "k_sp_idx", "v_sp_val", "v_sp_idx",
          "buf_k", "buf_v", "length")


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    """Static geometry of one attention layer's cache."""

    batch: int
    kv_heads: int
    head_dim: int
    capacity: int            # max tokens (multiple of chunk)
    policy: CompressionPolicy
    kind: str = "gear"       # only "gear" is ported
    window: int = 0

    def __post_init__(self):
        if self.kind != "gear":
            raise NotImplementedError(
                f"cache kind {self.kind!r} is not ported yet (ROADMAP queue "
                "item 10: FP16/window caches)")
        if self.capacity % self.chunk:
            raise ValueError(f"capacity {self.capacity} not a multiple of chunk {self.chunk}")

    @property
    def chunk(self) -> int:
        return self.policy.buffer_size

    @property
    def n_chunks(self) -> int:
        return self.capacity // self.chunk

    def k_scheme(self):
        return self.policy.scheme_for("k")

    def v_scheme(self):
        return self.policy.scheme_for("v")


@dataclasses.dataclass
class GEARLayerCache:
    k_packed: torch.Tensor
    k_scale: torch.Tensor
    k_zero: torch.Tensor
    v_packed: torch.Tensor
    v_scale: torch.Tensor
    v_zero: torch.Tensor
    k_a: torch.Tensor | None
    k_b: torch.Tensor | None
    v_a: torch.Tensor | None
    v_b: torch.Tensor | None
    k_sp_val: torch.Tensor | None
    k_sp_idx: torch.Tensor | None
    v_sp_val: torch.Tensor | None
    v_sp_idx: torch.Tensor | None
    buf_k: torch.Tensor
    buf_v: torch.Tensor
    length: torch.Tensor

    def tensors(self) -> dict:
        """Non-None leaves by field name."""
        return {f: getattr(self, f) for f in FIELDS if getattr(self, f) is not None}


class NumericFault(RuntimeError):
    """A compressed chunk failed the NaN/Inf finiteness guard."""


# ---------------------------------------------------------------------------
# Shape helpers


def _k_stat_rows(cfg: CacheConfig) -> tuple[int, int]:
    scheme, group = cfg.k_scheme()
    if scheme == "per_channel":
        g = cfg.chunk if group is None else group
        return cfg.n_chunks * (cfg.chunk // g), cfg.head_dim
    g = cfg.head_dim if group is None else group
    return cfg.capacity, cfg.head_dim // g


def _v_stat_rows(cfg: CacheConfig) -> tuple[int, int]:
    _, group = cfg.v_scheme()
    g = cfg.head_dim if group is None else group
    return cfg.capacity, cfg.head_dim // g


def _sparse_caps(cfg: CacheConfig) -> tuple[int, int]:
    ks = outlier_count(cfg.chunk, cfg.policy.sparsity)       # K: along tokens in chunk
    kv = outlier_count(cfg.head_dim, cfg.policy.sparsity)    # V: along channels
    return ks, kv


def _k_per_channel(cfg: CacheConfig) -> bool:
    return cfg.k_scheme()[0] == "per_channel"


def init_layer_cache(cfg: CacheConfig, dtype=torch.bfloat16, device=None) -> GEARLayerCache:
    """Zero layer cache on ``device`` (CUDA unless the caller names another)."""
    device = resolve_device(device)
    B, H, Dh, S = cfg.batch, cfg.kv_heads, cfg.head_dim, cfg.capacity
    pol = cfg.policy
    per = 32 // pol.bits
    C, r = cfg.n_chunks, pol.rank
    ks, kvo = _sparse_caps(cfg)
    krows, kcols = _k_stat_rows(cfg)
    vrows, vcols = _v_stat_rows(cfg)
    lr, sp = pol.use_lowrank, pol.use_sparse

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def zi(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    k_sp_shape = (B, H, C, Dh, 2 * ks) if _k_per_channel(cfg) else (B, H, S, 2 * kvo)
    return GEARLayerCache(
        k_packed=zi(B, H, S, Dh // per),
        k_scale=z(B, H, krows, kcols), k_zero=z(B, H, krows, kcols),
        v_packed=zi(B, H, S, Dh // per),
        v_scale=z(B, H, vrows, vcols), v_zero=z(B, H, vrows, vcols),
        k_a=z(B, H, S, r) if lr else None,
        k_b=z(B, H, C, Dh, r) if lr else None,
        v_a=z(B, H, S, r) if lr else None,
        v_b=z(B, H, C, Dh, r) if lr else None,
        k_sp_val=z(*k_sp_shape) if sp else None,
        k_sp_idx=zi(*k_sp_shape) if sp else None,
        v_sp_val=z(B, H, S, 2 * kvo) if sp else None,
        v_sp_idx=zi(B, H, S, 2 * kvo) if sp else None,
        buf_k=z(B, H, pol.buffer_size, Dh),
        buf_v=z(B, H, pol.buffer_size, Dh),
        length=zi(B),
    )


# ---------------------------------------------------------------------------
# Compression of chunk batches


def _compress_chunks(cfg: CacheConfig, k: torch.Tensor, v: torch.Tensor, rank: int) -> dict:
    """Compress ``k``/``v`` [B, H, C', nb, Dh] -> dict of per-chunk arrays.

    The reference's ``fused="off"`` branch (plain ``compress_matrix``) — the
    one monolithic prefill and the decode chunk close take.  Low-rank
    factors are zero-padded to ``policy.rank`` columns.
    """
    pol = cfg.policy
    out = {}
    for name, x in (("k", k), ("v", v)):
        cm = gear_lib.compress_matrix(x, pol, name, rank=rank)
        out[f"{name}_packed"] = cm.qt.packed
        out[f"{name}_scale"] = cm.qt.scale.to(torch.bfloat16)
        out[f"{name}_zero"] = cm.qt.zero.to(torch.bfloat16)
        if pol.use_lowrank:
            pad = pol.rank - rank
            out[f"{name}_a"] = torch.nn.functional.pad(cm.a, (0, pad))
            out[f"{name}_b"] = torch.nn.functional.pad(cm.b, (0, pad))
        if pol.use_sparse:
            out[f"{name}_sp_val"] = cm.sparse.values.to(torch.bfloat16)
            out[f"{name}_sp_idx"] = cm.sparse.indices.to(torch.int32)
    return out


def _compress_chunks_fused(cfg: CacheConfig, k: torch.Tensor, v: torch.Tensor,
                           rank: int) -> dict:
    """Fused-kernel twin of :func:`_compress_chunks` (same output layout):
    one ``gear_compress`` launch for all of K's B*H*C' tiles, one for V's,
    then one batched power iteration per tensor on the kernel's residuals.
    Equal to :func:`_compress_chunks` bit for bit (the streaming prefill's
    compression event; the reference's ``fused="auto"``)."""
    pol = cfg.policy
    out = {}
    for name, x in (("k", k), ("v", v)):
        scheme, group = pol.scheme_for(name)
        B, H, C, nb, Dh = x.shape
        vec_len = nb if scheme == "per_channel" else Dh
        n_out = outlier_count(vec_len, pol.sparsity) if pol.use_sparse else 0
        packed, scale, zero, spv, spi, resid = gear_compress(
            x.reshape(B * H * C, nb, Dh), bits=pol.bits, scheme=scheme, group=group,
            n_out=n_out, stat_dtype=pol.stat_dtype)
        lead = (B, H, C)
        out[f"{name}_packed"] = packed.reshape(lead + tuple(packed.shape[1:]))
        out[f"{name}_scale"] = scale.reshape(lead + tuple(scale.shape[1:])).to(torch.bfloat16)
        out[f"{name}_zero"] = zero.reshape(lead + tuple(zero.shape[1:])).to(torch.bfloat16)
        if pol.use_lowrank:
            a, b = lr_lib.power_iteration(resid.reshape(lead + (nb, Dh)), rank, pol.power_iters)
            pad = pol.rank - rank
            out[f"{name}_a"] = torch.nn.functional.pad(a.to(torch.bfloat16), (0, pad))
            out[f"{name}_b"] = torch.nn.functional.pad(b.to(torch.bfloat16), (0, pad))
        if pol.use_sparse:
            out[f"{name}_sp_val"] = spv.reshape(lead + tuple(spv.shape[1:])).to(torch.bfloat16)
            out[f"{name}_sp_idx"] = spi.reshape(lead + tuple(spi.shape[1:])).to(torch.int32)
    return out


def _store_chunks(cfg: CacheConfig, cache: GEARLayerCache, comp: dict,
                  rows: slice, n_chunks: int, chunk0: int) -> None:
    """Write one compression event's ``n_chunks`` chunks into ``cache`` in
    place, starting at chunk ``chunk0``, for the batch rows of the slice
    ``rows`` (``comp``'s batch dim).  Shared by prefill (all rows, chunk 0)
    and the decode chunk close (one slot, its closing chunk).
    """
    pol = cfg.policy
    nb = cfg.chunk
    t0, t1 = chunk0 * nb, (chunk0 + n_chunks) * nb
    Bc, H = comp["k_packed"].shape[:2]

    def tok_rows(x):               # [Bc, H, C', nb, ...] -> [Bc, H, C'*nb, ...]
        return x.reshape((Bc, H, n_chunks * nb) + tuple(x.shape[4:]))

    cache.k_packed[rows, :, t0:t1] = tok_rows(comp["k_packed"])
    cache.v_packed[rows, :, t0:t1] = tok_rows(comp["v_packed"])
    for kv in ("k", "v"):
        stat_s = comp[f"{kv}_scale"].reshape(Bc, H, -1, comp[f"{kv}_scale"].shape[-1])
        stat_z = comp[f"{kv}_zero"].reshape(Bc, H, -1, comp[f"{kv}_zero"].shape[-1])
        rpc = stat_s.shape[2] // n_chunks
        getattr(cache, f"{kv}_scale")[rows, :, chunk0 * rpc:(chunk0 + n_chunks) * rpc] = stat_s
        getattr(cache, f"{kv}_zero")[rows, :, chunk0 * rpc:(chunk0 + n_chunks) * rpc] = stat_z
        if pol.use_lowrank:
            getattr(cache, f"{kv}_a")[rows, :, t0:t1] = tok_rows(comp[f"{kv}_a"])
            getattr(cache, f"{kv}_b")[rows, :, chunk0:chunk0 + n_chunks] = comp[f"{kv}_b"]
        if pol.use_sparse:
            sv, si = comp[f"{kv}_sp_val"], comp[f"{kv}_sp_idx"]
            if kv == "v" or not _k_per_channel(cfg):
                getattr(cache, f"{kv}_sp_val")[rows, :, t0:t1] = tok_rows(sv)
                getattr(cache, f"{kv}_sp_idx")[rows, :, t0:t1] = tok_rows(si)
            else:
                getattr(cache, f"{kv}_sp_val")[rows, :, chunk0:chunk0 + n_chunks] = sv
                getattr(cache, f"{kv}_sp_idx")[rows, :, chunk0:chunk0 + n_chunks] = si


def prefill_layer_cache(cfg: CacheConfig, cache: GEARLayerCache, k: torch.Tensor,
                        v: torch.Tensor) -> GEARLayerCache:
    """Fill a fresh layer cache from prefill K/V [B, H, n, Dh].

    Writes into ``cache`` in place (the reference builds a new tree) and
    returns it.
    """
    n = k.shape[2]
    B, H, _, Dh = k.shape
    nb = cfg.chunk
    n_full = (n // nb) * nb
    C_new = n_full // nb
    if n > cfg.capacity:
        raise ValueError(f"prompt of {n} tokens exceeds capacity {cfg.capacity}")
    if C_new > 0:
        # f32 compression inputs (exact widening of bf16 K/V), as the reference
        kc = k[:, :, :n_full].reshape(B, H, C_new, nb, Dh).to(torch.float32)
        vc = v[:, :, :n_full].reshape(B, H, C_new, nb, Dh).to(torch.float32)
        comp = _compress_chunks(cfg, kc, vc, cfg.policy.rank)
        _store_chunks(cfg, cache, comp, slice(None), C_new, 0)
    rem = n - n_full
    if rem:
        cache.buf_k[:, :, :rem] = k[:, :, n_full:]
        cache.buf_v[:, :, :rem] = v[:, :, n_full:]
    cache.length.fill_(n)
    return cache


def append_token(cfg: CacheConfig, cache: GEARLayerCache, k_t: torch.Tensor,
                 v_t: torch.Tensor, lengths: np.ndarray) -> GEARLayerCache:
    """Append one token's K/V [B, H, Dh] per slot; compress full buffers.

    ``lengths`` is the host copy of ``cache.length`` before the append (the
    engine knows it, so no device sync per layer).  Each slot writes its
    buffer row ``length % n_b`` and advances; a slot whose buffer just
    filled (and whose chunk fits the capacity) gets its chunk compressed
    and written to its chunk slot, alone, at batch 1, so its compression
    never depends on what else shares the batch.  Slots not at a boundary
    write nothing else, as the reference's dropped scatter.  All writes are
    in place.
    """
    nb = cfg.chunk
    B = cache.length.shape[0]
    lengths = np.asarray(lengths, np.int64)
    bidx = torch.arange(B, device=k_t.device)
    buf_pos = cache.length.long() % nb                             # device-side, no copy
    cache.buf_k[bidx, :, buf_pos] = k_t.to(cache.buf_k.dtype)      # in place
    cache.buf_v[bidx, :, buf_pos] = v_t.to(cache.buf_v.dtype)
    cache.length += 1
    new = lengths + 1
    need = (new % nb == 0) & (new > 0) & (new <= cfg.capacity)
    for b in np.nonzero(need)[0]:
        b = int(b)
        cidx = int(new[b] - 1) // nb
        kc = cache.buf_k[b:b + 1, :, None].to(torch.float32)          # [1, H, 1, nb, Dh]
        vc = cache.buf_v[b:b + 1, :, None].to(torch.float32)
        comp = _compress_chunks(cfg, kc, vc, cfg.policy.rank_decode)
        _store_chunks(cfg, cache, comp, slice(b, b + 1), 1, cidx)   # in place
    return cache


# ---------------------------------------------------------------------------
# Streaming prefill


def streaming_supported(cfg: CacheConfig) -> bool:
    """True when this layer cache can take the streaming prefill: its
    history scorer (``gear_decode``) streams one K-stat row per chunk, so it
    needs a GEAR cache with per-channel K stats at chunk granularity."""
    if cfg.kind != "gear" or cfg.policy.is_fp16:
        return False
    scheme, group = cfg.k_scheme()
    return scheme == "per_channel" and (cfg.chunk if group is None else group) == cfg.chunk


def chunk_prefix_view(cfg: CacheConfig, cache: GEARLayerCache, n_chunks: int) -> GEARLayerCache:
    """View of the first ``n_chunks`` chunks of a dense GEAR cache (buffer and
    length pass through).  Scores past a query's extent are exact zeros
    after the softmax, so attending through the prefix changes no value;
    the plain history scorer uses it to skip the chunks no query can see."""
    if n_chunks >= cfg.n_chunks:
        return cache
    S_pre = n_chunks * cfg.chunk
    pol = cfg.policy
    k_rows = _k_stat_rows(cfg)[0] // cfg.n_chunks * n_chunks
    d = dict(k_packed=cache.k_packed[:, :, :S_pre], v_packed=cache.v_packed[:, :, :S_pre],
             k_scale=cache.k_scale[:, :, :k_rows], k_zero=cache.k_zero[:, :, :k_rows],
             v_scale=cache.v_scale[:, :, :S_pre], v_zero=cache.v_zero[:, :, :S_pre])
    if pol.use_lowrank:
        d.update(k_a=cache.k_a[:, :, :S_pre], v_a=cache.v_a[:, :, :S_pre],
                 k_b=cache.k_b[:, :, :n_chunks], v_b=cache.v_b[:, :, :n_chunks])
    if pol.use_sparse:
        k_sp = n_chunks if _k_per_channel(cfg) else S_pre
        d.update(k_sp_val=cache.k_sp_val[:, :, :k_sp], k_sp_idx=cache.k_sp_idx[:, :, :k_sp],
                 v_sp_val=cache.v_sp_val[:, :, :S_pre], v_sp_idx=cache.v_sp_idx[:, :, :S_pre])
    return dataclasses.replace(cache, **d)


def streaming_prefill_pipeline(cfg: CacheConfig, cache: GEARLayerCache, n: int, q_heads: int,
                               project, scale: float, *, tail_is_padded: bool = False,
                               true_n: int | None = None):
    """Shared body of the streaming chunked prefill (port of the
    reference's ``streaming_prefill_pipeline``).

    ``project(t0, t1) -> (q [B, q_heads, t1 - t0, Dh], k, v [B, H, t1 - t0,
    Dh])`` gives the attention inputs of tokens ``[t0, t1)``.  The model
    layer projects there, one chunk at a time, so the full-sequence FP16 K/V
    never exists: each closed chunk's K and V are widened straight into one
    f32 tile buffer [B, H, C', n_b, Dh] each (its Q into [B, H, C', G, n_b,
    Dh]).  Those buffers are the compression input, so every closed chunk
    is compressed in one fused event (:func:`_compress_chunks_fused`: one
    ``gear_compress`` launch for K, one for V), and the attention input, so
    each chunk's queries attend the compressed history before it plus the
    chunk itself.  The leftover tokens form one more, zero-padded block that
    attends the same way and lands in the FP16 buffer; every block goes
    through one ``ops.gear_attend_block`` call.  The cache equals
    :func:`prefill_layer_cache`'s bit for bit; the attention output sees
    the history compressed, as decode does.

    ``tail_is_padded`` is the length-bucketing hook: ``n`` is then a chunk
    multiple whose last ``n_b`` block is a right-padded tail holding
    ``true_n - (n - n_b)`` real tokens.  That block is never compressed; it
    lands in the buffer, and ``length`` is set from ``true_n``, so decode
    masks the pad rows.  Writes ``cache`` in place; returns (cache,
    out [B, q_heads, n, Dh] in q's dtype).
    """
    if not streaming_supported(cfg):
        raise ValueError(
            "streaming prefill requires a GEAR cache with per-channel K stats at chunk "
            f"granularity (got k_scheme={cfg.k_scheme()!r}, chunk={cfg.chunk})")
    from repro_torch.kernels import ops      # lazy: the kernels import this module

    nb, H, Dh = cfg.chunk, cfg.kv_heads, cfg.head_dim
    B = cache.length.shape[0]
    G = q_heads // H
    f32 = torch.float32
    if tail_is_padded and n % nb:
        raise ValueError(f"padded-tail prefill needs n % n_b == 0 (n={n}, n_b={nb})")
    C_new = n // nb - 1 if tail_is_padded else n // nb
    n_full = C_new * nb
    rem = n - n_full
    n_real = n if true_n is None else int(true_n)
    if n_real > cfg.capacity:
        raise ValueError(f"prefill of {n_real} tokens exceeds capacity {cfg.capacity}")
    n_blk = C_new + (1 if rem else 0)
    dev = cache.length.device
    kt = torch.empty((B, H, n_blk, nb, Dh), dtype=f32, device=dev)
    vt = torch.empty_like(kt)
    qt = torch.empty((B, H, n_blk, G, nb, Dh), dtype=f32, device=dev)
    for c in range(C_new):
        q_c, k_c, v_c = project(c * nb, (c + 1) * nb)
        kt[:, :, c] = k_c                      # exact widening, as the reference's astype
        vt[:, :, c] = v_c
        qt[:, :, c] = q_c.reshape(B, H, G, nb, Dh)
    if rem:                                    # the tail block, zero past its tokens
        q_c, k_t, v_t = project(n_full, n)
        for tile, x in ((kt, k_t), (vt, v_t)):
            tile[:, :, C_new, :rem] = x
            tile[:, :, C_new, rem:] = 0.0
        qt[:, :, C_new, :, :rem] = q_c.reshape(B, H, G, rem, Dh)
        qt[:, :, C_new, :, rem:] = 0.0
    if C_new:
        comp = _compress_chunks_fused(cfg, kt[:, :, :C_new], vt[:, :, :C_new], cfg.policy.rank)
        _store_chunks(cfg, cache, comp, slice(None), C_new, 0)
    # every block, the tail too, in one ops.gear_attend_block call
    out = ops.gear_attend_block(cfg, cache, qt, kt, vt, [c * nb for c in range(n_blk)],
                                [nb] * C_new + ([rem] if rem else []), scale)
    # [B, H, NB, G, nb, Dh] -> [B, Hq, NB * nb, Dh], cut to n
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(B, q_heads, n_blk * nb, Dh)[:, :, :n]
    if rem:
        cache.buf_k[:, :, :rem] = k_t.to(cache.buf_k.dtype)
        cache.buf_v[:, :, :rem] = v_t.to(cache.buf_v.dtype)
    cache.length.fill_(n_real)
    return cache, out.to(q_c.dtype)


def streaming_prefill_layer_cache(cfg: CacheConfig, cache: GEARLayerCache, q: torch.Tensor,
                                  k: torch.Tensor, v: torch.Tensor, scale: float, *,
                                  tail_is_padded: bool = False, true_n: int | None = None):
    """Streaming chunked prefill over precomputed q [B, Hq, n, Dh] and k, v
    [B, H, n, Dh], sliced per chunk into :func:`streaming_prefill_pipeline`
    (the model layer instead projects per chunk).  Returns (cache,
    out [B, Hq, n, Dh] in q's dtype)."""
    return streaming_prefill_pipeline(
        cfg, cache, q.shape[2], q.shape[1],
        lambda t0, t1: (q[:, :, t0:t1], k[:, :, t0:t1], v[:, :, t0:t1]), scale,
        tail_is_padded=tail_is_padded, true_n=true_n)


# ---------------------------------------------------------------------------
# Slot protocol + numeric guard


def _parts(layer) -> tuple:
    """A layer cache's objects: the GEAR cache alone, a hybrid layer's (GEAR
    cache, SSM state) pair, or an RWKV6 layer's recurrent state alone.  Each
    has ``tensors()``."""
    return layer if isinstance(layer, tuple) else (layer,)


def splice_slot(full, one, slot: int):
    """Write batch-1 layer cache ``one`` into batch row ``slot`` of ``full``
    (in place; a hybrid pair's SSM state too, and an RWKV6 state's token
    shifts and recurrent state)."""
    for dst_part, src_part in zip(_parts(full), _parts(one)):
        for name, dst in dst_part.tensors().items():
            dst[slot].copy_(getattr(src_part, name)[0])
    return full


def reset_slot(cache, slot: int):
    """Return batch row ``slot`` to the empty state: every leaf zeroed (what
    the reference's splice of a fresh zero cache writes; a hybrid's conv
    window and recurrent state, and an RWKV6 state, included), in place."""
    for part in _parts(cache):
        for t in part.tensors().values():
            t[slot].zero_()
    return cache


def tree_finite(caches) -> torch.Tensor:
    """Scalar bool tensor: every floating leaf of ``caches`` (one layer cache
    or a list of them; hybrid pairs and RWKV6 states included) is finite.
    Integer leaves cannot hold NaN/Inf."""
    layers = caches if isinstance(caches, list) else [caches]
    oks = [torch.isfinite(t).all() for c in layers for part in _parts(c)
           for t in part.tensors().values() if t.is_floating_point()]
    if not oks:
        return torch.tensor(True)
    return torch.stack(oks).all()


# ---------------------------------------------------------------------------
# Paged compressed KV pool
#
# One page holds one n_b-token chunk's compressed fields for one layer: every
# chunk-indexed field of the dense layout (``_chunk_row_axes``) has a pooled
# twin whose batch axis is a page axis and whose chunk-row axis is one
# chunk's rows.  A per-slot block table [B, C] names the page of each logical
# chunk; page 0 is never allocated and stays zero, and fresh pages are zeroed
# at admission, so every table entry past a slot's extent reads the dense
# layout's zeros.  The FP16 buffer and ``length`` stay per-slot.


POOLED_FIELDS = FIELDS[:14]


@dataclasses.dataclass
class PagedGEARLayerCache:
    """GEAR layer cache with pooled chunk storage: pooled fields are
    ``[P, ...one page]``; ``buf_k``/``buf_v`` ``[B, H, n_b, Dh]`` and
    ``length [B]`` stay per-slot."""

    k_packed: torch.Tensor
    k_scale: torch.Tensor
    k_zero: torch.Tensor
    v_packed: torch.Tensor
    v_scale: torch.Tensor
    v_zero: torch.Tensor
    k_a: torch.Tensor | None
    k_b: torch.Tensor | None
    v_a: torch.Tensor | None
    v_b: torch.Tensor | None
    k_sp_val: torch.Tensor | None
    k_sp_idx: torch.Tensor | None
    v_sp_val: torch.Tensor | None
    v_sp_idx: torch.Tensor | None
    buf_k: torch.Tensor
    buf_v: torch.Tensor
    length: torch.Tensor

    def tensors(self) -> dict:
        return {f: getattr(self, f) for f in FIELDS if getattr(self, f) is not None}


@dataclasses.dataclass(frozen=True)
class BlockTables:
    """A paged engine's block tables ``[B, C]`` (int32): the host mirror, from
    which a closing decode chunk's page is chosen without a device sync, and
    its device copy, which the kernel reads.  The engine builds a new pair
    at each admission and release, never per step."""

    host: np.ndarray
    device: torch.Tensor


def _chunk_row_axes(cfg: CacheConfig) -> dict:
    """Field -> ``(rows_per_chunk, row_axis_from_end)``: chunk ``c`` of a dense
    cache field occupies rows ``[c * rpc, (c + 1) * rpc)`` of that axis."""
    if cfg.kind != "gear":
        raise ValueError(f"chunk rows require a GEAR cache, got {cfg.kind!r}")
    pol = cfg.policy
    nb, C = cfg.chunk, cfg.n_chunks
    spec = {"k_packed": (nb, -2), "v_packed": (nb, -2),
            "k_scale": (_k_stat_rows(cfg)[0] // C, -2), "k_zero": (_k_stat_rows(cfg)[0] // C, -2),
            "v_scale": (_v_stat_rows(cfg)[0] // C, -2), "v_zero": (_v_stat_rows(cfg)[0] // C, -2)}
    if pol.use_lowrank:
        spec.update(k_a=(nb, -2), v_a=(nb, -2), k_b=(1, -3), v_b=(1, -3))
    if pol.use_sparse:
        k_row = (1, -3) if _k_per_channel(cfg) else (nb, -2)
        spec.update(k_sp_val=k_row, k_sp_idx=k_row, v_sp_val=(nb, -2), v_sp_idx=(nb, -2))
    return spec


def extract_prefix_chunks(cfg: CacheConfig, cache: GEARLayerCache,
                          n_chunks: int) -> list[dict]:
    """Per-chunk payload dicts (views) of the first ``n_chunks`` chunks of a
    dense cache, batch axis kept."""
    spec = _chunk_row_axes(cfg)
    out = []
    for c in range(n_chunks):
        payload = {}
        for field, (rpc, ax) in spec.items():
            arr = getattr(cache, field)
            payload[field] = arr.narrow(arr.dim() + ax, c * rpc, rpc)
        out.append(payload)
    return out


def paged_supported(cfg: CacheConfig) -> bool:
    """Any GEAR layout can live in the pool (gathering reassembles the dense
    layout bit for bit); fp16 caches have no chunks."""
    return cfg.kind == "gear" and not cfg.policy.is_fp16


def page_field_shapes(cfg: CacheConfig, dtype=torch.bfloat16) -> dict:
    """Field -> ``(page_shape, dtype)`` of one pool page: the batch-1 dense
    field without its batch axis, its chunk-row axis cut to one chunk."""
    one = init_layer_cache(dataclasses.replace(cfg, batch=1), dtype, device="meta")
    out = {}
    for field, (rpc, ax) in _chunk_row_axes(cfg).items():
        leaf = getattr(one, field)
        shape = list(leaf.shape[1:])
        shape[len(shape) + ax] = rpc
        out[field] = (tuple(shape), leaf.dtype)
    return out


def page_nbytes(cfg: CacheConfig, dtype=torch.bfloat16) -> int:
    """Bytes of one pool page for one layer of this geometry."""
    return sum(int(np.prod(shape)) * dt.itemsize
               for shape, dt in page_field_shapes(cfg, dtype).values())


def init_paged_layer_cache(cfg: CacheConfig, n_pages: int, dtype=torch.bfloat16,
                           device=None) -> PagedGEARLayerCache:
    """Zero pool of ``n_pages`` pages (page 0 reserved) plus per-slot buffers
    for ``cfg.batch`` slots, on ``device`` (CUDA unless named)."""
    if not paged_supported(cfg):
        raise ValueError(f"paged layout requires a GEAR cache, got {cfg.kind!r}")
    if n_pages < 2:
        raise ValueError(f"need >= 2 pages (page 0 is reserved), got {n_pages}")
    device = resolve_device(device)
    shapes = page_field_shapes(cfg, dtype)
    pooled = {f: None if f not in shapes else
              torch.zeros((n_pages,) + shapes[f][0], dtype=shapes[f][1], device=device)
              for f in POOLED_FIELDS}
    B, H, Dh = cfg.batch, cfg.kv_heads, cfg.head_dim
    return PagedGEARLayerCache(
        **pooled,
        buf_k=torch.zeros((B, H, cfg.chunk, Dh), dtype=dtype, device=device),
        buf_v=torch.zeros((B, H, cfg.chunk, Dh), dtype=dtype, device=device),
        length=torch.zeros((B,), dtype=torch.int32, device=device))


def paged_to_dense(cfg: CacheConfig, pcache: PagedGEARLayerCache,
                   block_tables: torch.Tensor) -> GEARLayerCache:
    """Gather the pool through ``block_tables [B, C]`` into a dense cache
    (bitwise the dense slot layout under the zero-page invariant)."""
    bt = block_tables.to(torch.int64)
    fields = {f: None for f in POOLED_FIELDS}
    for field, (rpc, ax) in _chunk_row_axes(cfg).items():
        g = getattr(pcache, field)[bt]                   # [B, C, ...page]
        row_axis = g.dim() + ax
        g = torch.movedim(g, 1, row_axis - 1)            # C next to the chunk rows
        shape = list(g.shape)
        shape[row_axis - 1:row_axis + 1] = [shape[row_axis - 1] * shape[row_axis]]
        fields[field] = g.reshape(shape)
    return GEARLayerCache(**fields, buf_k=pcache.buf_k, buf_v=pcache.buf_v,
                          length=pcache.length)


def gather_pool_chunks(cfg: CacheConfig, pcache: PagedGEARLayerCache,
                       pages: torch.Tensor) -> list[dict]:
    """Pool pages as per-chunk payload dicts with a leading batch-1 axis (the
    inverse of :func:`scatter_pool_chunks`)."""
    spec = _chunk_row_axes(cfg)
    return [{f: getattr(pcache, f)[int(p)][None] for f in spec} for p in pages]


def scatter_pool_chunks(cfg: CacheConfig, pcache: PagedGEARLayerCache, pages: torch.Tensor,
                        chunks: list[dict]) -> PagedGEARLayerCache:
    """Write batch-1 payload dicts (:func:`extract_prefix_chunks` layout) into
    pool pages ``pages [len(chunks)]`` (a long tensor on the pool's device),
    in place: a batch-1 prefill's closed chunks become the slot's pages."""
    if not chunks:
        return pcache
    for field in _chunk_row_axes(cfg):
        pool = getattr(pcache, field)
        pool[pages] = torch.stack([ch[field][0] for ch in chunks]).to(pool.dtype)
    return pcache


def zero_pool_pages(cfg: CacheConfig, pcache: PagedGEARLayerCache,
                    pages: torch.Tensor) -> PagedGEARLayerCache:
    """Zero the given pool pages in place: run at admission on fresh pages,
    so exposed-but-unwritten table entries keep reading zeros."""
    if len(pages):
        for field in _chunk_row_axes(cfg):
            getattr(pcache, field).index_fill_(0, pages, 0)
    return pcache


def append_token_paged(cfg: CacheConfig, pcache: PagedGEARLayerCache, block_tables: np.ndarray,
                       k_t: torch.Tensor, v_t: torch.Tensor,
                       lengths: np.ndarray) -> PagedGEARLayerCache:
    """Paged twin of :func:`append_token`: the same buffer writes and the same
    batch-1 chunk compression, stored into the slot's page for that chunk
    (``block_tables`` is the host mirror [B, C]).  A slot whose table names
    page 0 there (an idle slot, or a chunk past its reservation) drops the
    write, so the zero page is never touched.  All writes are in place."""
    nb = cfg.chunk
    B = pcache.length.shape[0]
    lengths = np.asarray(lengths, np.int64)
    bidx = torch.arange(B, device=k_t.device)
    buf_pos = pcache.length.long() % nb
    pcache.buf_k[bidx, :, buf_pos] = k_t.to(pcache.buf_k.dtype)
    pcache.buf_v[bidx, :, buf_pos] = v_t.to(pcache.buf_v.dtype)
    pcache.length += 1
    new = lengths + 1
    need = (new % nb == 0) & (new > 0) & (new <= cfg.capacity)
    for b in np.nonzero(need)[0]:
        b = int(b)
        page = int(block_tables[b, (new[b] - 1) // nb])
        if page == 0:
            continue
        comp = _compress_chunks(cfg, pcache.buf_k[b:b + 1, :, None].to(torch.float32),
                                pcache.buf_v[b:b + 1, :, None].to(torch.float32),
                                cfg.policy.rank_decode)
        for field in _chunk_row_axes(cfg):
            pool = getattr(pcache, field)
            pool[page] = comp[field].reshape(pool.shape[1:])
    return pcache
