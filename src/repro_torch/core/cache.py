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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import gear as gear_lib
from repro_torch.core.outlier import outlier_count
from repro_torch.core.policy import CompressionPolicy

__all__ = [
    "CacheConfig", "GEARLayerCache", "NumericFault",
    "init_layer_cache", "prefill_layer_cache", "append_token",
    "splice_slot", "reset_slot", "tree_finite", "FIELDS",
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


def init_layer_cache(cfg: CacheConfig, dtype=torch.bfloat16, device="cpu") -> GEARLayerCache:
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
# Slot protocol + numeric guard


def splice_slot(full: GEARLayerCache, one: GEARLayerCache, slot: int) -> GEARLayerCache:
    """Write batch-1 cache ``one`` into batch row ``slot`` of ``full`` (in place)."""
    for name, dst in full.tensors().items():
        dst[slot].copy_(getattr(one, name)[0])
    return full


def reset_slot(cache: GEARLayerCache, slot: int) -> GEARLayerCache:
    """Return batch row ``slot`` to the empty state: every leaf zeroed (what
    the reference's splice of a fresh zero cache writes), in place."""
    for t in cache.tensors().values():
        t[slot].zero_()
    return cache


def tree_finite(caches) -> torch.Tensor:
    """Scalar bool tensor: every floating leaf of ``caches`` (one layer cache
    or a list of them) is finite.  Integer leaves cannot hold NaN/Inf."""
    layers = caches if isinstance(caches, (list, tuple)) else [caches]
    oks = [torch.isfinite(t).all() for c in layers for t in c.tensors().values()
           if t.is_floating_point()]
    if not oks:
        return torch.tensor(True)
    return torch.stack(oks).all()
