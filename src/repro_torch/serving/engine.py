"""Serving engine: prefill + GEAR-cached decode on one device.

Port of ``repro.serving.engine.Engine`` with ``fused="auto"`` (the CUDA
kernels on a card, their plain versions for CPU tensors), no prefix cache
and no telemetry.  ``prefill_mode`` is "monolithic" or "streaming";
``layout`` is "dense" or "paged".  Other values raise
``NotImplementedError`` naming the ROADMAP queue item that brings them.

* Streaming prefill length-buckets a raw prompt to the next ``n_b``
  multiple: the padded tail lands in the FP16 buffer, never in a
  compressed chunk, and lengths and logits follow the raw length.
* The paged layout keeps closed chunks in a pool of pages
  (:mod:`repro_torch.serving.pagedpool`): a request reserves the pages of
  its own lifetime at admission, before any device work, and the block
  table goes to the device once per admission or release.
* A hybrid model (hymba: SSM heads beside attention) serves monolithic
  prefill on the dense layout only, unbucketed, as in the reference: its
  per-layer cache is the pair (GEAR cache, SSM state), which the slot
  protocol and the numeric guard cover.
* An RWKV6 model has no KV cache: its per-layer cache is the recurrent
  state, the policy touches no layer, prefill is unbucketed in either mode,
  the layout is dense only, and ``attend_path`` reports "xla", as the
  reference's does when no layer has a GEAR attention cache.

The cache tree is a list of per-layer caches that the engine updates in
place: ``decode``, ``prefill_slot`` and ``reset_slot`` return the same tree
they were given (the reference donates and rebuilds it).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import cache_cfg_for, check_serving
from repro_torch.serving.pagedpool import PagePool, pages_needed
from repro_torch.serving.views import DenseCacheView, PagedCacheView

__all__ = ["EngineConfig", "Engine"]

_CHOICES = {
    "fused": ("auto", "interpret", "off"),
    "prefill_mode": ("monolithic", "streaming"),
    "layout": ("dense", "paged"),
}
_NOT_PORTED = {
    ("fused", "off"): "the portable attend path (ROADMAP queue item 3)",
    ("fused", "interpret"): "the Pallas interpret lane; CUDA has no interpret mode "
                            "(CPU tensors take the plain versions; ROADMAP queue item 3)",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    batch: int
    capacity: int                  # max total tokens per sequence
    policy: CompressionPolicy
    temperature: float = 0.0
    top_k: int = 0
    eos_id: int = -1               # -1: never stop early
    fused: str = "auto"
    prefill_mode: str = "monolithic"
    prefix_cache: bool = False
    numeric_guard: bool = True
    layout: str = "dense"
    # paged pool size in pages, the zero page included; 0 gives
    # batch * n_chunks allocatable pages (dense-equivalent)
    pool_pages: int = 0
    obs: Any = None

    def __post_init__(self):
        for knob, options in _CHOICES.items():
            value = str(getattr(self, knob))
            if value not in options:
                raise ValueError(f"{knob} must be {'/'.join(options)}, got {value!r}")
            if (knob, value) in _NOT_PORTED:
                raise NotImplementedError(f"{knob}={value!r}: {_NOT_PORTED[knob, value]}")
            object.__setattr__(self, knob, value)
        if self.prefix_cache:
            raise NotImplementedError("prefix_cache: the prefix trie (ROADMAP queue item 7)")
        if self.obs:
            raise NotImplementedError("obs: serving telemetry (ROADMAP queue item 9)")
        if self.layout == "dense" and self.pool_pages:
            raise ValueError("pool_pages only applies to layout='paged'")


class Engine:
    def __init__(self, model: Model, params, ecfg: EngineConfig, device=None):
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"weights live on {params.device}, engine device is {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.ecfg = ecfg
        self.params = params
        # the GEAR attention layers' cache config; None when there are none
        self._ccfg = (None if self.cfg.rwkv else
                      cache_cfg_for(self.cfg, ecfg.policy, ecfg.batch, self._cap()))
        if self._ccfg is not None and not cache_lib.streaming_supported(self._ccfg):
            raise NotImplementedError(                       # the gear_decode layout
                f"policy {ecfg.policy} needs the portable attend path "
                "(ROADMAP queue item 3)")
        check_serving(self.cfg, ecfg.layout, ecfg.prefill_mode)    # before any device work
        # bucketing rides the streaming padded-tail path, so every layer must
        # take it (one geometry for all layers in the ported models); a
        # hybrid never buckets (the reference's prefix_cache_unsupported_reason)
        self._can_bucket = (ecfg.prefill_mode == "streaming" and self._ccfg is not None
                            and attn_lib.streaming_prefill_supported(self.cfg, self._ccfg))
        self.pool = None
        self.block_tables = None
        if ecfg.layout == "paged":
            self._init_paged()

    def _cap(self) -> int:
        nb = self.ecfg.policy.buffer_size
        return (self.ecfg.capacity + nb - 1) // nb * nb

    @property
    def attend_path(self) -> str:
        """Decode-attend path of this engine's attention layers: "fused" (the
        ``gear_decode`` kernels), or "xla" when no layer has a GEAR attention
        cache (RWKV6), as the reference reports."""
        return "xla" if self._ccfg is None else "fused"

    # -- paged layout -----------------------------------------------------
    def _init_paged(self) -> None:
        ecfg = self.ecfg
        self._n_chunks = self._cap() // ecfg.policy.buffer_size
        ccfg1 = dataclasses.replace(self._ccfg, batch=1)
        # one page is one chunk of every layer
        self._page_bytes = self.cfg.num_layers * cache_lib.page_nbytes(ccfg1)
        n_pages = ecfg.pool_pages or ecfg.batch * self._n_chunks + 1
        if n_pages < 2:
            raise ValueError(f"pool of {n_pages} pages cannot hold page 0 + one chunk")
        self._n_pages = n_pages
        self._new_pool()

    def _new_pool(self) -> None:
        self.pool = PagePool(self._n_pages, self.ecfg.batch, self._n_chunks, self._page_bytes)
        self._push_block_tables()

    def _push_block_tables(self) -> None:
        """Copy the pool's host block tables to the device: at admission and
        release only, never per step."""
        host = self.pool.block_tables.copy()
        self.block_tables = cache_lib.BlockTables(
            host=host, device=torch.from_numpy(host).to(self.device))

    def _guard_one(self, one: list) -> list:
        """Numeric guard on one request's batch-1 cache (a hybrid's SSM
        state included) before it is spliced into the shared tree: raises
        :class:`NumericFault` on NaN/Inf, with the shared tree untouched."""
        if self.ecfg.numeric_guard and not bool(cache_lib.tree_finite(one)):
            raise cache_lib.NumericFault(
                "prefill produced NaN/Inf in a compressed chunk; shared cache state untouched")
        return one

    # ------------------------------------------------------------------
    def _cold_prefill(self, batch1: dict):
        """Batch-1 prefill of the raw prompt.  A streaming engine pads a
        prompt whose length is not an ``n_b`` multiple to the next bucket
        and runs the padded-tail pipeline (cache length and logits follow
        the raw length); aligned prompts and monolithic engines prefill at
        the exact length."""
        ecfg = self.ecfg
        tokens = torch.as_tensor(np.asarray(batch1["tokens"]), dtype=torch.int32)
        n = tokens.shape[1]
        nb = ecfg.policy.buffer_size
        if not self._can_bucket or n % nb == 0:
            return self.model.prefill(self.params, {"tokens": tokens}, ecfg.policy,
                                      self._cap(), prefill_mode=ecfg.prefill_mode)
        padded = torch.nn.functional.pad(tokens, (0, -n % nb))
        return self.model.prefill(self.params, {"tokens": padded}, ecfg.policy, self._cap(),
                                  prefill_mode="streaming", padded_tail=True, true_len=n)

    def decode(self, token_batch: dict, caches: list, pos):
        """One decode step over all slots (``pos``: scalar or per-slot [B])."""
        return self.model.decode_step(self.params, token_batch, caches, pos,
                                      self.ecfg.policy, self._cap(),
                                      block_tables=self.block_tables)

    def prefill_slot(self, batch1: dict, caches: list, slot: int,
                     reserve_tokens: int | None = None):
        """Prefill ONE request (batch-1, raw prompt) and splice it into
        ``slot`` of ``caches`` (in place).  Returns (logits [1, 1, V], caches).
        The batch-1 prefill is what a solo run computes, so the request
        decodes as it would alone.

        Paged: the slot first reserves its lifetime's pages
        (``reserve_tokens``, default the full capacity) and raises
        :class:`~repro_torch.serving.pagedpool.PoolExhausted`, with no device
        work done, when the pool cannot cover it."""
        if self.ecfg.layout == "paged":
            return self._prefill_slot_paged(batch1, caches, slot, reserve_tokens)
        logits, one = self._cold_prefill(batch1)
        one = self._guard_one(one)
        for full, one_layer in zip(caches, one):
            cache_lib.splice_slot(full, one_layer, slot)
        return logits, caches

    def _prefill_slot_paged(self, batch1, caches, slot, reserve_tokens):
        nb = self.ecfg.policy.buffer_size
        cap = self._cap()
        plen = int(np.asarray(batch1["tokens"]).shape[1])
        n_closed = plen // nb
        reserve = cap if reserve_tokens is None else min(int(reserve_tokens), cap)
        n_total = max(pages_needed(max(reserve, plen), nb), n_closed)
        if self.pool.slot_pages(slot).size:       # splicing over a live slot drops it
            self.pool.release_slot(slot)
        fresh = self.pool.admit(slot, n_total)    # host-side first: no device work on failure
        try:
            logits, one = self._cold_prefill(batch1)
            one = self._guard_one(one)
        except BaseException:
            self.pool.release_slot(slot)
            self._push_block_tables()
            raise
        pages = torch.from_numpy(fresh.astype(np.int64)).to(self.device)
        zero_pages, sc_pages = pages[n_closed:], pages[:n_closed]
        ccfg1 = dataclasses.replace(self._ccfg, batch=1)
        for lyr, one_lyr in zip(caches, one):
            cache_lib.zero_pool_pages(ccfg1, lyr, zero_pages)
            cache_lib.scatter_pool_chunks(
                ccfg1, lyr, sc_pages, cache_lib.extract_prefix_chunks(ccfg1, one_lyr, n_closed))
            for name in ("buf_k", "buf_v", "length"):
                getattr(lyr, name)[slot].copy_(getattr(one_lyr, name)[0])
        self._push_block_tables()
        return logits, caches

    def reset_slot(self, caches: list, slot: int) -> list:
        """Return ``slot`` to the empty state in place; paged, release its
        pages (no device work for them: fresh pages are zeroed at their next
        admission) and clear its buffer and length."""
        if self.ecfg.layout == "paged":
            self.pool.release_slot(slot)
            self._push_block_tables()
            for lyr in caches:
                for name in ("buf_k", "buf_v", "length"):
                    getattr(lyr, name)[slot].zero_()
            return caches
        for layer in caches:
            cache_lib.reset_slot(layer, slot)
        return caches

    def init_caches(self) -> list:
        """A fresh cache tree (paged: with a fresh pool allocator, since the
        new pool's pages are all free)."""
        ecfg = self.ecfg
        if ecfg.layout == "paged":
            self._new_pool()
            return self.model.init_caches(ecfg.policy, ecfg.batch, self._cap(), self.device,
                                          layout="paged", pool_pages=self._n_pages)
        return self.model.init_caches(ecfg.policy, ecfg.batch, self._cap(), self.device)

    def new_view(self):
        """The layout's slot view over a fresh cache tree."""
        caches = self.init_caches()
        if self.ecfg.layout == "paged":
            return PagedCacheView(self, caches)
        return DenseCacheView(self, caches)
