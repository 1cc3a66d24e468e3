"""Serving engine: prefill + GEAR-cached decode on one device.

Port of ``repro.serving.engine.Engine`` with ``fused="auto"`` (the CUDA
kernels on a card, their plain versions for CPU tensors).
``prefill_mode`` is "monolithic" or "streaming"; ``layout`` is "dense" or
"paged".  Other values raise ``NotImplementedError`` naming the ROADMAP
queue item that brings them.  Two batching modes sit on top
(:mod:`repro_torch.serving.scheduler`): wave mode, where
:meth:`Engine.generate` prefills the whole batch at once and decodes it in
lockstep (dense layout only), and continuous mode, where the scheduler
drives :meth:`Engine.decode` step by step and splices each request's
batch-1 prefill into a slot (:meth:`Engine.prefill_slot`).

* Streaming prefill length-buckets a raw prompt to the next ``n_b``
  multiple: the padded tail lands in the FP16 buffer, never in a
  compressed chunk, and lengths and logits follow the raw length.
* The paged layout keeps closed chunks in a pool of pages
  (:mod:`repro_torch.serving.pagedpool`): a request reserves the pages of
  its own lifetime at admission, before any device work, and the block
  table goes to the device once per admission or release.
* The prefix cache (``prefix_cache=True``, streaming prefill only): a
  radix trie over compressed chunks (:mod:`repro_torch.prefixcache`).
  ``prefill_slot`` splices the longest cached chunk-aligned prefix of the
  raw prompt into a batch-1 tree and streams only the suffix over it, bit
  for bit what the cold prefill computes; the prompt's newly closed chunks
  then enter the trie.  On the paged layout the trie's payloads are pool
  page ids: a hit shares the pages by refcount, the suffix prefill gathers
  them into its scaffold, and no page is ever copied.
* A hybrid model (hymba: SSM heads beside attention) serves either prefill
  mode on the dense layout only, unbucketed, as in the reference: its
  per-layer cache is the pair (GEAR cache, SSM state), which the slot
  protocol and the numeric guard cover.
* An RWKV6 model has no KV cache: its per-layer cache is the recurrent
  state, the policy touches no layer, prefill is unbucketed in either mode,
  the layout is dense only, and ``attend_path`` reports "xla", as the
  reference's does when no layer has a GEAR attention cache.
* Telemetry (``obs``, :mod:`repro_torch.obs`): the engine owns the
  :class:`~repro_torch.obs.Observability` hub the scheduler drives, and
  annotates each prefill; with ``ObsConfig(profiler=True)`` prefill and
  decode run inside ``torch.profiler.record_function`` ranges.
* Fault injection (:mod:`repro_torch.serving.faults`): ``attach_faults``
  wires an injector into the numeric guard and the page pool.

The cache tree is a list of per-layer caches that the engine updates in
place: ``decode``, ``prefill_slot`` and ``reset_slot`` return the same tree
they were given (the reference donates and rebuilds it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import cache as cache_lib
from repro_torch.core.policy import CompressionPolicy
from repro_torch.models import attention as attn_lib
from repro_torch.models.common import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.transformer import cache_cfg_for, check_serving
from repro_torch.obs import Observability, ObsConfig
from repro_torch.obs.tracing import profiler_span
from repro_torch.prefixcache import PrefixCache, extract_tree_chunks, splice_tree_chunks
from repro_torch.serving.pagedpool import PagePool, PagePoolStore, pages_needed
from repro_torch.serving.sampling import sample
from repro_torch.serving.views import DenseCacheView, PagedCacheView

__all__ = ["EngineConfig", "Engine", "prefix_cache_unsupported_reason"]

_CHOICES = {
    "fused": ("auto", "interpret", "off"),
    "prefill_mode": ("monolithic", "streaming"),
    "layout": ("dense", "paged"),
}
_NOT_PORTED = {
    ("fused", "off"): "the portable attend path (ROADMAP queue item 7)",
    ("fused", "interpret"): "the Pallas interpret lane; CUDA has no interpret mode "
                            "(CPU tensors take the plain versions; ROADMAP queue item 7)",
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
    # the radix trie over compressed chunks (streaming prefill only), its
    # eviction byte budget, TTL in seconds from insert (0: never; hits do
    # not refresh it) and budget-pressure victim policy ("lru" / "lfu");
    # Engine.set_params invalidates every cached chunk on a weight swap
    prefix_cache: bool = False
    prefix_cache_bytes: int = 256 << 20
    prefix_cache_ttl: float = 0.0
    prefix_cache_eviction: str = "lru"
    numeric_guard: bool = True
    layout: str = "dense"
    # paged pool sizing, at most one of the two: ``pool_pages`` counts the
    # zero page; ``pool_bytes`` is a device byte budget (pages = pool_bytes
    # // page_bytes + 1); both 0 give batch * n_chunks allocatable pages
    # (dense-equivalent)
    pool_pages: int = 0
    pool_bytes: int = 0
    # telemetry (repro_torch.obs.ObsConfig; True coerces to the defaults, a
    # dict to ObsConfig(**dict)); None builds no telemetry state
    obs: ObsConfig | None = None

    def __post_init__(self):
        if self.obs is not None and not isinstance(self.obs, ObsConfig):
            if isinstance(self.obs, bool):
                object.__setattr__(self, "obs", ObsConfig() if self.obs else None)
            elif isinstance(self.obs, dict):
                object.__setattr__(self, "obs", ObsConfig(**self.obs))
            else:
                raise ValueError(f"obs must be an ObsConfig, bool, or dict, got {self.obs!r}")
        for knob, options in _CHOICES.items():
            value = str(getattr(self, knob))
            if value not in options:
                raise ValueError(f"{knob} must be {'/'.join(options)}, got {value!r}")
            if (knob, value) in _NOT_PORTED:
                raise NotImplementedError(f"{knob}={value!r}: {_NOT_PORTED[knob, value]}")
            object.__setattr__(self, knob, value)
        if self.prefix_cache and self.prefill_mode != "streaming":
            raise ValueError(
                "prefix_cache requires prefill_mode='streaming': the hit "
                "path attends the cached prefix in compressed form, so only "
                "streaming cold prefills are bit-identical to warm ones")
        if self.prefix_cache_eviction not in ("lru", "lfu"):
            raise ValueError("prefix_cache_eviction must be 'lru' or 'lfu', got "
                             f"{self.prefix_cache_eviction!r}")
        if self.prefix_cache_ttl < 0:
            raise ValueError(f"prefix_cache_ttl must be >= 0, got {self.prefix_cache_ttl}")
        if (self.prefix_cache_ttl or self.prefix_cache_eviction != "lru") and not self.prefix_cache:
            raise ValueError("prefix_cache_ttl / prefix_cache_eviction require prefix_cache=True")
        if self.pool_pages and self.pool_bytes:
            raise ValueError("set pool_pages OR pool_bytes, not both")
        if self.layout == "dense" and (self.pool_pages or self.pool_bytes):
            raise ValueError("pool_pages/pool_bytes only apply to layout='paged'")


def prefix_cache_unsupported_reason(cfg, policy: CompressionPolicy,
                                    capacity: int) -> str | None:
    """Why this model and policy cannot take the prefix cache (None: it can),
    in the reference's words.  The hit path replays a cached chunk-aligned
    prefix as compressed history under the streaming suffix pipeline, so
    every layer must keep all its prefill state in spliceable GEAR chunks
    and take the streaming prefill.  An engine whose model and policy can
    take it also length-buckets its streaming prefills."""
    if policy.is_fp16:
        return "fp16 policy has no compressed chunks to cache"
    if cfg.modality != "text":
        return f"modality {cfg.modality!r} (prompt is not a flat token-id sequence)"
    if cfg.ssm and cfg.hybrid_parallel:
        return "hybrid SSM state is not chunk-decomposable"
    for kind in cfg.layer_pattern:
        if kind == "rwkv":
            return "rwkv layers carry recurrent state, not spliceable chunks"
        if not attn_lib.streaming_prefill_supported(cfg, cache_cfg_for(cfg, policy, 1, capacity)):
            return f"layer kind {kind!r} does not support the streaming prefill pipeline"
    return None


class Engine:
    def __init__(self, model: Model, params, ecfg: EngineConfig, device=None, clock=None):
        self.device = resolve_device(device)
        if params.device != self.device:
            raise ValueError(f"weights live on {params.device}, engine device is {self.device}")
        self.model = model
        self.cfg = model.cfg
        self.ecfg = ecfg
        self.params = params
        # injectable monotonic clock of the prefix cache's TTL and of the
        # telemetry (tests pass a fake one); None is real time
        self._clock = clock
        self.weight_version = 0
        # the fault injector (attach_faults) and the telemetry hub, which the
        # scheduler finds as ``engine.obs``; None when the knob is off
        self._faults = None
        self.obs = Observability(ecfg.obs, clock=clock) if ecfg.obs is not None else None
        reason = prefix_cache_unsupported_reason(self.cfg, ecfg.policy, self._cap())
        if ecfg.prefix_cache and reason is not None:
            raise ValueError(f"prefix_cache unsupported here: {reason}")
        # the GEAR attention layers' cache config (and its batch-1 twin, the
        # geometry of one request's prefill); None when there are none
        self._ccfg = (None if self.cfg.rwkv else
                      cache_cfg_for(self.cfg, ecfg.policy, ecfg.batch, self._cap()))
        self._ccfg1 = None if self._ccfg is None else dataclasses.replace(self._ccfg, batch=1)
        if self._ccfg is not None and not cache_lib.streaming_supported(self._ccfg):
            raise NotImplementedError(                       # the gear_decode layout
                f"policy {ecfg.policy} needs the portable attend path "
                "(ROADMAP queue item 7)")
        check_serving(self.cfg, ecfg.layout)    # before any device work
        # bucketing rides the streaming padded-tail path, so it is gated on
        # the prefix cache's predicate, as in the reference: a hybrid or an
        # RWKV6 model prefills at the exact raw length
        self._can_bucket = ecfg.prefill_mode == "streaming" and reason is None
        self.pool = None
        self.block_tables = None
        self.prefix_cache = None
        if ecfg.layout == "paged":
            self._init_paged()
        if ecfg.prefix_cache:
            self._new_prefix_cache()

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
        # one page is one chunk of every layer
        self._page_bytes = self.cfg.num_layers * cache_lib.page_nbytes(self._ccfg1)
        if ecfg.pool_pages:
            n_pages = ecfg.pool_pages
        elif ecfg.pool_bytes:
            n_pages = ecfg.pool_bytes // self._page_bytes + 1
        else:
            n_pages = ecfg.batch * self._n_chunks + 1         # dense-equivalent
        if n_pages < 2:
            raise ValueError(f"pool of {n_pages} pages cannot hold page 0 + one chunk "
                             f"(page_bytes={self._page_bytes}; raise pool_bytes/pool_pages)")
        self._n_pages = n_pages
        self._new_pool()

    def _new_pool(self) -> None:
        """A fresh allocator and device block table (and, since the trie's
        payloads are page ids of the pool being dropped, a fresh trie)."""
        self.pool = PagePool(self._n_pages, self.ecfg.batch, self._n_chunks, self._page_bytes)
        self.pool.faults = self._faults
        self._push_block_tables()
        if self.prefix_cache is not None:
            self._new_prefix_cache()

    def _new_prefix_cache(self) -> None:
        ecfg = self.ecfg
        self.prefix_cache = PrefixCache(
            ecfg.policy.buffer_size, ecfg.prefix_cache_bytes,
            store=PagePoolStore(self.pool) if ecfg.layout == "paged" else None,
            ttl=ecfg.prefix_cache_ttl, eviction=ecfg.prefix_cache_eviction, clock=self._clock,
            validate=ecfg.numeric_guard)

    def _push_block_tables(self) -> None:
        """Copy the pool's host block tables to the device: at admission and
        release only, never per step."""
        host = self.pool.block_tables.copy()
        self.block_tables = cache_lib.BlockTables(
            host=host, device=torch.from_numpy(host).to(self.device))

    def attach_faults(self, injector) -> None:
        """Wire a :class:`~repro_torch.serving.faults.FaultInjector` into the
        engine's hooks (prefill corruption here, admission faults in the page
        pool); ``None`` detaches.  The scheduler calls it when constructed
        with ``faults=...``."""
        self._faults = injector
        if self.pool is not None:
            self.pool.faults = injector
        if injector is not None:
            injector.obs = self.obs

    def _guard_one(self, one: list) -> list:
        """Numeric quarantine of one request's batch-1 cache (a hybrid's SSM
        state included), after its prefill and before anything shares it
        (the splice, the trie insert, the page scatter); an injected NaN
        lands here first, so it takes a real one's path.  Raises
        :class:`NumericFault` on NaN/Inf, with the shared tree untouched."""
        if self._faults is not None:
            one = self._faults.corrupt_tree(one)
        if self.ecfg.numeric_guard and not bool(cache_lib.tree_finite(one)):
            if self.obs is not None:
                self.obs.quarantine()
                self.obs.tracer.event_bound("quarantine")
            raise cache_lib.NumericFault(
                "prefill produced NaN/Inf in a compressed chunk; quarantining this request "
                "(shared cache state untouched)")
        return one

    # -- telemetry hooks ----------------------------------------------------
    @property
    def _prof(self) -> bool:
        return self.obs is not None and self.obs.cfg.profiler

    def _span(self, name: str):
        """Trace span on the scheduler-bound rid; no-op without obs."""
        if self.obs is None:
            return contextlib.nullcontext()
        return self.obs.tracer.span_bound(name)

    def _obs_prefill(self, plen: int, n_hit: int = 0, pages_reserved: int | None = None) -> None:
        """Per-prefill telemetry on the guarded batch-1 tree, before the
        splice: annotates the scheduler's open prefill span (prefix hit,
        bucket, pages) and feeds the bucket histogram."""
        o = self.obs
        if o is None:
            return
        nb = self.ecfg.policy.buffer_size
        bucket = (plen + nb - 1) // nb * nb if self._can_bucket else plen
        o.observe_bucket(bucket)
        ann = {"prompt_tokens": plen, "bucket_tokens": bucket, "prefix_hit_chunks": n_hit}
        if pages_reserved is not None:
            ann["pages_reserved"] = pages_reserved
        o.tracer.annotate(**ann)

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
        with profiler_span("gear.prefill", self._prof):
            if not self._can_bucket or n % nb == 0:
                return self.model.prefill(self.params, {"tokens": tokens}, ecfg.policy,
                                          self._cap(), prefill_mode=ecfg.prefill_mode)
            padded = torch.nn.functional.pad(tokens, (0, -n % nb))
            return self.model.prefill(self.params, {"tokens": padded}, ecfg.policy, self._cap(),
                                      prefill_mode="streaming", padded_tail=True, true_len=n)

    def prefill(self, batch: dict):
        """Full-batch prefill of ``batch["tokens"]`` [B, S] (wave mode; the
        dense layout only).  Returns (logits [B, 1, V], a fresh cache tree)."""
        if self.ecfg.layout == "paged":
            raise NotImplementedError(
                "full-batch wave prefill is dense-only; paged engines serve "
                "through Engine.prefill_slot / Scheduler.run_continuous")
        _check_text_batch(batch)
        tokens = torch.as_tensor(batch["tokens"]).to(torch.int32)
        with profiler_span("gear.prefill", self._prof):
            return self.model.prefill(self.params, {"tokens": tokens}, self.ecfg.policy,
                                      self._cap(), prefill_mode=self.ecfg.prefill_mode)

    def decode(self, token_batch: dict, caches: list, pos):
        """One decode step over all slots (``pos``: scalar or per-slot [B])."""
        with profiler_span("gear.decode", self._prof):
            return self.model.decode_step(self.params, token_batch, caches, pos,
                                          self.ecfg.policy, self._cap(),
                                          block_tables=self.block_tables)

    def prefill_slot(self, batch1: dict, caches: list, slot: int, admit: bool = True,
                     reserve_tokens: int | None = None):
        """Prefill ONE request (batch-1, raw prompt) and splice it into
        ``slot`` of ``caches`` (in place).  Returns (logits [1, 1, V], caches).
        The batch-1 prefill is what a solo run computes, so the request
        decodes as it would alone.

        With the prefix cache, the trie is asked first: the longest cached
        chunk-aligned prefix of the raw prompt (leaving at least one suffix
        token, whose logits give the first token) is spliced into a batch-1
        tree and only the suffix runs streaming prefill, bucketed the same
        way, bit for bit the cold result.  ``admit`` (the scheduler's
        admission policy) inserts the prompt's newly closed chunks into the
        trie afterwards; only full chunks of real tokens close, so pad
        tokens never enter it.

        Paged: the slot first reserves its lifetime's pages
        (``reserve_tokens``, default the full capacity), the hit's pages
        shared by refcount, and raises
        :class:`~repro_torch.serving.pagedpool.PoolExhausted`, with no device
        work done, when the pool cannot cover the rest."""
        if self.ecfg.layout == "paged":
            return self._prefill_slot_paged(batch1, caches, slot, admit, reserve_tokens)

        def commit(one, n_hit, _):
            for full, one_layer in zip(caches, one):
                cache_lib.splice_slot(full, one_layer, slot)

        logits = self._prefill_via_trie(
            batch1, admit, commit,
            scaffold=lambda hit: splice_tree_chunks(self._ccfg1, self._fresh_batch1(), 0, hit),
            payloads=lambda one, lo, hi: extract_tree_chunks(self._ccfg1, one, lo, hi))
        return logits, caches

    def _prefill_via_trie(self, batch1: dict, admit: bool, commit, scaffold, payloads,
                          reserve=lambda hit: None, abort=lambda: None,
                          pages_reserved: int | None = None):
        """The prefix-cache protocol both layouts share.  Match the raw
        prompt's longest cached chunk-aligned prefix (leaving at least one
        suffix token); ``reserve(hit payloads)`` (paged: the slot's pages);
        the suffix prefill over ``scaffold(hit payloads)`` on a hit, else the
        cold prefill, then the numeric guard (``abort()`` undoes the
        reservation when either raises); ``commit(one, n_hit, reservation)``
        writes the batch-1 tree into the layout; with ``admit``, the
        prompt's newly closed chunks go into the trie as
        ``payloads(one, n_hit, n_closed)``.  The match is released on every
        exit.  ``pages_reserved`` only annotates the trace.  Returns the
        logits."""
        tokens = np.asarray(batch1["tokens"])[0]
        nb = self.ecfg.policy.buffer_size
        n = int(tokens.shape[0])
        match, n_hit, hit = None, 0, []
        if self.prefix_cache is not None:
            match = self.prefix_cache.match(tokens, max_chunks=max((n - 1) // nb, 0))
            n_hit, hit = match.n_chunks, match.payloads
        try:
            reservation = reserve(hit)
            try:
                if n_hit:
                    logits, one = self._prefill_suffix(tokens, n_hit, scaffold(hit))
                else:
                    logits, one = self._cold_prefill(batch1)
                one = self._guard_one(one)
            except BaseException:
                abort()
                raise
            self._obs_prefill(n, n_hit, pages_reserved)
            with self._span("splice"):
                commit(one, n_hit, reservation)
            if self.prefix_cache is not None and admit and n // nb > n_hit:
                self.prefix_cache.insert(tokens, payloads(one, n_hit, n // nb),
                                         start_chunk=n_hit)
        finally:
            if match is not None:
                self.prefix_cache.release(match)
        return logits

    def _fresh_batch1(self) -> list:
        """An empty batch-1 cache tree for a suffix prefill's scaffold (the
        pipeline writes into it in place, so each hit takes a new one)."""
        return self.model.init_caches(self.ecfg.policy, 1, self._cap(), self.device)

    def _prefill_suffix(self, tokens: np.ndarray, n_hit: int, one1: list):
        """Run the (bucketed, when unaligned) suffix after an ``n_hit``-chunk
        hit over the batch-1 scaffold ``one1``."""
        ecfg = self.ecfg
        nb = ecfg.policy.buffer_size
        suf = torch.as_tensor(np.asarray(tokens[n_hit * nb:], np.int32))[None]
        n_suf = suf.shape[1]
        start = n_hit * nb
        with profiler_span("gear.prefill_suffix", self._prof):
            if n_suf % nb == 0:
                return self.model.prefill_suffix(self.params, {"tokens": suf}, one1, start,
                                                 ecfg.policy, self._cap())
            padded = torch.nn.functional.pad(suf, (0, -n_suf % nb))
            return self.model.prefill_suffix(self.params, {"tokens": padded}, one1, start,
                                             ecfg.policy, self._cap(), padded_tail=True,
                                             true_len=n_suf)

    def _prefill_slot_paged(self, batch1, caches, slot, admit, reserve_tokens):
        nb = self.ecfg.policy.buffer_size
        cap = self._cap()
        plen = int(np.asarray(batch1["tokens"]).shape[1])
        n_closed = plen // nb                     # chunks the prompt closes
        reserve_n = cap if reserve_tokens is None else min(int(reserve_tokens), cap)
        n_total = max(pages_needed(max(reserve_n, plen), nb), n_closed)

        def reserve(hit):
            if self.pool.slot_pages(slot).size:   # splicing over a live slot drops it
                self.pool.release_slot(slot)
            # host-side reservation first: no device work on failure; the
            # hit's payloads ARE page ids, shared by refcount
            return self.pool.admit(slot, n_total, shared=[int(p) for p in hit])

        def abort():
            self.pool.release_slot(slot)
            self._push_block_tables()

        def commit(one, n_hit, fresh):
            # only the fresh pages are written: the reserved ones zeroed, the
            # first n_sc given the suffix's closed chunks; shared pages never
            n_sc = n_closed - n_hit
            pages = torch.from_numpy(fresh.astype(np.int64)).to(self.device)
            zero_pages, sc_pages = pages[n_sc:], pages[:n_sc]
            ccfg1 = self._ccfg1
            for lyr, one_lyr in zip(caches, one):
                cache_lib.zero_pool_pages(ccfg1, lyr, zero_pages)
                cache_lib.scatter_pool_chunks(
                    ccfg1, lyr, sc_pages,
                    cache_lib.extract_prefix_chunks(ccfg1, one_lyr, n_sc, n_hit))
                for name in ("buf_k", "buf_v", "length"):
                    getattr(lyr, name)[slot].copy_(getattr(one_lyr, name)[0])
            self._push_block_tables()

        logits = self._prefill_via_trie(
            batch1, admit, commit, reserve=reserve, abort=abort, pages_reserved=n_total,
            scaffold=lambda hit: self._gather_scaffold(caches, [int(p) for p in hit]),
            payloads=lambda one, lo, hi: [int(p) for p in self.pool.block_tables[slot, lo:hi]])
        return logits, caches

    def _gather_scaffold(self, caches: list, pages: list) -> list:
        """Gather the hit's pool pages of every layer into a fresh batch-1
        dense tree as its first chunks: the scaffold the suffix prefill runs
        over (the paged twin of splicing host payloads).  The pages are read,
        never copied into other pool pages."""
        per_layer = [cache_lib.gather_pool_chunks(self._ccfg1, lyr, pages) for lyr in caches]
        payloads = [tuple(chunks[c] for chunks in per_layer) for c in range(len(pages))]
        return splice_tree_chunks(self._ccfg1, self._fresh_batch1(), 0, payloads)

    def reclaim_pages(self, n_pages: int) -> int:
        """Evict prefix-trie entries until ``n_pages`` pool pages came free
        (or nothing evictable remains): the scheduler's valve when every slot
        is idle and the queue head still does not fit, so the only
        references keeping pages off the free list are the trie's.  Returns
        the pages reclaimed."""
        if self.pool is None or self.prefix_cache is None:
            return 0
        freed = self.prefix_cache.evict_bytes(n_pages * self.pool.page_bytes)
        return freed // self.pool.page_bytes

    def audit(self) -> dict:
        """Cross-structure invariant report, never raises: the pool's
        refcounts against its block tables plus the trie's live handles
        (and those waiting to be freed), and the trie's own audit."""
        issues: list[str] = []
        report: dict[str, Any] = {}
        if self.pool is not None:
            retained = None
            if self.prefix_cache is not None:
                retained = ([int(h) for h in self.prefix_cache.live_handles()]
                            + [int(h) for h in self.prefix_cache.trie.pending_free])
            report["pool"] = self.pool.audit(retained=retained)
            issues += [f"pool: {m}" for m in report["pool"]["issues"]]
        if self.prefix_cache is not None:
            report["trie"] = self.prefix_cache.audit()
            issues += [f"trie: {m}" for m in report["trie"]["issues"]]
        return {"ok": not issues, "issues": issues, **report}

    def set_params(self, params) -> None:
        """Swap the served weights.  Bumps :attr:`weight_version` and
        invalidates every prefix-cache entry (chunks compressed under the old
        weights must never be spliced into a new-weights prefill; the trie
        prunes them lazily, counted as ``version_evictions``)."""
        if params.device != self.device:
            raise ValueError(f"weights live on {params.device}, engine device is {self.device}")
        self.params = params
        self.weight_version += 1
        if self.prefix_cache is not None:
            self.prefix_cache.bump_version()

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

    # -- wave mode ----------------------------------------------------------
    def generate(self, batch: dict, max_new_tokens: int, generator: torch.Generator | None = None,
                 active=None):
        """Wave generation: one full-batch prefill, then ``max_new_tokens - 1``
        lockstep decode steps.  Returns (tokens [B, T] int32 numpy, stats).

        Tokens come from :func:`~repro_torch.serving.sampling.sample` with
        ``generator`` (default: seeded 0); at temperature 0 they are greedy.
        With an ``eos_id`` a row that sampled it keeps emitting it, and the
        loop stops once every row has.  ``active``: optional bool mask [B]
        of rows holding real requests; padded copy rows are left out of
        ``decode_tok_per_s``.  Dense layout only."""
        ecfg = self.ecfg
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        t0 = time.time()
        logits, caches = self.prefill(batch)
        tok = sample(logits[:, -1], ecfg.temperature, ecfg.top_k, generator)
        self._sync()
        t_prefill = time.time() - t0
        prompt_len = self._prompt_len(batch)
        B = tok.shape[0]
        out = [tok]
        done = torch.zeros(B, dtype=torch.bool, device=tok.device)
        t1 = time.time()
        for t in range(max_new_tokens - 1):
            pos = np.full(B, prompt_len + t, np.int32)
            logits, caches = self.decode({"tokens": tok[:, None]}, caches, pos)
            tok = sample(logits[:, -1], ecfg.temperature, ecfg.top_k, generator)
            if ecfg.eos_id >= 0:
                done = done | (tok == ecfg.eos_id)
                tok = torch.where(done, torch.full_like(tok, ecfg.eos_id), tok)
            out.append(tok)
            if ecfg.eos_id >= 0 and bool(done.all()):
                break
        toks = torch.stack(out, dim=1).cpu().numpy()
        t_decode = time.time() - t1
        stats = {
            "prefill_s": t_prefill,
            "decode_s": t_decode,
            "decode_tok_per_s": self._decode_tok_per_s(toks, t_decode, active),
            "cache_bytes": self.cache_nbytes(caches),
        }
        return toks, stats

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _decode_tok_per_s(self, toks: np.ndarray, t_decode: float, active) -> float:
        """Decode throughput over useful tokens only: padded copy rows
        (``active`` False) and the filler after a row's EOS are left out."""
        B, T = toks.shape[0], toks.shape[1]
        act = np.ones(B, bool) if active is None else np.asarray(active, bool)
        n_use = np.full(B, T)
        if self.ecfg.eos_id >= 0:
            hit = toks == self.ecfg.eos_id
            has = hit.any(axis=1)
            n_use[has] = hit.argmax(axis=1)[has] + 1      # keep the EOS itself
        useful_decode = int(np.maximum(n_use - 1, 0)[act].sum())   # 1st token: prefill
        return useful_decode / max(t_decode, 1e-9)

    @staticmethod
    def _prompt_len(batch: dict) -> int:
        return int(batch["tokens"].shape[1])

    @staticmethod
    def cache_nbytes(caches: list) -> int:
        """Bytes of every tensor of a cache tree (a hybrid's SSM states and
        an RWKV6 model's recurrent states included)."""
        return sum(t.numel() * t.element_size() for layer in caches
                   for part in cache_lib._parts(layer) for t in part.tensors().values())


def _check_text_batch(batch: dict) -> None:
    """Wave mode serves text token ids [B, S] only."""
    extra = sorted(set(batch) - {"tokens"})
    rank = batch["tokens"].ndim
    if extra or rank != 2:
        raise NotImplementedError(
            f"audio and VLM batches (extra keys {extra}, token rank {rank}): those model "
            "families arrive with ROADMAP queue 1, item 8")
