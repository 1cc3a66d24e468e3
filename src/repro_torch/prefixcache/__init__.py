"""Radix-trie prefix cache over compressed GEAR chunks (port of
``repro.prefixcache``).

Requests sharing a chunk-aligned prompt prefix reuse the prefix's
*compressed* chunks instead of recomputing its prefill attention and
compression.  Every ``n_b``-token chunk is compressed as an independent,
slot-invariant event, so a cached chunk is the chunk the request would have
computed itself: splicing it adds no error, and the suffix prefill over the
spliced prefix reproduces the cold run's cache and logits bit for bit.

* :mod:`~repro_torch.prefixcache.trie`: the chunk-granular radix trie
  (longest match, LRU / LFU eviction under a byte budget, refcount pins,
  TTL, weight-version invalidation, stats);
* :mod:`~repro_torch.prefixcache.store`: the payload store and the
  cache-tree extraction / splicing on :mod:`repro_torch.core.cache`'s
  chunk functions;
* :class:`PrefixCache`: the facade the serving engine drives
  (:meth:`repro_torch.serving.engine.Engine.prefill_slot`).
"""

from __future__ import annotations

import dataclasses

from repro_torch.prefixcache.store import (ChunkStore, chunk_keys, extract_tree_chunks,
                                           payload_nbytes, splice_tree_chunks)
from repro_torch.prefixcache.trie import RadixTrie, TrieNode, TrieStats

__all__ = ["PrefixCache", "PrefixMatch", "PrefixSnapshot", "RadixTrie",
           "TrieNode", "TrieStats", "ChunkStore", "chunk_keys",
           "payload_nbytes", "extract_tree_chunks", "splice_tree_chunks"]


@dataclasses.dataclass(frozen=True)
class PrefixSnapshot:
    """Typed point-in-time view of a :class:`PrefixCache` (trie stats +
    store health) — what ``Scheduler.last_stats`` diffs for its per-run
    prefix counters.  Indexing delegates to attributes for dict-style
    consumers."""

    prefix_hit_rate: float
    prefill_toks_saved: int
    lookups: int
    hits: int
    misses: int
    hit_chunks: int
    lookup_chunks: int
    inserts: int
    evictions: int
    expiries: int
    version_evictions: int
    validate_failures: int
    nodes: int
    bytes: int
    budget_bytes: int

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class PrefixMatch:
    """A pinned longest-prefix hit: release via :meth:`PrefixCache.release`."""

    nodes: list[TrieNode]
    payloads: list            # one engine-tree chunk payload per matched chunk

    @property
    def n_chunks(self) -> int:
        return len(self.nodes)


class PrefixCache:
    """Trie + store facade keyed on ``chunk``-token id chunks.

    ``store`` is pluggable: the default :class:`ChunkStore` owns host-side
    payload copies; the paged engine passes a
    :class:`~repro_torch.serving.pagedpool.PagePoolStore`, whose handles are pool
    page ids — then an insert is a refcount bump (the chunk's device bytes
    are already in the pool) and an eviction releases the page.  A custom
    store may provide ``nbytes_of(payload)``, used instead of
    :func:`payload_nbytes` so the trie's LRU budget prices entries in the
    store's own byte units (exact page bytes for the pool).

    Lifecycle knobs (threaded from
    :class:`~repro_torch.serving.engine.EngineConfig`):

    * ``ttl`` — seconds a cached chunk stays valid from *insert* (0
      disables expiry; hits do not refresh it);
    * ``eviction`` — ``"lru"`` (default) or ``"lfu"`` budget-pressure
      victim policy;
    * ``clock`` — injectable monotonic-seconds source (tests);
    * :meth:`bump_version` — invalidates every cached chunk at once (the
      engine calls it on a weight swap: chunks compressed under old
      weights must never be spliced into a new-weights prefill).

    Staleness is enforced lazily at the next walk that touches a stale
    node; the pruned payloads are freed here the moment they are drained
    from the trie, and show up in :attr:`stats` under ``expiries`` /
    ``version_evictions``.
    """

    def __init__(self, chunk: int, budget_bytes: int, store=None,
                 ttl: float = 0.0, eviction: str = "lru", clock=None,
                 validate: bool = False):
        self.chunk = int(chunk)
        self.trie = RadixTrie(budget_bytes, ttl=ttl, eviction=eviction,
                              clock=clock)
        self.store = ChunkStore(validate=validate) if store is None else store
        self._nbytes_of = getattr(self.store, "nbytes_of", payload_nbytes)
        self.toks_saved = 0

    def bump_version(self) -> None:
        """Invalidate all cached chunks (see :meth:`RadixTrie.bump_version`)."""
        self.trie.bump_version()

    def _drain_pruned(self) -> None:
        for handle in self.trie.drain_pruned():
            self.store.free(handle)

    # ------------------------------------------------------------------
    def match(self, tokens, max_chunks: int | None = None) -> PrefixMatch:
        """Longest cached chunk-aligned prefix of ``tokens``.

        Pins the matched path (the caller must :meth:`release` after
        splicing) and accounts the reuse in ``toks_saved``.  ``max_chunks``
        caps the match — the engine always leaves at least one suffix
        token so prefill still produces last-position logits.
        """
        keys = chunk_keys(tokens, self.chunk)
        if max_chunks is not None:
            keys = keys[:max_chunks]
        nodes = self.trie.lookup(keys, acquire=True)
        self._drain_pruned()
        self.toks_saved += len(nodes) * self.chunk
        return PrefixMatch(nodes=nodes,
                           payloads=[self.store.get(nd.handle) for nd in nodes])

    def release(self, match: PrefixMatch) -> None:
        self.trie.release(match.nodes)

    def insert(self, tokens, payloads, start_chunk: int = 0) -> int:
        """Cache ``payloads`` as chunks ``[start_chunk, ...)`` of ``tokens``.

        The first ``start_chunk`` chunks must already be cached (the warm
        request's matched — still pinned — prefix).  Duplicate chunks (a
        racing insert) and any LRU evictions are freed from the store.
        Returns the number of nodes created.
        """
        keys = chunk_keys(tokens, self.chunk)[:start_chunk + len(payloads)]
        entries = ([None] * start_chunk
                   + [(self.store.put(p), self._nbytes_of(p)) for p in payloads])
        created, unused, evicted = self.trie.insert(keys, entries)
        self._drain_pruned()
        for handle in unused:
            self.store.free(handle)
        for handle in evicted:
            self.store.free(handle)
        return len(created)

    def clear(self) -> None:
        """Drop all cached chunks (keeps budget and stats counters)."""
        for handle in self.trie.clear():
            self.store.free(handle)
        self._drain_pruned()

    def evict_bytes(self, n_bytes: int) -> int:
        """Evict least-recently-used unpinned entries until at least
        ``n_bytes`` have been reclaimed (or nothing evictable remains).

        The paged scheduler's deadlock valve: when every slot is idle, the
        queue is non-empty, and admission still fails, the pool's free
        pages are all pinned by the trie — reclaiming here turns trie
        references back into allocatable pages.  Returns bytes reclaimed.
        Implemented by temporarily lowering the trie's budget and running
        its normal LRU eviction, so pinned-path protection and stats
        behave exactly as budget-pressure evictions do.
        """
        before = self.trie.total_bytes
        budget = self.trie.budget_bytes
        self.trie.budget_bytes = max(before - n_bytes, 0)
        try:
            for handle in self.trie.evict_to_budget():
                self.store.free(handle)
        finally:
            self.trie.budget_bytes = budget
        return before - self.trie.total_bytes

    def live_handles(self) -> list:
        """Payload handles the trie owns (see :meth:`RadixTrie.live_handles`)."""
        return self.trie.live_handles()

    def audit(self) -> dict:
        """Trie structural audit (see :meth:`RadixTrie.audit`)."""
        return self.trie.audit()

    # ------------------------------------------------------------------
    def snapshot(self) -> PrefixSnapshot:
        """Typed snapshot (see :class:`PrefixSnapshot`)."""
        st = self.trie.stats
        return PrefixSnapshot(
            prefix_hit_rate=st.prefix_hit_rate,
            prefill_toks_saved=self.toks_saved,
            lookups=st.lookups, hits=st.hits, misses=st.misses,
            hit_chunks=st.hit_chunks, lookup_chunks=st.lookup_chunks,
            inserts=st.inserts, evictions=st.evictions,
            expiries=st.expiries, version_evictions=st.version_evictions,
            validate_failures=getattr(self.store, "validate_failures", 0),
            nodes=self.trie.n_nodes, bytes=self.trie.total_bytes,
            budget_bytes=self.trie.budget_bytes)

    @property
    def stats(self) -> dict:
        st = self.trie.stats
        return {
            "prefix_hit_rate": st.prefix_hit_rate,
            "prefill_toks_saved": self.toks_saved,
            "lookups": st.lookups,
            "hits": st.hits,
            "misses": st.misses,
            "hit_chunks": st.hit_chunks,
            "lookup_chunks": st.lookup_chunks,
            "inserts": st.inserts,
            "evictions": st.evictions,
            "expiries": st.expiries,
            "version_evictions": st.version_evictions,
            "nodes": self.trie.n_nodes,
            "bytes": self.trie.total_bytes,
            "budget_bytes": self.trie.budget_bytes,
        }
