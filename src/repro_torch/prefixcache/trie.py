"""Chunk-granular radix trie for cross-request prefix matching (port of
``repro.prefixcache.trie``, pure Python: the same code, kept here so the
port imports nothing of the reference).

The trie is keyed on ``n_b``-aligned token-id chunks: every edge is one
whole chunk (a tuple of ``n_b`` token ids), so a root-to-node path spells a
chunk-aligned prompt prefix and each node owns exactly one compressed-chunk
payload (held in :class:`repro_torch.prefixcache.store.ChunkStore`, or in
the paged pool; the trie only sees an opaque ``handle`` plus its byte
size).  GEAR compresses each ``n_b``-token chunk as an independent,
slot-invariant event, so a chunk-aligned prefix has bit-identical
compressed form no matter which request computed it.

Eviction is LRU (or LFU, ``eviction="lfu"``) over *evictable leaves* under
a byte budget: a node can be evicted only when it has no children and no
live references.  Callers pin a matched path with ``lookup(acquire=True)``
while they splice its payloads and must :meth:`RadixTrie.release` it
afterwards; referenced nodes are never evicted, so the budget is a soft
bound while pins are outstanding and a hard bound otherwise.

Two staleness mechanisms guard validity on top of the budget: **TTL**
(``ttl`` seconds from node creation; hits do not refresh it) and
**versioning** (:meth:`RadixTrie.bump_version`, driven by the engine on a
weight swap, makes every existing node stale at once).  Both are enforced
lazily: a walk that steps onto a stale node prunes that node's subtree
instead of matching it, and the pruned handles accumulate in
``pending_free`` for the facade to free in its store.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Hashable, Iterable, Sequence

__all__ = ["RadixTrie", "TrieNode", "TrieStats"]

_BLOCKED = object()   # stale child whose pruning a pin deferred


@dataclasses.dataclass
class TrieStats:
    """Monotonic counters; rates are derived properties."""

    lookups: int = 0        # lookup() calls
    hits: int = 0           # lookups matching >= 1 chunk
    misses: int = 0         # lookups matching 0 chunks
    hit_chunks: int = 0     # chunks served across all lookups
    lookup_chunks: int = 0  # chunks eligible across all lookups
    inserts: int = 0        # nodes created
    evictions: int = 0      # nodes evicted under byte-budget pressure
    expiries: int = 0       # nodes pruned past their TTL
    version_evictions: int = 0  # nodes pruned by a version bump

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of eligible prompt chunks served from the trie."""
        return self.hit_chunks / max(self.lookup_chunks, 1)


class TrieNode:
    """One cached chunk: edge label ``key`` + opaque payload ``handle``."""

    __slots__ = ("key", "parent", "children", "handle", "nbytes", "refs",
                 "last_use", "uses", "created_at", "version")

    def __init__(self, key: Hashable, parent: "TrieNode | None",
                 handle: Any = None, nbytes: int = 0,
                 created_at: float = 0.0, version: int = 0):
        self.key = key
        self.parent = parent
        self.children: dict[Hashable, TrieNode] = {}
        self.handle = handle
        self.nbytes = int(nbytes)
        self.refs = 0
        self.last_use = 0
        # LFU frequency: creation counts as the first use, so a fresh
        # insert is never its own eviction victim in the same call — it
        # ties with single-hit chunks and loses only to them on recency
        self.uses = 1
        self.created_at = created_at
        self.version = version


class RadixTrie:
    """See the module docstring.  ``ttl=0`` disables expiry; ``clock`` is
    an injectable monotonic-seconds source (tests pass a fake)."""

    def __init__(self, budget_bytes: int, ttl: float = 0.0,
                 eviction: str = "lru",
                 clock: Callable[[], float] | None = None):
        if eviction not in ("lru", "lfu"):
            raise ValueError(f"eviction must be 'lru' or 'lfu', got {eviction!r}")
        self.budget_bytes = int(budget_bytes)
        self.ttl = float(ttl)
        self.eviction = eviction
        self.clock = time.monotonic if clock is None else clock
        self.root = TrieNode(key=None, parent=None)
        self.total_bytes = 0
        self.n_nodes = 0
        self.version = 0
        self.stats = TrieStats()
        self.pending_free: list[Any] = []
        self._clock = 0

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    # ------------------------------------------------------------------
    # staleness (TTL + weight version)

    def bump_version(self) -> None:
        """Invalidate every cached chunk (engine weight swap): nodes keep
        serving nothing — the next walk that reaches them prunes them."""
        self.version += 1

    def _stale(self, nd: TrieNode, now: float) -> bool:
        return (nd.version != self.version
                or (self.ttl > 0.0 and now - nd.created_at > self.ttl))

    def _prune_subtree(self, nd: TrieNode) -> bool:
        """Drop ``nd`` and its descendants if none are pinned.

        Returns True when pruned (handles land in ``pending_free`` and the
        expiry/version counters advance); False when a pin anywhere in the
        subtree forces deferral — the walk then simply treats the stale
        node as a miss and the subtree is pruned on a later walk.
        """
        sub, stack = [], [nd]
        while stack:
            cur = stack.pop()
            if cur.refs:
                return False
            sub.append(cur)
            stack.extend(cur.children.values())
        del nd.parent.children[nd.key]
        for cur in sub:
            self.total_bytes -= cur.nbytes
            self.n_nodes -= 1
            if cur.version != self.version:
                self.stats.version_evictions += 1
            else:
                self.stats.expiries += 1
            self.pending_free.append(cur.handle)
        return True

    def _step(self, node: TrieNode, key: Hashable, now: float):
        """One walk step honoring staleness.

        Returns the live child, None when the edge is missing (or was
        stale and just pruned), or :data:`_BLOCKED` when the child is
        stale but a pin in its subtree defers pruning — the walk must
        stop there without matching, creating, or overwriting anything.
        """
        child = node.children.get(key)
        if child is None:
            return None
        if self._stale(child, now):
            return None if self._prune_subtree(child) else _BLOCKED
        return child

    def drain_pruned(self) -> list[Any]:
        """Hand back (and forget) payload handles freed by lazy pruning."""
        out, self.pending_free = self.pending_free, []
        return out

    # ------------------------------------------------------------------
    def lookup(self, chunk_keys: Sequence[Hashable],
               acquire: bool = False) -> list[TrieNode]:
        """Longest chunk-aligned prefix match.

        Returns the node path for the longest prefix of ``chunk_keys``
        present in the trie (empty list on a total miss) and bumps every
        matched node's recency and use count.  Stale nodes (TTL-expired or
        from an older weight version) never match: the walk prunes their
        subtree in place (handles go to ``pending_free``) and stops.
        ``acquire=True`` additionally pins each node on the path
        (refcount +1) so eviction cannot free a payload the caller is
        about to splice; the caller must :meth:`release` the same list
        when done.
        """
        self.stats.lookups += 1
        self.stats.lookup_chunks += len(chunk_keys)
        t = self._tick()
        now = self.clock()
        node, path = self.root, []
        for key in chunk_keys:
            child = self._step(node, key, now)
            if child is None or child is _BLOCKED:
                break
            child.last_use = t
            child.uses += 1
            path.append(child)
            node = child
        if acquire:
            for nd in path:
                nd.refs += 1
        self.stats.hit_chunks += len(path)
        if path:
            self.stats.hits += 1
        else:
            self.stats.misses += 1
        return path

    def release(self, nodes: Iterable[TrieNode]) -> None:
        """Unpin nodes previously acquired by ``lookup(acquire=True)``."""
        for nd in nodes:
            if nd.refs <= 0:
                raise ValueError("release without matching acquire")
            nd.refs -= 1

    # ------------------------------------------------------------------
    def insert(self, chunk_keys: Sequence[Hashable],
               entries: Sequence[tuple[Any, int] | None]):
        """Insert/extend one chunk path.

        ``entries[i]`` is ``(handle, nbytes)`` for chunk ``i``, or None when
        the caller expects the node to already exist (e.g. the matched
        prefix of a warm request).  Walks the path, creating nodes where
        missing; stops early if a node is missing but its entry is None.
        Returns ``(created, unused_handles, evicted_handles)``: handles the
        trie did not take ownership of (a racing insert already cached that
        chunk) plus handles freed by the post-insert eviction pass — the
        caller must free both sets in its payload store.
        """
        if len(entries) != len(chunk_keys):
            raise ValueError(f"{len(entries)} entries for {len(chunk_keys)} keys")
        t = self._tick()
        now = self.clock()
        node = self.root
        created: list[TrieNode] = []
        unused: list[Any] = []
        for i, (key, entry) in enumerate(zip(chunk_keys, entries)):
            child = self._step(node, key, now)
            if child is _BLOCKED:
                # a pinned-but-stale subtree occupies this edge: nothing
                # below it may be matched or replaced until it is pruned
                unused.extend(e[0] for e in entries[i:] if e is not None)
                break
            if child is None:
                if entry is None:
                    # cannot extend past a missing unbacked node; hand every
                    # remaining provided handle back so the caller's store
                    # does not leak the orphaned payloads
                    unused.extend(e[0] for e in entries[i:] if e is not None)
                    break
                handle, nbytes = entry
                child = TrieNode(key, node, handle, nbytes,
                                 created_at=now, version=self.version)
                node.children[key] = child
                self.total_bytes += child.nbytes
                self.n_nodes += 1
                self.stats.inserts += 1
                created.append(child)
            elif entry is not None:
                unused.append(entry[0])
            child.last_use = t
            node = child
        return created, unused, self.evict_to_budget()

    # ------------------------------------------------------------------
    def _evictable_leaves(self) -> list[TrieNode]:
        out, stack = [], list(self.root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif nd.refs == 0:
                out.append(nd)
        return out

    def _victim_rank(self, nd: TrieNode) -> tuple:
        # LRU: oldest recency first.  LFU: fewest uses first, recency as
        # the tiebreak so equal-frequency victims still age out in order.
        if self.eviction == "lfu":
            return (nd.uses, nd.last_use)
        return (nd.last_use,)

    def evict_to_budget(self) -> list[Any]:
        """Evict LRU/LFU evictable leaves until within budget.

        Returns the payload handles freed (for the caller's store).  May
        leave the trie above budget when every remaining leaf is pinned —
        referenced nodes are never evicted.  One trie walk seeds a heap of
        evictable leaves; a victim's parent joins the heap the moment it
        becomes a childless unpinned leaf, so an eviction burst is
        O(nodes log nodes), not a full re-walk per victim.
        """
        evicted: list[Any] = []
        if self.total_bytes <= self.budget_bytes:
            return evicted
        heap = [(self._victim_rank(nd), id(nd), nd)
                for nd in self._evictable_leaves()]
        heapq.heapify(heap)
        while self.total_bytes > self.budget_bytes and heap:
            _, _, victim = heapq.heappop(heap)
            del victim.parent.children[victim.key]
            self.total_bytes -= victim.nbytes
            self.n_nodes -= 1
            self.stats.evictions += 1
            evicted.append(victim.handle)
            parent = victim.parent
            if (parent is not self.root and not parent.children
                    and parent.refs == 0):
                heapq.heappush(heap, (self._victim_rank(parent), id(parent),
                                      parent))
        return evicted

    def live_handles(self) -> list[Any]:
        """Every payload handle the trie currently owns (one per node).

        The engine feeds this to :meth:`PagePool.audit` as the retained
        multiset, closing the refcount accounting loop: a page is live iff
        it is in a block table or behind one of these handles.  Handles in
        ``pending_free`` are NOT included — they are already disowned and
        waiting for the facade to free them in the store.
        """
        out, stack = [], list(self.root.children.values())
        while stack:
            nd = stack.pop()
            out.append(nd.handle)
            stack.extend(nd.children.values())
        return out

    def audit(self) -> dict:
        """Structural invariant audit; returns a report, never raises.

        Recounts nodes and bytes against the incremental counters, checks
        parent/child back-pointers, and flags negative refcounts.  Cheap
        (one walk), so chaos tests run it after every schedule.
        """
        issues: list[str] = []
        n, nbytes = 0, 0
        stack = [self.root]
        while stack:
            nd = stack.pop()
            for key, child in nd.children.items():
                if child.parent is not nd:
                    issues.append(f"node {key!r}: broken parent pointer")
                if child.key != key:
                    issues.append(f"node {key!r}: edge/key mismatch {child.key!r}")
                if child.refs < 0:
                    issues.append(f"node {key!r}: negative refcount {child.refs}")
                n += 1
                nbytes += child.nbytes
                stack.append(child)
        if n != self.n_nodes:
            issues.append(f"n_nodes counter {self.n_nodes} != walked {n}")
        if nbytes != self.total_bytes:
            issues.append(f"total_bytes counter {self.total_bytes} != walked {nbytes}")
        return {"ok": not issues, "issues": issues, "n_nodes": n,
                "total_bytes": nbytes, "pending_free": len(self.pending_free)}

    def clear(self) -> list[Any]:
        """Drop every node (ignores pins — callers must hold none).
        Returns all payload handles for the caller's store."""
        handles = []
        stack = list(self.root.children.values())
        while stack:
            nd = stack.pop()
            handles.append(nd.handle)
            stack.extend(nd.children.values())
        self.root.children.clear()
        self.total_bytes = 0
        self.n_nodes = 0
        return handles
