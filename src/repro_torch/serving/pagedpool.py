"""Global pool of compressed-chunk pages + refcounted block tables (port of
``repro.serving.pagedpool``).

One page holds one ``n_b``-token chunk's compressed fields for one layer,
and every layer's pool shares the page ids, so "page p" is one chunk of the
whole model and its byte cost is the sum over layers.  The device arrays
live in the engine's :class:`~repro_torch.core.cache.PagedGEARLayerCache`
leaves; this module owns the host-side allocator: the free list, the
per-page reference counts and the host mirror of the per-slot block tables,
which the engine copies to the device at admission and release.

Closed chunks are immutable (decode writes only the page of the chunk it is
closing, always fresh to that slot), so two slots whose tables name the
same prefix page never conflict: sharing is pure reference counting and no
page is ever copied.  The prefix trie holds a reference on every page it
indexes (:class:`PagePoolStore`), so a cached prefix outlives its slot.

The zero-page invariant: page 0 is never allocated and stays zero; block
table rows reset to 0, and fresh pages are zeroed at admission, so a kernel
reading any table entry past a slot's extent streams the dense layout's
zeros.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["PagePool", "PagePoolStore", "PoolExhausted", "PoolSnapshot",
           "pages_needed"]


@dataclasses.dataclass(frozen=True)
class PoolSnapshot:
    """Typed point-in-time view of a :class:`PagePool` — the ``"pool"``
    entry in ``Scheduler.last_stats``.  Indexing (``snap["admits"]``)
    delegates to attributes so legacy dict-style consumers keep working.
    """

    admits: int
    rejects: int
    shared_pages: int
    fresh_pages: int
    freed_pages: int
    page_bytes: int
    free_pages: int
    used_pages: int
    total_bytes: int
    used_bytes: int

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def pages_needed(n_tokens: int, chunk: int) -> int:
    """Pages a request holding up to ``n_tokens`` needs: one per started
    chunk.  The trailing partial chunk lives in the per-slot FP16 streaming
    buffer, not a page — but a request is budgeted for its whole lifetime
    (prompt + generation), so admission rounds up."""
    return (n_tokens + chunk - 1) // chunk


class PoolExhausted(RuntimeError):
    """Admission failed: fewer free pages than the request's reservation.

    Deliberately a distinct type so the scheduler can treat it as "queue
    and retry after something releases", never as a crash.
    """


class PagePool:
    """Host-side page allocator for one engine's paged cache tree.

    ``n_pages`` counts page 0 (the reserved zero page), so ``n_pages - 1``
    pages are allocatable.  ``page_bytes`` is the all-layers byte cost of
    one page (engine computes it from the cache geometry) — the pool's
    byte accounting is exact by construction: ``used_bytes == live pages ×
    page_bytes``.

    Reference counts: a page's count is the number of slot block tables
    currently containing it plus the number of prefix-trie handles
    retaining it (:class:`PagePoolStore`).  ``admit`` bumps shared pages
    and allocates the rest fresh at count 1; ``release_slot`` decrements a
    slot's whole row; a count hitting zero returns the page to the free
    list.  Freed pages are NOT zeroed — the zero-page invariant is
    restored at the next admission (fresh pages are zeroed before the
    block table exposes them), which keeps release device-work-free.
    """

    def __init__(self, n_pages: int, batch: int, n_chunks: int,
                 page_bytes: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 reserved), got {n_pages}")
        self.n_pages = n_pages
        self.batch = batch
        self.n_chunks = n_chunks
        self.page_bytes = page_bytes
        self._free: list[int] = list(range(n_pages - 1, 0, -1))  # pop() -> 1 first
        self._refs = np.zeros(n_pages, np.int64)
        self._refs[0] = 1                      # zero page: never allocatable
        # host mirror of the device block tables; row b all-zero == idle slot
        self.block_tables = np.zeros((batch, n_chunks), np.int32)
        self._slot_n = np.zeros(batch, np.int64)   # pages held per slot
        self.stats = {"admits": 0, "rejects": 0, "shared_pages": 0,
                      "fresh_pages": 0, "freed_pages": 0}
        # fault-injection hook (serving/faults.py): a FaultInjector whose
        # on_admit may raise PoolExhausted before any state change; None in
        # production
        self.faults = None

    # -- capacity ----------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return (self.n_pages - 1) - len(self._free)

    @property
    def total_bytes(self) -> int:
        return (self.n_pages - 1) * self.page_bytes

    @property
    def used_bytes(self) -> int:
        return self.used_pages * self.page_bytes

    def can_admit(self, n_total: int, n_shared: int = 0) -> bool:
        """True when a reservation of ``n_total`` pages (``n_shared`` of
        them prefix-cache hits needing no allocation) would succeed."""
        return (n_total - n_shared) <= len(self._free) and n_total <= self.n_chunks

    def snapshot(self) -> PoolSnapshot:
        """Typed snapshot of lifetime counters + current occupancy."""
        return PoolSnapshot(
            admits=self.stats["admits"], rejects=self.stats["rejects"],
            shared_pages=self.stats["shared_pages"],
            fresh_pages=self.stats["fresh_pages"],
            freed_pages=self.stats["freed_pages"],
            page_bytes=self.page_bytes, free_pages=self.free_pages,
            used_pages=self.used_pages, total_bytes=self.total_bytes,
            used_bytes=self.used_bytes)

    # -- slot lifecycle ----------------------------------------------------
    def admit(self, slot: int, n_total: int,
              shared: Sequence[int] = ()) -> np.ndarray:
        """Reserve ``n_total`` pages for ``slot``: the leading
        ``len(shared)`` entries reuse the given (prefix-cache) pages with a
        refcount bump, the rest are allocated fresh.  Returns the pages
        newly allocated (the ones the engine must zero on device before
        pushing the table row).  Raises :class:`PoolExhausted` when the
        free list is short — state unchanged, safe to retry later.
        """
        shared = list(shared)
        if self._slot_n[slot]:
            raise RuntimeError(f"slot {slot} already admitted; release first")
        if len(shared) > n_total:
            raise ValueError(f"{len(shared)} shared pages > total {n_total}")
        if n_total > self.n_chunks:
            raise ValueError(
                f"request needs {n_total} pages but the block table has "
                f"{self.n_chunks} chunk entries (capacity bound)")
        if self.faults is not None:
            try:
                self.faults.on_admit(slot)
            except PoolExhausted:
                self.stats["rejects"] += 1
                raise
        n_fresh = n_total - len(shared)
        if n_fresh > len(self._free):
            self.stats["rejects"] += 1
            raise PoolExhausted(
                f"slot {slot}: need {n_fresh} fresh pages, {len(self._free)} free")
        for p in shared:
            if self._refs[p] <= 0:
                raise RuntimeError(f"shared page {p} is not live")
        fresh = [self._free.pop() for _ in range(n_fresh)]
        for p in shared:
            self._refs[p] += 1
        for p in fresh:
            self._refs[p] = 1
        row = self.block_tables[slot]
        row[:] = 0
        row[:n_total] = shared + fresh
        self._slot_n[slot] = n_total
        self.stats["admits"] += 1
        self.stats["shared_pages"] += len(shared)
        self.stats["fresh_pages"] += n_fresh
        return np.asarray(fresh, np.int32)

    def release_slot(self, slot: int) -> list[int]:
        """Drop the slot's reference on every page in its block-table row
        and clear the row.  Returns the pages whose count hit zero (now
        back on the free list) — informational; the engine does no device
        work for them (zero-at-admit invariant)."""
        n = int(self._slot_n[slot])
        freed = []
        for p in self.block_tables[slot, :n]:
            if self._release_page(int(p)):
                freed.append(int(p))
        self.block_tables[slot] = 0
        self._slot_n[slot] = 0
        self.stats["freed_pages"] += len(freed)
        return freed

    def slot_pages(self, slot: int) -> np.ndarray:
        return self.block_tables[slot, : int(self._slot_n[slot])].copy()

    # -- prefix-cache handles ---------------------------------------------
    def retain(self, page: int) -> int:
        """Take an extra reference (trie insertion).  Returns the page."""
        if self._refs[page] <= 0:
            raise RuntimeError(f"retain of dead page {page}")
        self._refs[page] += 1
        return page

    def release(self, page: int) -> bool:
        """Drop one reference (trie eviction).  True if the page was freed."""
        freed = self._release_page(page)
        if freed:
            self.stats["freed_pages"] += 1
        return freed

    def _release_page(self, page: int) -> bool:
        if page == 0:
            return False                        # zero page is permanent
        if self._refs[page] <= 0:
            raise RuntimeError(f"double free of page {page}")
        self._refs[page] -= 1
        if self._refs[page] == 0:
            self._free.append(page)
            return True
        return False

    def refcount(self, page: int) -> int:
        return int(self._refs[page])

    def check(self) -> None:
        """Structural invariant audit (tests): every page is exactly free
        or live; :meth:`audit` with the trie's handles checks the counts."""
        rep = self.audit()
        assert rep["ok"], rep["issues"]

    def audit(self, retained: Sequence[int] | None = None) -> dict:
        """Structural invariant audit; returns a report, never raises.

        Always checked: the free list has no duplicates and never holds
        page 0; every page is *exactly* one of free or live (refcount >
        0); every block-table entry within a slot's extent is live;
        entries past the extent are 0.  When ``retained`` (the full
        multiset of pages the prefix trie holds handles on) is supplied,
        refcounts are checked *exactly*: each page's count must equal its
        block-table occurrences plus its retained-handle count, and any
        live page with neither is reported in ``leaked_pages``.  Without
        ``retained`` (callers that cannot see the trie), only the
        structural invariants run.
        """
        issues: list[str] = []
        free = set(self._free)
        if 0 in free:
            issues.append("zero page on the free list")
        if len(free) != len(self._free):
            issues.append("free list has duplicates")
        for p in range(1, self.n_pages):
            live = self._refs[p] > 0
            if self._refs[p] < 0:
                issues.append(f"page {p}: negative refcount {self._refs[p]}")
            if live == (p in free):
                issues.append(f"page {p}: refs={self._refs[p]} free={p in free}")
        table_occ = np.zeros(self.n_pages, np.int64)
        for b in range(self.batch):
            n = int(self._slot_n[b])
            for p in self.block_tables[b, :n]:
                p = int(p)
                if not 0 <= p < self.n_pages:
                    issues.append(f"slot {b}: table entry {p} out of range")
                    continue
                table_occ[p] += 1
                if p != 0 and self._refs[p] <= 0:
                    issues.append(f"slot {b}: dead page {p} in block table")
            if np.any(self.block_tables[b, n:] != 0):
                issues.append(f"slot {b}: nonzero table entries past extent {n}")
        leaked: list[int] = []
        if retained is not None:
            held = np.zeros(self.n_pages, np.int64)
            for p in retained:
                held[int(p)] += 1
            for p in range(1, self.n_pages):
                expect = int(table_occ[p] + held[p])
                if int(self._refs[p]) != expect:
                    issues.append(f"page {p}: refs={int(self._refs[p])} but "
                                  f"tables+handles={expect}")
                if self._refs[p] > 0 and expect == 0:
                    leaked.append(p)
        return {"ok": not issues, "issues": issues, "leaked_pages": leaked,
                "free_pages": len(self._free), "used_pages": self.used_pages}


class PagePoolStore:
    """Chunk-store adapter making pool pages the prefix-cache payload.

    Drop-in for :class:`repro_torch.prefixcache.store.ChunkStore`: a payload
    handle IS a page id.  ``put`` takes the trie's reference on the page
    (it must already be live — the admitting slot holds it), ``free``
    releases it, ``get`` returns the page id for the engine to gather
    device-side.  ``nbytes_of`` prices every handle at the pool's exact
    page cost, so the trie's LRU byte budget governs real pool bytes.
    """

    def __init__(self, pool: PagePool):
        self.pool = pool
        self._count = 0

    def __len__(self) -> int:
        return self._count

    @property
    def total_bytes(self) -> int:
        return self._count * self.pool.page_bytes

    def put(self, page: int) -> int:
        handle = self.pool.retain(int(page))
        self._count += 1
        return handle

    def get(self, handle: int) -> int:
        return handle

    def free(self, handle: int) -> None:
        self.pool.release(int(handle))
        self._count -= 1

    def nbytes_of(self, payload) -> int:
        return self.pool.page_bytes
