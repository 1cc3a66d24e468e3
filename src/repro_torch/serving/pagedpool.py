"""Host-side allocator of the paged compressed KV pool (port of
``repro.serving.pagedpool``'s ``PagePool``, ``PoolExhausted`` and
``pages_needed``).

One page holds one ``n_b``-token chunk's compressed fields for one layer,
and every layer's pool shares the page ids, so "page p" is one chunk of the
whole model.  The device arrays live in the engine's
:class:`~repro_torch.core.cache.PagedGEARLayerCache` leaves; this module owns
the free list, the per-page reference counts and the host mirror of the
per-slot block tables, which the engine copies to the device at admission
and release.

The zero-page invariant: page 0 is never allocated and stays zero; block
table rows reset to 0, and fresh pages are zeroed at admission, so a kernel
reading any table entry past a slot's extent streams the dense layout's
zeros.  Prefix sharing (the trie's ``PagePoolStore`` and shared pages at
admission) is not ported yet, so every live page is held by exactly one
slot.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PagePool", "PoolExhausted", "pages_needed"]


def pages_needed(n_tokens: int, chunk: int) -> int:
    """Pages a request holding up to ``n_tokens`` needs: one per started
    chunk (a request is budgeted for its whole lifetime)."""
    return (n_tokens + chunk - 1) // chunk


class PoolExhausted(RuntimeError):
    """Admission failed: fewer free pages than the reservation.  The
    scheduler queues the request and retries after a release."""


class PagePool:
    """Page allocator for one engine's paged cache tree.

    ``n_pages`` counts page 0, so ``n_pages - 1`` pages are allocatable;
    ``page_bytes`` is one page's cost over all layers, so ``used_bytes`` is
    exact.  ``admit`` allocates a slot's reservation and ``release_slot``
    drops the slot's row; a page whose count reaches zero returns to the
    free list unzeroed (it is zeroed at its next admission).
    """

    def __init__(self, n_pages: int, batch: int, n_chunks: int, page_bytes: int):
        if n_pages < 2:
            raise ValueError(f"need >= 2 pages (page 0 reserved), got {n_pages}")
        self.n_pages = n_pages
        self.batch = batch
        self.n_chunks = n_chunks
        self.page_bytes = page_bytes
        self._free: list[int] = list(range(n_pages - 1, 0, -1))   # pop() -> 1 first
        self._refs = np.zeros(n_pages, np.int64)
        self._refs[0] = 1                                          # never allocatable
        self.block_tables = np.zeros((batch, n_chunks), np.int32)  # row of zeros: idle
        self._slot_n = np.zeros(batch, np.int64)
        self.stats = {"admits": 0, "rejects": 0, "fresh_pages": 0, "freed_pages": 0}

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

    def can_admit(self, n_total: int) -> bool:
        """Would a reservation of ``n_total`` pages succeed now?"""
        return n_total <= len(self._free) and n_total <= self.n_chunks

    def snapshot(self) -> dict:
        """Lifetime counters and current occupancy."""
        return dict(self.stats, page_bytes=self.page_bytes, free_pages=self.free_pages,
                    used_pages=self.used_pages, total_bytes=self.total_bytes,
                    used_bytes=self.used_bytes)

    def admit(self, slot: int, n_total: int) -> np.ndarray:
        """Reserve ``n_total`` fresh pages for ``slot`` and return them (the
        engine zeroes them before the table exposes them).  Raises
        :class:`PoolExhausted`, with no state changed, when the free list
        is short."""
        if self._slot_n[slot]:
            raise RuntimeError(f"slot {slot} already admitted; release first")
        if n_total > self.n_chunks:
            raise ValueError(f"request needs {n_total} pages but the block table has "
                             f"{self.n_chunks} chunk entries (capacity bound)")
        if n_total > len(self._free):
            self.stats["rejects"] += 1
            raise PoolExhausted(f"slot {slot}: need {n_total} fresh pages, "
                                f"{len(self._free)} free")
        fresh = [self._free.pop() for _ in range(n_total)]
        self._refs[fresh] = 1
        row = self.block_tables[slot]
        row[:] = 0
        row[:n_total] = fresh
        self._slot_n[slot] = n_total
        self.stats["admits"] += 1
        self.stats["fresh_pages"] += n_total
        return np.asarray(fresh, np.int32)

    def release_slot(self, slot: int) -> list[int]:
        """Drop the slot's reference on every page of its row and clear the
        row; returns the pages that went back to the free list."""
        freed = []
        for p in self.block_tables[slot, :int(self._slot_n[slot])]:
            p = int(p)
            if self._refs[p] <= 0:
                raise RuntimeError(f"double free of page {p}")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._free.append(p)
                freed.append(p)
        self.block_tables[slot] = 0
        self._slot_n[slot] = 0
        self.stats["freed_pages"] += len(freed)
        return freed

    def slot_pages(self, slot: int) -> np.ndarray:
        return self.block_tables[slot, :int(self._slot_n[slot])].copy()

    def check(self) -> None:
        """Assert the invariants of :meth:`audit` (tests)."""
        rep = self.audit()
        assert rep["ok"], rep["issues"]

    def audit(self) -> dict:
        """Invariant report, never raises: the free list has no duplicate and
        no page 0; every page is exactly free or live; table entries within
        a slot's extent are live and past it are 0; and, with no other
        holder of pages, each live page's count equals its table
        occurrences."""
        issues: list[str] = []
        free = set(self._free)
        if 0 in free:
            issues.append("zero page on the free list")
        if len(free) != len(self._free):
            issues.append("free list has duplicates")
        occ = np.zeros(self.n_pages, np.int64)
        for b in range(self.batch):
            n = int(self._slot_n[b])
            for p in self.block_tables[b, :n]:
                p = int(p)
                if not 0 < p < self.n_pages:
                    issues.append(f"slot {b}: table entry {p} out of range")
                    continue
                occ[p] += 1
            if np.any(self.block_tables[b, n:] != 0):
                issues.append(f"slot {b}: nonzero table entries past extent {n}")
        for p in range(1, self.n_pages):
            if (self._refs[p] > 0) == (p in free):
                issues.append(f"page {p}: refs={self._refs[p]} free={p in free}")
            if self._refs[p] != occ[p]:
                issues.append(f"page {p}: refs={self._refs[p]} but table entries={occ[p]}")
        return {"ok": not issues, "issues": issues, "free_pages": len(self._free),
                "used_pages": self.used_pages}
