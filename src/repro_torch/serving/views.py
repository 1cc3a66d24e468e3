"""Slot-view facade over the engine's cache tree (port of
``repro.serving.views``).

A view owns one live cache tree (a list of per-layer caches) and wraps the
engine's slot protocol, the admission question, the reclaim valve and the
invariant audit, so the scheduler never threads raw caches and works the
same for both layouts.  :class:`CacheView` is the protocol;
:class:`DenseCacheView` and :class:`PagedCacheView` implement it.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from repro_torch.serving.pagedpool import pages_needed

__all__ = ["CacheView", "DenseCacheView", "PagedCacheView"]


@runtime_checkable
class CacheView(Protocol):
    """One live cache tree and the slot protocol the scheduler drives."""

    caches: Any

    def can_admit(self, n_tokens: int) -> bool:
        """Would a request whose lifetime holds ``n_tokens`` be admitted now?"""
        ...

    def prefill_slot(self, batch1: dict, slot: int, admit: bool = True,
                     reserve_tokens: int | None = None):
        """Prefill one raw-length prompt into ``slot``; returns its
        last-position logits."""
        ...

    def reset_slot(self, slot: int) -> None: ...

    def decode(self, token_batch: dict, pos):
        """One decode step over all slots; returns logits."""
        ...

    def reclaim(self, n_tokens: int) -> bool:
        """Try to free enough backing store to admit ``n_tokens``; True if
        ``can_admit`` now holds."""
        ...

    def audit(self) -> dict:
        """Backing-store invariant report ``{"ok", "issues", ...}``; never raises."""
        ...


class _ViewBase:
    def __init__(self, engine, caches):
        self.engine = engine
        self.caches = caches

    def prefill_slot(self, batch1: dict, slot: int, admit: bool = True,
                     reserve_tokens: int | None = None):
        """Prefill one raw-length prompt into ``slot``; ``admit=False`` keeps
        its chunks out of the prefix trie, ``reserve_tokens`` right-sizes a
        paged reservation to the request's lifetime."""
        logits, self.caches = self.engine.prefill_slot(batch1, self.caches, slot, admit=admit,
                                                       reserve_tokens=reserve_tokens)
        return logits

    def reset_slot(self, slot: int) -> None:
        self.caches = self.engine.reset_slot(self.caches, slot)

    def decode(self, token_batch: dict, pos):
        logits, self.caches = self.engine.decode(token_batch, self.caches, pos)
        return logits

    def audit(self) -> dict:
        """Backing-store invariant report ``{"ok", "issues", ...}``; never raises."""
        return self.engine.audit()


class DenseCacheView(_ViewBase):
    """Dense per-slot layout: a free slot always has full capacity."""

    def can_admit(self, n_tokens: int) -> bool:
        return True

    def reclaim(self, n_tokens: int) -> bool:
        return False                 # nothing to reclaim; admission never fails


class PagedCacheView(_ViewBase):
    """Pooled page layout: admission is limited by the pool's free pages.
    ``can_admit`` prices the request with no prefix sharing (a hit only
    lowers the fresh pages it needs), so a True answer guarantees that
    ``prefill_slot`` will not raise
    :class:`~repro_torch.serving.pagedpool.PoolExhausted`; ``reclaim``
    turns prefix-trie references back into free pages."""

    def _pages(self, n_tokens: int) -> int:
        return pages_needed(n_tokens, self.engine.ecfg.policy.buffer_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.engine.pool.can_admit(self._pages(n_tokens))

    def reclaim(self, n_tokens: int) -> bool:
        """Evict trie entries until ``n_tokens`` fit; True if they now do."""
        deficit = self._pages(n_tokens) - self.engine.pool.free_pages
        if deficit > 0:
            self.engine.reclaim_pages(deficit)
        return self.can_admit(n_tokens)
