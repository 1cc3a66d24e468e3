"""Slot-view facade over the engine's cache tree (port of
``repro.serving.views``' ``DenseCacheView`` and ``PagedCacheView``).

A view owns one live cache tree (a list of per-layer caches) and wraps the
engine's slot protocol and the admission question, so the scheduler never
threads raw caches and works the same for both layouts.
"""

from __future__ import annotations

from repro_torch.serving.pagedpool import pages_needed

__all__ = ["DenseCacheView", "PagedCacheView"]


class _ViewBase:
    def __init__(self, engine, caches):
        self.engine = engine
        self.caches = caches

    def prefill_slot(self, batch1: dict, slot: int, reserve_tokens: int | None = None):
        """Prefill one raw-length prompt into ``slot``; ``reserve_tokens``
        right-sizes a paged reservation to the request's lifetime."""
        logits, self.caches = self.engine.prefill_slot(batch1, self.caches, slot,
                                                       reserve_tokens=reserve_tokens)
        return logits

    def reset_slot(self, slot: int) -> None:
        self.caches = self.engine.reset_slot(self.caches, slot)

    def decode(self, token_batch: dict, pos):
        logits, self.caches = self.engine.decode(token_batch, self.caches, pos)
        return logits


class DenseCacheView(_ViewBase):
    """Dense per-slot layout: a free slot always has full capacity."""

    def can_admit(self, n_tokens: int) -> bool:
        return True


class PagedCacheView(_ViewBase):
    """Pooled page layout: admission is limited by the pool's free pages; a
    True ``can_admit`` guarantees that ``prefill_slot`` will not raise
    :class:`~repro_torch.serving.pagedpool.PoolExhausted`."""

    def can_admit(self, n_tokens: int) -> bool:
        return self.engine.pool.can_admit(
            pages_needed(n_tokens, self.engine.ecfg.policy.buffer_size))
