"""Slot-view facade over the engine's cache tree (port of
``repro.serving.views.DenseCacheView``).

The view owns one live cache tree (a list of per-layer caches) and wraps
the engine's slot protocol, so the scheduler never threads raw caches.
"""

from __future__ import annotations

__all__ = ["DenseCacheView"]


class DenseCacheView:
    """Dense per-slot layout: a free slot always has full capacity."""

    def __init__(self, engine, caches):
        self.engine = engine
        self.caches = caches

    def can_admit(self, n_tokens: int) -> bool:
        return True

    def prefill_slot(self, batch1: dict, slot: int):
        logits, self.caches = self.engine.prefill_slot(batch1, self.caches, slot)
        return logits

    def reset_slot(self, slot: int) -> None:
        self.caches = self.engine.reset_slot(self.caches, slot)

    def decode(self, token_batch: dict, pos):
        logits, self.caches = self.engine.decode(token_batch, self.caches, pos)
        return logits
