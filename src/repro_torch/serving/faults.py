"""Seeded, deterministic fault injection for the serving stack (port of
``repro.serving.faults``).

A :class:`FaultInjector` fires faults at named **sites** of the request
lifecycle, either with a per-visit probability (one seeded numpy stream per
site, ``RandomState([seed & 0x7FFFFFFF, site_index])`` as in the reference,
so the same ``(seed, rates, schedule)`` gives the same firing ``log``) or at
exact visit indices (:class:`FaultEvent`).

Sites and what firing does:

* ``pool_exhausted`` — :meth:`~repro_torch.serving.pagedpool.PagePool.admit`
  raises :class:`~repro_torch.serving.pagedpool.PoolExhausted` with no state
  change;
* ``nan_chunk`` — element 0 of the first floating leaf of a request's
  batch-1 cache tree becomes NaN before the engine's numeric guard runs;
* ``prefill_error`` / ``decode_error`` — an :class:`InjectedFault` is raised
  before the step is dispatched, so no cache state was touched;
* ``clock_skew`` — the injector's :class:`FakeClock` jumps ``skew_s``;
* ``trie_evict`` — the engine's prefix cache is evicted down to its pinned
  paths.

The scheduler attaches an injector (``Scheduler(engine, faults=...)``); no
production path refers to this module otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from repro_torch.core.cache import NumericFault, _parts

__all__ = ["FAULT_SITES", "FakeClock", "FaultEvent", "FaultInjector",
           "InjectedFault", "NumericFault"]

FAULT_SITES = ("pool_exhausted", "nan_chunk", "prefill_error", "decode_error",
               "clock_skew", "trie_evict")


class InjectedFault(RuntimeError):
    """A deliberately raised engine-step fault (transient by construction);
    the scheduler retries it bounded, then fails the request."""

    def __init__(self, msg: str, site: str = ""):
        super().__init__(msg)
        self.site = site


class FakeClock:
    """Injectable monotonic-seconds source whose ``sleep`` advances time:
    one instance shared by the trie's TTL, the scheduler's deadlines and
    backoff and the injector's skew makes them deterministic in tests."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        if dt < 0:
            raise ValueError(f"clock cannot run backwards (dt={dt})")
        self.t += dt

    def sleep(self, dt: float) -> None:
        self.advance(max(float(dt), 0.0))


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """Fire ``site`` deterministically on its ``at``-th visit (0-based)."""

    site: str
    at: int

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r}; sites: {FAULT_SITES}")
        if self.at < 0:
            raise ValueError(f"event index must be >= 0, got {self.at}")


class FaultInjector:
    """Deterministic fault source: per-site seeded rates + exact schedules
    (a visit fires if either says so).  ``visits`` / ``fired`` counters and
    the ``log`` of ``(site, visit_index)`` firings audit every run."""

    def __init__(self, seed: int = 0, rates: dict[str, float] | None = None,
                 schedule: Sequence[FaultEvent] = (), clock: FakeClock | None = None,
                 skew_s: float = 3600.0, evict_bytes: int = 1 << 62):
        rates = dict(rates or {})
        unknown = set(rates) - set(FAULT_SITES)
        if unknown:
            raise ValueError(f"unknown fault sites {sorted(unknown)}; sites: {FAULT_SITES}")
        for site, rate in rates.items():
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"rate for {site!r} must be in [0, 1], got {rate}")
        self.rates = rates
        self._sched: dict[str, set[int]] = {s: set() for s in FAULT_SITES}
        for ev in schedule:
            self._sched[ev.site].add(ev.at)
        self._rngs = {site: np.random.RandomState([int(seed) & 0x7FFFFFFF, i])
                      for i, site in enumerate(FAULT_SITES)}
        self.clock = clock
        self.skew_s = float(skew_s)
        self.evict_bytes = int(evict_bytes)
        self.visits = {s: 0 for s in FAULT_SITES}
        self.fired = {s: 0 for s in FAULT_SITES}
        self.log: list[tuple[str, int]] = []
        # telemetry sink (Engine.attach_faults points it at the engine's
        # Observability): firings become counter increments and trace events
        self.obs = None

    def fire(self, site: str) -> bool:
        """One visit to ``site``; True when a fault should fire now."""
        i = self.visits[site]
        self.visits[site] = i + 1
        rate = self.rates.get(site, 0.0)
        hit = i in self._sched[site]
        if rate > 0.0:
            # always consume the draw so the stream is schedule-independent
            hit = bool(self._rngs[site].random_sample() < rate) or hit
        if hit:
            self.fired[site] += 1
            self.log.append((site, i))
            if self.obs is not None:
                self.obs.fault_fired(site, i)
        return hit

    # -- site hooks ---------------------------------------------------------
    def on_admit(self, slot: int) -> None:
        """Called by :meth:`PagePool.admit` before any state change."""
        if self.fire("pool_exhausted"):
            from repro_torch.serving.pagedpool import PoolExhausted
            raise PoolExhausted(f"slot {slot}: injected pool exhaustion")

    def check_step(self, which: str) -> None:
        """Called by the scheduler before it dispatches a prefill / decode step."""
        if self.fire(f"{which}_error"):
            raise InjectedFault(f"injected {which} engine-step fault", site=f"{which}_error")

    def corrupt_tree(self, tree: Any) -> Any:
        """NaN-poison element 0 of the first floating leaf of a batch-1 cache
        tree (a list of per-layer caches), on a clone of that leaf.  Leaves
        are taken in the order the reference's ``tree_flatten`` visits them:
        layer by layer, a hybrid's (GEAR cache, SSM state) pair in order,
        each object's fields in declaration order, absent fields skipped."""
        if not self.fire("nan_chunk"):
            return tree
        for layer in tree:
            for part in _parts(layer):
                for name, leaf in part.tensors().items():
                    if leaf.is_floating_point():
                        bad = leaf.clone()
                        bad[(0,) * bad.dim()] = float("nan")
                        object.__setattr__(part, name, bad)
                        return tree
        return tree

    def tick(self, engine) -> None:
        """Per-scheduler-iteration environmental faults (skew, eviction)."""
        if self.clock is not None and self.fire("clock_skew"):
            self.clock.advance(self.skew_s)
        pc = getattr(engine, "prefix_cache", None)
        if pc is not None and self.fire("trie_evict"):
            pc.evict_bytes(self.evict_bytes)
