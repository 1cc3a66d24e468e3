"""Serving observability: metrics registry, request tracing and the online
compression-fidelity probes (port of ``repro.obs``).

Enable with ``EngineConfig(obs=ObsConfig(...))`` (or ``obs=True`` for
defaults).  The engine owns one :class:`Observability`; the scheduler finds
it as ``engine.obs`` and drives the request lifecycle, the engine annotates
its prefills, the fault injector reports firings.  Nothing here raises into
the serving path: label sets are closed and the tracer ignores unknown rids.
"""

from __future__ import annotations

import dataclasses
import json
import time

from .catalog import METRICS, MetricSpec, build_registry
from .fidelity import FidelityProbe
from .registry import (CardinalityError, Counter, Gauge, Histogram, Registry,
                       parse_prometheus)
from .tracing import RequestTrace, Span, Tracer, profiler_span

__all__ = [
    "ObsConfig", "Observability",
    "Registry", "Counter", "Gauge", "Histogram", "CardinalityError",
    "parse_prometheus", "Tracer", "Span", "RequestTrace", "profiler_span",
    "MetricSpec", "METRICS", "build_registry", "FidelityProbe",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """Telemetry knobs (the ``EngineConfig.obs`` field; ``obs=True``
    coerces to defaults).

    ``metrics``/``tracing`` toggle the registry sync and per-request
    spans.  ``fidelity_every_n`` > 0 turns on the compression-fidelity
    probes (:class:`~repro_torch.obs.fidelity.FidelityProbe`: one FP16
    shadow prefill each time the running count of closed prompt chunks
    crosses a multiple of it), within ``fidelity_budget_frac`` of real
    time.  ``profiler`` wraps the engine's prefill and decode in
    ``torch.profiler.record_function`` ranges.
    """

    metrics: bool = True
    tracing: bool = True
    fidelity_every_n: int = 0
    fidelity_budget_frac: float = 0.05
    profiler: bool = False

    def __post_init__(self):
        if self.fidelity_every_n < 0:
            raise ValueError("fidelity_every_n must be >= 0 (0 disables)")
        if not 0.0 < self.fidelity_budget_frac <= 1.0:
            raise ValueError("fidelity_budget_frac must be in (0, 1]")


class Observability:
    """Per-engine telemetry hub: registry + tracer, with the emitters the
    serving layers call, and ``fidelity``, the engine's
    :class:`FidelityProbe` when its config asks for one (else None).  All
    emitters are cheap and exception-free by construction (label sets are
    closed; see :mod:`repro_torch.obs.catalog`)."""

    def __init__(self, cfg: ObsConfig, clock=None):
        self.cfg = cfg
        self.clock = time.monotonic if clock is None else clock
        self.registry = build_registry(clock=self.clock)
        self.tracer = Tracer(clock=self.clock, enabled=cfg.tracing)
        self.fidelity: FidelityProbe | None = None     # set by the engine
        self._m = bool(cfg.metrics)
        self._synced: dict = {}

    # -- scheduler lifecycle ----------------------------------------------
    def on_submit(self, rid: int) -> None:
        if self._m:
            self.registry.get("serving_requests_submitted_total").inc()
        self.tracer.start(rid)
        self.tracer.begin(rid, "queued")

    def on_shed(self, rid: int) -> None:
        if self._m:
            self.registry.get("serving_requests_shed_total").inc()
        self.tracer.start(rid)
        self.tracer.finish(rid, "rejected")

    def result(self, status) -> None:
        if self._m:
            self.registry.get("serving_results_total").inc(status=str(status))

    def retry(self, kind: str) -> None:
        if self._m:
            self.registry.get("serving_retries_total").inc(kind=kind)

    def quarantine(self) -> None:
        if self._m:
            self.registry.get("serving_quarantine_total").inc()

    def fault_fired(self, site: str, visit: int) -> None:
        if self._m:
            self.registry.get("serving_faults_injected_total").inc(site=site)
        self.tracer.event_bound("fault", site=site, visit=visit)

    def decode_step(self, seconds: float, n_active: int) -> None:
        if self._m:
            self.registry.get("serving_decode_steps_total").inc()
            self.registry.get("serving_tokens_generated_total").inc(n_active)
            self.registry.get("serving_decode_step_seconds").observe(seconds)

    def queue_depth(self, n: int) -> None:
        if self._m:
            self.registry.get("serving_queue_depth").set(n)

    def observe_prefill(self, seconds: float) -> None:
        if self._m:
            self.registry.get("serving_prefill_seconds").observe(seconds)

    def observe_queue_wait(self, seconds: float) -> None:
        if self._m:
            self.registry.get("serving_queue_wait_seconds").observe(seconds)

    def observe_bucket(self, tokens: int) -> None:
        if self._m:
            self.registry.get("serving_prefill_bucket_tokens").observe(tokens)

    # -- lifetime-counter sync --------------------------------------------
    def sync_counter(self, name: str, cumulative: float, **labels) -> None:
        """Mirror an externally-owned cumulative counter (pool/trie stats
        dicts, which reset when their owner is rebuilt) into a registry
        counter by delta; a value below the last-seen one means the
        source was reset, so the whole new value is fresh growth."""
        key = (name, tuple(sorted(labels.items())))
        seen = self._synced.get(key, 0.0)
        if cumulative < seen:
            seen = 0.0
        delta = cumulative - seen
        if delta > 0:
            self.registry.get(name).inc(delta, **labels)
        self._synced[key] = cumulative

    def sync_pool(self, snap) -> None:
        """snap: a PoolSnapshot (serving/pagedpool.py)."""
        if not self._m:
            return
        for field, metric in (("admits", "pool_admits_total"),
                              ("rejects", "pool_rejects_total"),
                              ("shared_pages", "pool_shared_pages_total"),
                              ("fresh_pages", "pool_fresh_pages_total"),
                              ("freed_pages", "pool_freed_pages_total")):
            self.sync_counter(metric, snap[field])
        self.registry.get("pool_free_pages").set(snap["free_pages"])
        self.registry.get("pool_used_pages").set(snap["used_pages"])

    def sync_prefix(self, snap) -> None:
        """snap: a PrefixSnapshot (repro/prefixcache)."""
        if not self._m:
            return
        for field, metric in (
                ("lookup_chunks", "prefix_lookup_chunks_total"),
                ("hit_chunks", "prefix_hit_chunks_total"),
                ("inserts", "prefix_inserts_total"),
                ("evictions", "prefix_evictions_total"),
                ("expiries", "prefix_expiries_total"),
                ("version_evictions", "prefix_version_evictions_total"),
                ("prefill_toks_saved", "prefix_toks_saved_total"),
                ("validate_failures", "prefix_validate_failures_total")):
            self.sync_counter(metric, snap[field])
        self.registry.get("prefix_nodes").set(snap["nodes"])
        self.registry.get("prefix_bytes").set(snap["bytes"])

    # -- exports -----------------------------------------------------------
    def snapshot(self) -> dict:
        return self.registry.snapshot()

    def to_prometheus(self) -> str:
        return self.registry.to_prometheus()

    def to_json(self, indent: int | None = None) -> str:
        return self.registry.to_json(indent=indent)

    def write_metrics_json(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json(indent=2))

    def write_trace(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.tracer.to_chrome(), f, indent=2, sort_keys=True)
