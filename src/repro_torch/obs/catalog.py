"""Declared metric catalog of the serving stack (copy of
``repro.obs.catalog``: the same names, kinds, labels and buckets).

Every metric the serving and obs layers emit is declared here as a
:class:`MetricSpec` and pre-registered by :func:`build_registry`, so a
snapshot always holds the whole catalog.  Label values come from closed sets
only (``status`` from ``RequestStatus``, ``site`` from ``FAULT_SITES``,
``kind`` from the two retry kinds, ``layer`` / ``field`` from the model's
layers), which is what makes the registry's cardinality bounds meaningful.
The ``fidelity_*`` metrics are filled by the fidelity probes
(:mod:`repro_torch.obs.fidelity`) when an engine turns them on.
"""

from __future__ import annotations

from dataclasses import dataclass

from .registry import DEFAULT_BUCKETS, Registry

__all__ = ["MetricSpec", "METRICS", "build_registry"]

# bucket ladders ------------------------------------------------------------
_SECONDS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
            0.5, 1.0, 2.5, 5.0, 10.0)
_TOKENS = (16.0, 32.0, 64.0, 128.0, 256.0, 512.0, 1024.0, 2048.0, 4096.0)
_RATIO = (1e-4, 3e-4, 1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0)
_DRIFT = (1e-3, 3e-3, 0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0)


@dataclass(frozen=True)
class MetricSpec:
    name: str
    kind: str                     # "counter" | "gauge" | "histogram"
    help: str
    labels: tuple = ()
    buckets: tuple = ()
    max_label_sets: int = 64


METRICS = (
    # -- request lifecycle (scheduler) -------------------------------------
    MetricSpec("serving_requests_submitted_total", "counter",
               "Requests accepted by Scheduler.submit (excludes shed)."),
    MetricSpec("serving_requests_shed_total", "counter",
               "Submits rejected at admission by the AdmissionValve."),
    MetricSpec("serving_results_total", "counter",
               "Terminal results by RequestStatus value.", ("status",)),
    MetricSpec("serving_retries_total", "counter",
               "Retry attempts by kind (admission | decode).", ("kind",)),
    MetricSpec("serving_quarantine_total", "counter",
               "Numeric-guard quarantine hits (NaN/Inf compressed chunks)."),
    MetricSpec("serving_faults_injected_total", "counter",
               "FaultInjector firings by site.", ("site",), max_label_sets=16),
    MetricSpec("serving_decode_steps_total", "counter",
               "Jitted decode steps executed by run_continuous."),
    MetricSpec("serving_tokens_generated_total", "counter",
               "Tokens sampled across all slots (decode only)."),
    MetricSpec("serving_queue_depth", "gauge",
               "Requests waiting in the scheduler queue."),
    MetricSpec("serving_prefill_seconds", "histogram",
               "Per-request prefill latency (includes splice).",
               buckets=_SECONDS),
    MetricSpec("serving_decode_step_seconds", "histogram",
               "Per-step decode latency across the active batch.",
               buckets=_SECONDS),
    MetricSpec("serving_queue_wait_seconds", "histogram",
               "Submit-to-prefill queue wait.", buckets=_SECONDS),
    MetricSpec("serving_prefill_bucket_tokens", "histogram",
               "Padded prefill bucket size in tokens (raw length when "
               "bucketing is off).", buckets=_TOKENS),
    # -- paged pool --------------------------------------------------------
    MetricSpec("pool_admits_total", "counter",
               "Successful PagePool.admit reservations."),
    MetricSpec("pool_rejects_total", "counter",
               "PagePool.admit failures (PoolExhausted)."),
    MetricSpec("pool_shared_pages_total", "counter",
               "Pages admitted by refcount bump (prefix hits)."),
    MetricSpec("pool_fresh_pages_total", "counter",
               "Pages allocated fresh from the free list."),
    MetricSpec("pool_freed_pages_total", "counter",
               "Pages whose refcount dropped to zero and were freed."),
    MetricSpec("pool_free_pages", "gauge", "Pages currently free."),
    MetricSpec("pool_used_pages", "gauge", "Pages currently referenced."),
    # -- prefix cache ------------------------------------------------------
    MetricSpec("prefix_lookup_chunks_total", "counter",
               "Chunks requested across trie lookups."),
    MetricSpec("prefix_hit_chunks_total", "counter",
               "Chunks served from the trie."),
    MetricSpec("prefix_inserts_total", "counter",
               "Chunks inserted into the trie."),
    MetricSpec("prefix_evictions_total", "counter",
               "Chunks evicted under the byte budget."),
    MetricSpec("prefix_expiries_total", "counter",
               "Chunks pruned by TTL expiry."),
    MetricSpec("prefix_version_evictions_total", "counter",
               "Chunks invalidated by weight-version bumps."),
    MetricSpec("prefix_toks_saved_total", "counter",
               "Prefill tokens skipped thanks to prefix hits."),
    MetricSpec("prefix_validate_failures_total", "counter",
               "ChunkStore.put rejections of non-finite payloads."),
    MetricSpec("prefix_nodes", "gauge", "Live trie nodes."),
    MetricSpec("prefix_bytes", "gauge", "Payload bytes pinned by the trie."),
    # -- fidelity probes ---------------------------------------------------
    MetricSpec("fidelity_probes_total", "counter",
               "Fidelity probes executed (sampled prefills)."),
    MetricSpec("fidelity_probe_skipped_total", "counter",
               "Probes skipped by the overhead budget throttle."),
    MetricSpec("fidelity_probe_errors_total", "counter",
               "Probes that raised (swallowed; serving unaffected)."),
    MetricSpec("fidelity_sampled_chunks_total", "counter",
               "Closed chunks covered by probes, per layer.", ("layer",),
               max_label_sets=256),
    MetricSpec("fidelity_rel_err", "histogram",
               "Per-layer relative Frobenius error of reconstructed K/V "
               "vs the fp16 shadow prefill.", ("field", "layer"),
               _RATIO, max_label_sets=512),
    MetricSpec("fidelity_lowrank_share", "histogram",
               "Low-rank residual share of the reconstruction norm.",
               ("field", "layer"), _RATIO, max_label_sets=512),
    MetricSpec("fidelity_outlier_mass", "histogram",
               "Sparse-outlier share of the reconstruction norm.",
               ("field", "layer"), _RATIO, max_label_sets=512),
    MetricSpec("fidelity_logits_drift", "histogram",
               "Max-abs last-position logits drift vs the fp16 shadow.",
               buckets=_DRIFT),
    MetricSpec("fidelity_probe_seconds", "histogram",
               "Wall time spent inside each probe.", buckets=_SECONDS),
)


def build_registry(clock=None) -> Registry:
    """A :class:`Registry` with the full catalog pre-registered."""
    reg = Registry(clock=clock)
    for m in METRICS:
        if m.kind == "counter":
            reg.counter(m.name, m.help, m.labels, m.max_label_sets)
        elif m.kind == "gauge":
            reg.gauge(m.name, m.help, m.labels, m.max_label_sets)
        elif m.kind == "histogram":
            reg.histogram(m.name, m.help, m.labels,
                          m.buckets or DEFAULT_BUCKETS, m.max_label_sets)
        else:  # pragma: no cover - catalog is literal
            raise ValueError(f"unknown metric kind {m.kind!r}")
    return reg
