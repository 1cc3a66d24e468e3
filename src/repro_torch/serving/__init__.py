"""Public serving API (port of ``repro.serving``, limited to what the port has).

* :class:`Engine` / :class:`EngineConfig` with the typed knobs
  :class:`AttendPath`, :class:`PrefillMode` and :class:`CacheLayout`
  (their strings are taken too);
* :class:`Scheduler` with :class:`Request` / :class:`Result`: wave and
  continuous batching;
* :class:`CacheView` (:class:`DenseCacheView` / :class:`PagedCacheView`),
  the slot protocol the scheduler drives;
* the paged pool primitives (:class:`PagePool`, :class:`PagePoolStore`,
  :class:`PoolExhausted`, :class:`PoolSnapshot`, :func:`pages_needed`);
* the resilience layer: :class:`RequestStatus` / :class:`RetryPolicy` /
  :class:`AdmissionValve`, :class:`NumericFault` quarantine and the
  fault-injection harness (:class:`FaultInjector`, :class:`FaultEvent`,
  :class:`FakeClock`, :class:`InjectedFault`);
* telemetry: :class:`ObsConfig` / :class:`Observability`
  (``EngineConfig(obs=...)``) and the typed :class:`PrefixSnapshot`.
"""

from repro_torch.core.cache import NumericFault
from repro_torch.obs import Observability, ObsConfig
from repro_torch.prefixcache import PrefixSnapshot
from repro_torch.serving.engine import (AttendPath, CacheLayout, Engine, EngineConfig,
                                        PrefillMode, prefix_cache_unsupported_reason)
from repro_torch.serving.faults import FakeClock, FaultEvent, FaultInjector, InjectedFault
from repro_torch.serving.pagedpool import (PagePool, PagePoolStore, PoolExhausted,
                                           PoolSnapshot, pages_needed)
from repro_torch.serving.resilience import AdmissionValve, RequestStatus, RetryPolicy
from repro_torch.serving.sampling import sample
from repro_torch.serving.scheduler import Request, Result, Scheduler
from repro_torch.serving.views import CacheView, DenseCacheView, PagedCacheView

__all__ = [
    "AttendPath", "PrefillMode", "CacheLayout",
    "Engine", "EngineConfig", "prefix_cache_unsupported_reason",
    "Scheduler", "Request", "Result",
    "CacheView", "DenseCacheView", "PagedCacheView",
    "PagePool", "PagePoolStore", "PoolExhausted", "pages_needed",
    "RequestStatus", "RetryPolicy", "AdmissionValve", "NumericFault",
    "FaultInjector", "FaultEvent", "FakeClock", "InjectedFault",
    "ObsConfig", "Observability", "PoolSnapshot", "PrefixSnapshot",
    "sample",
]
