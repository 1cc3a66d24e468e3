"""Request-lifecycle resilience primitives (port of
``repro.serving.resilience``).

* :class:`RequestStatus` — the typed terminal state every submitted request
  ends with: ``OK`` and ``DEGRADED`` carry the tokens a solo run gives,
  ``TIMEOUT`` the tokens generated before its deadline, ``REJECTED`` and
  ``FAILED`` whatever partial output existed.
* :class:`RetryPolicy` — bounded admission (and decode-step) retries with
  exponential backoff; past ``max_attempts`` the scheduler surfaces a
  terminal ``REJECTED`` (capacity) or ``FAILED`` (fault) result.
* :class:`AdmissionValve` — submit-time load shedding: beyond ``max_queue``
  waiting requests a submission becomes an immediate ``REJECTED`` result.
"""

from __future__ import annotations

import dataclasses
import enum

__all__ = ["RequestStatus", "RetryPolicy", "AdmissionValve"]


class RequestStatus(str, enum.Enum):
    """Terminal state of one served request.

    ``OK`` completed; ``DEGRADED`` completed with the same tokens after an
    impaired admission or a retried decode step; ``TIMEOUT`` its deadline
    elapsed; ``REJECTED`` never admitted (shed at submit, or admission
    failed ``RetryPolicy.max_attempts`` times); ``FAILED`` terminated by a
    fault (numeric quarantine, or repeated engine-step faults)."""

    OK = "ok"
    TIMEOUT = "timeout"
    REJECTED = "rejected"
    DEGRADED = "degraded"
    FAILED = "failed"

    __str__ = str.__str__


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded retries with exponential backoff.  ``backoff_s`` is the wait
    after the first failure, multiplied by ``backoff_mult`` per further
    failure and clamped to ``max_backoff_s``; the default 0 keeps the
    fault-free loop free of sleeps."""

    max_attempts: int = 3
    backoff_s: float = 0.0
    backoff_mult: float = 2.0
    max_backoff_s: float = 1.0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, got {self.max_attempts}")
        if self.backoff_s < 0 or self.max_backoff_s < 0 or self.backoff_mult < 1:
            raise ValueError("backoff knobs must be non-negative (mult >= 1)")

    def backoff(self, attempt: int) -> float:
        """Seconds to wait after failed attempt number ``attempt`` (1-based)."""
        if self.backoff_s <= 0.0:
            return 0.0
        return min(self.backoff_s * self.backoff_mult ** max(attempt - 1, 0),
                   self.max_backoff_s)


@dataclasses.dataclass(frozen=True)
class AdmissionValve:
    """Submit-time load shedding: a submit that would make the wait queue
    longer than ``max_queue`` is recorded as an immediate ``REJECTED``
    result (delivered with the next run's results).  ``None`` disables it."""

    max_queue: int | None = None

    def shed(self, queue_len: int) -> bool:
        """True when a new submission should be rejected at depth ``queue_len``."""
        return self.max_queue is not None and queue_len >= self.max_queue
