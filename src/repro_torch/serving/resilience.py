"""Typed request outcomes (copy of ``repro.serving.resilience.RequestStatus``).

Retries, admission valves and quarantine handling arrive with ROADMAP queue
item 9; the fault-free scheduler emits ``OK`` only.
"""

from __future__ import annotations

import enum

__all__ = ["RequestStatus"]


class RequestStatus(str, enum.Enum):
    """Terminal state of one served request (see the reference for the
    meaning of each state)."""

    OK = "ok"
    TIMEOUT = "timeout"
    REJECTED = "rejected"
    DEGRADED = "degraded"
    FAILED = "failed"

    __str__ = str.__str__
