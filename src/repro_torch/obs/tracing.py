"""Per-request trace spans for the serving lifecycle (port of
``repro.obs.tracing``).

A :class:`Tracer` records one :class:`RequestTrace` per rid through
``submit → admit/shed → prefill [prefix-hit, bucket, pages reserved] →
splice → decode → retire``, plus instant events for retries, fault
injections, and numeric-quarantine hits.  The scheduler drives the
lifecycle; the engine — which never sees rids — contributes via a
*bound* rid (:meth:`Tracer.bind` around ``view.prefill_slot``), through
which it annotates the open prefill span and wraps the splice.

Design rules:

* **Never crash serving.** Every method no-ops on unknown rids and
  unbalanced span calls; tracing is an observer, not a participant.
* **Injectable clock.** Timestamps come from the same clock the
  scheduler uses (``FakeClock`` in tests), so traces are deterministic
  under the chaos harness.
* **Single-threaded scheduler assumption.** One bound rid at a time is
  enough because ``run_continuous`` is a single-threaded loop; the
  registry (not the tracer) is the thread-safe layer.

Export is Chrome ``trace_event`` JSON (:meth:`Tracer.to_chrome`, load in
``chrome://tracing`` / Perfetto): each request is a ``tid``, spans are
complete (``"ph": "X"``) events, instants are ``"ph": "i"``.  For
profiling the engine's calls themselves, :func:`profiler_span` opens a
``torch.profiler.record_function`` range so prefill and decode show up
named in ``torch.profiler`` traces.
"""

from __future__ import annotations

import contextlib
import json
import time

__all__ = ["Span", "RequestTrace", "Tracer", "profiler_span", "TRACE_SCHEMA"]

TRACE_SCHEMA = "gear-repro/trace/v1"


class Span:
    """One named interval inside a request trace."""

    __slots__ = ("name", "t0", "t1", "args")

    def __init__(self, name: str, t0: float, args: dict | None = None):
        self.name = name
        self.t0 = float(t0)
        self.t1: float | None = None
        self.args: dict = dict(args or {})

    def as_dict(self) -> dict:
        return {"name": self.name, "t0": self.t0, "t1": self.t1,
                "args": dict(self.args)}


class RequestTrace:
    """Everything recorded about one rid: spans, instant events, terminal
    status.  ``events`` entries are ``(name, t, args)`` tuples."""

    __slots__ = ("rid", "t_submit", "t_end", "status", "spans", "events",
                 "decode_steps", "attempts", "_open")

    def __init__(self, rid: int, t_submit: float):
        self.rid = rid
        self.t_submit = float(t_submit)
        self.t_end: float | None = None
        self.status = ""            # terminal RequestStatus value once retired
        self.spans: list[Span] = []
        self.events: list[tuple[str, float, dict]] = []
        self.decode_steps = 0
        self.attempts = 0
        self._open: list[Span] = []  # innermost-last stack of open spans

    @property
    def done(self) -> bool:
        return self.t_end is not None

    def as_dict(self) -> dict:
        return {"rid": self.rid, "status": self.status,
                "t_submit": self.t_submit, "t_end": self.t_end,
                "decode_steps": self.decode_steps, "attempts": self.attempts,
                "spans": [s.as_dict() for s in self.spans],
                "events": [{"name": n, "t": t, "args": a}
                           for n, t, a in self.events]}


class Tracer:
    """Collects request traces; see module docstring for the contract."""

    def __init__(self, clock=None, enabled: bool = True,
                 max_completed: int = 4096):
        self.clock = time.monotonic if clock is None else clock
        self.enabled = bool(enabled)
        self.max_completed = int(max_completed)
        self.active: dict[int, RequestTrace] = {}
        self.completed: list[RequestTrace] = []
        self._bound: int | None = None

    # -- lifecycle ---------------------------------------------------------
    def start(self, rid: int) -> None:
        if not self.enabled:
            return
        stale = self.active.pop(rid, None)
        if stale is not None:       # resubmitted while active: a scheduler
            self._finish_trace(stale, "abandoned")  # bug, keep the evidence
        self.active[rid] = RequestTrace(rid, self.clock())

    def finish(self, rid: int, status: str) -> None:
        tr = self.active.pop(rid, None)
        if tr is not None:
            self._finish_trace(tr, str(status))

    def _finish_trace(self, tr: RequestTrace, status: str) -> None:
        now = self.clock()
        while tr._open:             # auto-close dangling spans
            sp = tr._open.pop()
            sp.t1 = now
            tr.spans.append(sp)
        tr.status = status
        tr.t_end = now
        if len(self.completed) < self.max_completed:
            self.completed.append(tr)

    def reset(self) -> None:
        """Drop all traces (benches call this between warmup and measured
        drives so coverage checks see exactly one trace per rid)."""
        self.active.clear()
        self.completed.clear()
        self._bound = None

    # -- spans and events --------------------------------------------------
    def begin(self, rid: int, name: str, **args) -> None:
        tr = self.active.get(rid)
        if tr is not None:
            tr._open.append(Span(name, self.clock(), args))

    def end(self, rid: int) -> None:
        tr = self.active.get(rid)
        if tr is not None and tr._open:
            sp = tr._open.pop()
            sp.t1 = self.clock()
            tr.spans.append(sp)

    @contextlib.contextmanager
    def span(self, rid: int, name: str, **args):
        self.begin(rid, name, **args)
        try:
            yield
        finally:
            self.end(rid)

    def add_span(self, rid: int, name: str, dur: float, **args) -> None:
        """Record an already-elapsed interval ending now (used for the
        aggregate decode span, whose per-step timing lives in the
        histogram)."""
        tr = self.active.get(rid)
        if tr is not None:
            t1 = self.clock()
            sp = Span(name, t1 - float(dur), args)
            sp.t1 = t1
            tr.spans.append(sp)

    def event(self, rid: int, name: str, **args) -> None:
        tr = self.active.get(rid)
        if tr is not None:
            tr.events.append((name, self.clock(), dict(args)))

    def step(self, rid: int, n: int = 1) -> None:
        tr = self.active.get(rid)
        if tr is not None:
            tr.decode_steps += int(n)

    def attempt(self, rid: int) -> None:
        tr = self.active.get(rid)
        if tr is not None:
            tr.attempts += 1

    # -- bound rid (engine-side correlation) -------------------------------
    def bind(self, rid: int) -> None:
        self._bound = rid

    def unbind(self) -> None:
        self._bound = None

    def annotate(self, **args) -> None:
        """Merge args into the innermost open span of the bound trace
        (falling back to the trace's last closed span); no-op unbound."""
        tr = self.active.get(self._bound) if self._bound is not None else None
        if tr is None:
            return
        if tr._open:
            tr._open[-1].args.update(args)
        elif tr.spans:
            tr.spans[-1].args.update(args)

    def span_bound(self, name: str, **args):
        if self._bound is None:
            return contextlib.nullcontext()
        return self.span(self._bound, name, **args)

    def event_bound(self, name: str, **args) -> None:
        if self._bound is not None:
            self.event(self._bound, name, **args)

    # -- queries -----------------------------------------------------------
    def coverage(self, rids) -> dict:
        """Report trace coverage over ``rids``: per-rid completed-trace
        counts plus missing/duplicate/unfinished lists.  The chaos tests
        and ``bench_throughput --obs`` assert ``complete`` is True."""
        want = list(rids)
        counts: dict[int, int] = {}
        statuses: dict[int, str] = {}
        for tr in self.completed:
            counts[tr.rid] = counts.get(tr.rid, 0) + 1
            statuses[tr.rid] = tr.status
        missing = [r for r in want if counts.get(r, 0) == 0]
        duplicates = [r for r in want if counts.get(r, 0) > 1]
        unfinished = sorted(self.active)
        return {"complete": not missing and not duplicates and not unfinished,
                "missing": missing, "duplicates": duplicates,
                "unfinished": unfinished, "statuses": statuses}

    # -- export ------------------------------------------------------------
    def to_chrome(self) -> dict:
        """Chrome ``trace_event`` JSON object (``traceEvents`` key plus a
        schema tag; extra keys are ignored by viewers)."""
        ev: list[dict] = []
        t0 = min((tr.t_submit for tr in self.completed), default=0.0)

        def us(t: float) -> float:
            return (t - t0) * 1e6

        for tr in self.completed:
            end = tr.t_end if tr.t_end is not None else tr.t_submit
            ev.append({"name": "request", "cat": "request", "ph": "X",
                       "pid": 0, "tid": tr.rid, "ts": us(tr.t_submit),
                       "dur": us(end) - us(tr.t_submit),
                       "args": {"rid": tr.rid, "status": tr.status,
                                "decode_steps": tr.decode_steps,
                                "attempts": tr.attempts}})
            for sp in tr.spans:
                t1 = sp.t1 if sp.t1 is not None else end
                ev.append({"name": sp.name, "cat": "span", "ph": "X",
                           "pid": 0, "tid": tr.rid, "ts": us(sp.t0),
                           "dur": us(t1) - us(sp.t0), "args": dict(sp.args)})
            for name, t, args in tr.events:
                ev.append({"name": name, "cat": "event", "ph": "i", "s": "t",
                           "pid": 0, "tid": tr.rid, "ts": us(t),
                           "args": dict(args)})
        ev.sort(key=lambda e: (e["tid"], e["ts"], e["ph"]))
        return {"schema": TRACE_SCHEMA, "traceEvents": ev}

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.to_chrome(), indent=indent, sort_keys=True)


def profiler_span(name: str, enabled: bool):
    """Context manager: a ``torch.profiler.record_function`` range named
    ``name`` when enabled (so prefill and decode are named in profiler
    traces), else a no-op."""
    if not enabled:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
