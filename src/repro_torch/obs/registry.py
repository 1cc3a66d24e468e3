"""Dependency-free metrics registry: counters, gauges, histograms (copy of
``repro.obs.registry``, which the port keeps its own copy of).

Three metric kinds with Prometheus semantics, each with a fixed label schema
and a **bounded** number of label sets (exceeding the bound raises
:class:`CardinalityError` instead of growing silently):

* :class:`Counter` — monotonically increasing float (``inc``);
* :class:`Gauge` — settable level (``set`` / ``inc`` / ``dec``);
* :class:`Histogram` — fixed upper-bound buckets + sum + count
  (``observe``), exposed cumulatively.

A :class:`Registry` owns the metrics, takes an injectable clock (tests pass a
``FakeClock``, so snapshots are deterministic), is thread-safe, and exports
a deterministically ordered :meth:`Registry.snapshot`, its JSON
(:meth:`Registry.to_json`, the ``gear-repro/metrics/v1`` schema that
``repro_torch.launch.serve --metrics-json`` writes) and the Prometheus text
format (:meth:`Registry.to_prometheus`; :func:`parse_prometheus` reads it
back).  Nothing here imports torch or numpy.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Iterable

__all__ = ["CardinalityError", "Counter", "Gauge", "Histogram", "Registry",
           "parse_prometheus", "METRICS_SCHEMA"]

METRICS_SCHEMA = "gear-repro/metrics/v1"

# default histogram buckets (seconds) — roughly prometheus defaults
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


class CardinalityError(RuntimeError):
    """A metric exceeded its ``max_label_sets`` bound.

    Label values in the serving stack come from closed sets (status
    enums, fault sites, layer indices), so hitting this means a caller is
    labelling with unbounded data (rids, prompts) — a bug worth failing
    loudly on rather than leaking memory over.
    """


def _check_name(name: str, what: str) -> str:
    if not name or not set(name) <= _NAME_OK or name[0].isdigit():
        raise ValueError(f"invalid {what} {name!r}")
    return name


class _Metric:
    """Shared label-set plumbing for all three kinds."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Iterable[str] = (),
                 max_label_sets: int = 64):
        self.name = _check_name(name, "metric name")
        self.help = str(help)
        self.label_names = tuple(_check_name(l, "label name") for l in labels)
        if len(set(self.label_names)) != len(self.label_names):
            raise ValueError(f"{name}: duplicate label names {self.label_names}")
        self.max_label_sets = int(max_label_sets)
        if self.max_label_sets < 1:
            raise ValueError(f"{name}: max_label_sets must be >= 1")
        self._series: dict[tuple[str, ...], Any] = {}
        self._lock = threading.Lock()

    def _key(self, labels: dict) -> tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, "
                f"got {tuple(sorted(labels))}")
        return tuple(str(labels[l]) for l in self.label_names)

    def _slot(self, labels: dict):
        key = self._key(labels)
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= self.max_label_sets:
                raise CardinalityError(
                    f"{self.name}: {len(self._series)} label sets at the "
                    f"max_label_sets={self.max_label_sets} bound; refusing "
                    f"new set {dict(zip(self.label_names, key))}")
            series = self._series[key] = self._fresh()
        return key, series

    def _fresh(self):
        raise NotImplementedError

    def spec(self) -> dict:
        return {"name": self.name, "type": self.kind, "help": self.help,
                "labels": list(self.label_names)}

    def same_spec(self, other: "_Metric") -> bool:
        return (self.kind == other.kind and self.help == other.help
                and self.label_names == other.label_names)


class Counter(_Metric):
    kind = "counter"

    def _fresh(self) -> list:
        return [0.0]

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {amount})")
        with self._lock:
            _, series = self._slot(labels)
            series[0] += float(amount)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), [0.0])[0])

    def series(self) -> list[dict]:
        with self._lock:
            return [{"labels": dict(zip(self.label_names, key)),
                     "value": series[0]}
                    for key, series in sorted(self._series.items())]


class Gauge(_Metric):
    kind = "gauge"

    def _fresh(self) -> list:
        return [0.0]

    def set(self, value: float, **labels) -> None:
        with self._lock:
            _, series = self._slot(labels)
            series[0] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        with self._lock:
            _, series = self._slot(labels)
            series[0] += float(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), [0.0])[0])

    series = Counter.series


class Histogram(_Metric):
    """Fixed-bucket histogram: ``observe(v)`` lands in the first bucket
    whose upper bound satisfies ``v <= le`` (Prometheus edge semantics);
    values above every bound land in the implicit ``+Inf`` bucket.
    Internally counts are per-bucket; exposition is cumulative."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Iterable[str] = (),
                 buckets: Iterable[float] = DEFAULT_BUCKETS,
                 max_label_sets: int = 64):
        super().__init__(name, help, labels, max_label_sets)
        bs = tuple(float(b) for b in buckets)
        if not bs or list(bs) != sorted(bs) or len(set(bs)) != len(bs):
            raise ValueError(f"{name}: buckets must be sorted and unique, got {bs}")
        self.buckets = bs

    def _fresh(self) -> dict:
        return {"counts": [0] * (len(self.buckets) + 1), "sum": 0.0, "count": 0}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        with self._lock:
            _, series = self._slot(labels)
            idx = len(self.buckets)
            for i, le in enumerate(self.buckets):
                if v <= le:
                    idx = i
                    break
            series["counts"][idx] += 1
            series["sum"] += v
            series["count"] += 1

    def spec(self) -> dict:
        return {**super().spec(), "buckets": list(self.buckets)}

    def same_spec(self, other: "_Metric") -> bool:
        return (super().same_spec(other)
                and self.buckets == getattr(other, "buckets", None))

    def series(self) -> list[dict]:
        with self._lock:
            out = []
            for key, series in sorted(self._series.items()):
                cum, cums = 0, []
                for c in series["counts"]:
                    cum += c
                    cums.append(cum)
                out.append({"labels": dict(zip(self.label_names, key)),
                            "sum": series["sum"], "count": series["count"],
                            "buckets": [
                                {"le": le, "count": cums[i]}
                                for i, le in enumerate(self.buckets)
                            ] + [{"le": "+Inf", "count": cums[-1]}]})
            return out


class Registry:
    """A named collection of metrics with deterministic export.

    ``clock`` is any zero-arg monotonic-seconds callable (tests inject the
    shared ``FakeClock``); it stamps snapshots only — metric values never
    depend on it, so two registries driven identically produce identical
    snapshots regardless of wall time.
    """

    def __init__(self, clock=None):
        self.clock = time.monotonic if clock is None else clock
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            have = self._metrics.get(metric.name)
            if have is not None:
                if not have.same_spec(metric):
                    raise ValueError(
                        f"metric {metric.name!r} re-registered with a "
                        "different spec")
                return have
            self._metrics[metric.name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Iterable[str] = (),
                max_label_sets: int = 64) -> Counter:
        return self._register(Counter(name, help, labels, max_label_sets))

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = (),
              max_label_sets: int = 64) -> Gauge:
        return self._register(Gauge(name, help, labels, max_label_sets))

    def histogram(self, name: str, help: str = "", labels: Iterable[str] = (),
                  buckets: Iterable[float] = DEFAULT_BUCKETS,
                  max_label_sets: int = 64) -> Histogram:
        return self._register(Histogram(name, help, labels, buckets,
                                        max_label_sets))

    def get(self, name: str) -> _Metric:
        try:
            return self._metrics[name]
        except KeyError:
            raise KeyError(f"metric {name!r} is not registered") from None

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- exports -----------------------------------------------------------
    def snapshot(self) -> dict:
        """Deterministic plain-dict dump of every metric and series."""
        return {
            "schema": METRICS_SCHEMA,
            "time": float(self.clock()),
            "metrics": [{**m.spec(), "series": m.series()}
                        for _, m in sorted(self._metrics.items())],
        }

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (round-trips via
        :func:`parse_prometheus`)."""
        lines: list[str] = []
        for name, m in sorted(self._metrics.items()):
            if m.help:
                lines.append(f"# HELP {name} {_esc_help(m.help)}")
            lines.append(f"# TYPE {name} {m.kind}")
            for s in m.series():
                base = s["labels"]
                if m.kind == "histogram":
                    for b in s["buckets"]:
                        le = b["le"] if isinstance(b["le"], str) else _fmt(b["le"])
                        lines.append(f"{name}_bucket"
                                     f"{_labelstr({**base, 'le': le})} "
                                     f"{_fmt(b['count'])}")
                    lines.append(f"{name}_sum{_labelstr(base)} {_fmt(s['sum'])}")
                    lines.append(f"{name}_count{_labelstr(base)} "
                                 f"{_fmt(s['count'])}")
                else:
                    lines.append(f"{name}{_labelstr(base)} {_fmt(s['value'])}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labelstr(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def parse_prometheus(text: str) -> dict[tuple[str, tuple[tuple[str, str], ...]], float]:
    """Parse text exposition back into ``{(name, sorted label items): value}``.

    Supports exactly the subset :meth:`Registry.to_prometheus` emits
    (which is the standard sample-line grammar without timestamps) — the
    round-trip the CI obs smoke asserts.  Raises ``ValueError`` on any
    malformed sample line.
    """
    out: dict[tuple[str, tuple[tuple[str, str], ...]], float] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        name, labels, rest = _parse_sample(line, lineno)
        try:
            value = float(rest)
        except ValueError:
            raise ValueError(f"line {lineno}: bad sample value {rest!r}") from None
        out[(name, tuple(sorted(labels.items())))] = value
    return out


def _parse_sample(line: str, lineno: int):
    brace = line.find("{")
    if brace < 0:
        parts = line.split()
        if len(parts) != 2:
            raise ValueError(f"line {lineno}: malformed sample {line!r}")
        return _check_name(parts[0], "metric name"), {}, parts[1]
    name = _check_name(line[:brace], "metric name")
    end = line.rfind("}")
    if end < brace:
        raise ValueError(f"line {lineno}: unterminated label set {line!r}")
    labels: dict[str, str] = {}
    body, i = line[brace + 1:end], 0
    while i < len(body):
        eq = body.find("=", i)
        if eq < 0 or body[eq + 1:eq + 2] != '"':
            raise ValueError(f"line {lineno}: malformed labels {body!r}")
        key = _check_name(body[i:eq].strip(), "label name")
        j, val = eq + 2, []
        while j < len(body):
            ch = body[j]
            if ch == "\\" and j + 1 < len(body):
                val.append({"n": "\n", "\\": "\\", '"': '"'}.get(
                    body[j + 1], body[j + 1]))
                j += 2
                continue
            if ch == '"':
                break
            val.append(ch)
            j += 1
        else:
            raise ValueError(f"line {lineno}: unterminated label value")
        labels[key] = "".join(val)
        i = j + 1
        if i < len(body) and body[i] == ",":
            i += 1
    return name, labels, line[end + 1:].strip()
