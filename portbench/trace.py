"""The traced run: device intervals from the profiler, host ranges from the
harness, and their reduction to busy time, idle gaps and the leading
device operations.

The profiler records CUDA activity only (kernels, copies, sets): a whole
wave issues hundreds of thousands of launches, and recording every host op
beside them would slow the host path the cells measure and take minutes to
read.  The host side is the harness's own ranges around the calls it makes
into the engine (:class:`HostMarks`), taken on the same wall clock the
profiler stamps its events with (``time.time_ns``).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


class HostMarks:
    """Named host ranges (name, start ns, end ns, level) in call order; a
    range of level 1 lies inside one of level 0, and ranges of one level do
    not overlap."""

    def __init__(self):
        self.ranges: list[tuple[str, int, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str, level: int = 0):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.ranges.append((name, t0, time.time_ns(), level))

    def durations(self, name: str) -> list[float]:
        """Seconds of every range called ``name``."""
        return [(t1 - t0) / 1e9 for n, t0, t1, _ in self.ranges if n == name]


@contextlib.contextmanager
def device_profile():
    """A ``torch.profiler`` session over CUDA activity; yields a list that
    holds the device events (name, start ns, duration ns) once it closes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out: list = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield out
        torch.cuda.synchronize()
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation():
            out.append((e.name(), e.start_ns(), e.duration_ns()))


def union(events: list) -> np.ndarray:
    """Disjoint [start, end) ns intervals covered by ``events``, sorted."""
    if not events:
        return np.zeros((0, 2), dtype=np.int64)
    s = np.fromiter((e[1] for e in events), dtype=np.int64, count=len(events))
    e = s + np.fromiter((e[2] for e in events), dtype=np.int64, count=len(events))
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.ones(len(s), dtype=bool)
    new[1:] = s[1:] > e[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return np.stack([s[first], e[last]], axis=1)


def busy_ns(intervals: np.ndarray, t0: int, t1: int) -> int:
    """Nanoseconds of [t0, t1) covered by ``intervals``."""
    if len(intervals) == 0:
        return 0
    s = np.clip(intervals[:, 0], t0, t1)
    e = np.clip(intervals[:, 1], t0, t1)
    return int((e - s).sum())


def gaps(intervals: np.ndarray, t0: int, t1: int) -> np.ndarray:
    """Idle [start, end) ns stretches of [t0, t1) between ``intervals``."""
    iv = np.clip(intervals, t0, t1) if len(intervals) else intervals.reshape(0, 2)
    bounds = np.concatenate([[t0], iv.reshape(-1), [t1]]).reshape(-1, 2)
    keep = bounds[:, 1] > bounds[:, 0]
    return bounds[keep]


def host_ranges_at(ranges: list, times: np.ndarray, default: str = "harness") -> list:
    """Name of the innermost host range open at each of ``times``."""
    names = np.full(len(times), default, dtype=object)
    for level in sorted({r[3] for r in ranges}):
        rs = sorted((r for r in ranges if r[3] == level), key=lambda r: r[1])
        starts = np.array([r[1] for r in rs], dtype=np.int64)
        ends = np.array([r[2] for r in rs], dtype=np.int64)
        idx = np.searchsorted(starts, times, side="right") - 1
        inside = (idx >= 0) & (times < ends[np.maximum(idx, 0)])
        for i in np.flatnonzero(inside):
            names[i] = rs[idx[i]][0]
    return list(names)


def reduce(events: list, ranges: list, t0: int, t1: int, top: int = 10) -> dict:
    """Busy and window seconds of [t0, t1), the ``top`` device operations by
    summed device time, and the idle time summed by the host range open
    when each idle stretch began."""
    iv = union(events)
    by_op: dict = {}
    for name, s, d in events:
        if s < t1 and s + d > t0:
            by_op[name] = by_op.get(name, 0) + d
    idle: dict = {}
    g = gaps(iv, t0, t1)
    for name, (g0, g1) in zip(host_ranges_at(ranges, g[:, 0]), g):
        idle[name] = idle.get(name, 0) + int(g1 - g0)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idl = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy_ns(iv, t0, t1) / 1e9, "window_s": (t1 - t0) / 1e9,
            "device_ops": [[n[:160], v / 1e9] for n, v in ops],
            "idle_gaps": [[n, v / 1e9] for n, v in idl]}
