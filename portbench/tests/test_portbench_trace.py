"""The traced run's reduction on synthetic device events and host ranges."""

import numpy as np
import pytest

from portbench import trace
from portbench.metrics import reader
from portbench.run import Context

# device events (name, start ns, duration ns) and host ranges (name, start, end, level)
EVENTS = [("gemm", 100, 50), ("gemm", 120, 60), ("gear_decode_split<64>", 300, 100),
          ("memcpy", 390, 20), ("flash_prefill_kernel<64>", 700, 200), ("late", 1200, 50)]
RANGES = [("generate", 50, 1000, 0), ("prefill", 60, 250, 1), ("decode", 260, 500, 1),
          ("decode_close", 500, 950, 1)]


def test_union_and_busy():
    iv = trace.union(EVENTS)
    assert iv.tolist() == [[100, 180], [300, 410], [700, 900], [1200, 1250]]
    assert trace.busy_ns(iv, 0, 1000) == 80 + 110 + 200
    assert trace.gaps(iv, 0, 1000).tolist() == [[0, 100], [180, 300], [410, 700], [900, 1000]]
    assert trace.union([]).shape == (0, 2)


def test_reduce_names_idle_time_by_host_range():
    red = trace.reduce(EVENTS, RANGES, 0, 1000)
    assert red["busy_s"] == pytest.approx(390e-9) and red["window_s"] == pytest.approx(1e-6)
    idle = dict(red["idle_gaps"])
    # [0, 100) before any range; [180, 300) opens in prefill; [410, 700) in decode;
    # [900, 1000) in decode_close
    assert idle == pytest.approx({"harness": 100e-9, "prefill": 120e-9, "decode": 290e-9,
                                  "decode_close": 100e-9})
    ops = dict(red["device_ops"])
    assert ops["gemm"] == pytest.approx(110e-9) and "late" not in ops
    assert len(red["device_ops"]) <= 10 and len(red["idle_gaps"]) <= 10
    assert all(isinstance(n, str) and isinstance(v, float) for n, v in red["device_ops"])


def test_host_marks_and_idle_metric():
    marks = trace.HostMarks()
    with marks.span("decode", 1):
        pass
    assert len(marks.durations("decode")) == 1 and marks.durations("prefill") == []
    ctx = Context(model={}, traffic={}, waves=[], window_s=1e-6, marks=marks, events=EVENTS,
                  reduced=trace.reduce(EVENTS, RANGES, 0, 1000))
    assert reader("device_idle_pct")(ctx) == pytest.approx(61.0)
    assert reader("wave_prefill_ms")(ctx) is None and reader("decode_step_ms")(ctx) == \
        pytest.approx(1e3 * marks.durations("decode")[0])


def test_roofline_readers_on_synthetic_kernels():
    from portbench import spec
    from portbench.counts import kernels

    cell = spec.cell("minicpm-2b.batch-decode")
    m, t = cell["config"]["model"], dict(cell["traffic"], new_tokens=3)
    wave = {"tokens": np.zeros((64, 3), np.int32), "stats": {"prefill_s": 2.0,
                                                             "cache_bytes": 2 ** 30}}
    least = sum(40 * kernels.gear_decode_least_s(t["policy"], 64 * 36, 1, 64, n)
                for n in (1920, 1920))
    dev_ns = int(least * 2e9)                    # the kernels took twice their least time
    events = [("void gear_decode_split<64, 1>(...)", 0, dev_ns)]
    ctx = Context(model=m, traffic=t, waves=[wave], window_s=10.0, marks=trace.HostMarks(),
                  events=events, reduced=None)
    assert reader("gear_decode_roofline")(ctx) == pytest.approx(50.0, rel=1e-6)
    assert reader("flash_prefill_roofline")(ctx) is None        # no such kernel: nothing
    assert reader("device_idle_pct")(ctx) is None
    assert reader("wave_prefill_ms")(ctx) == pytest.approx(2000.0)
    assert reader("cache_gib")(ctx) == pytest.approx(1.0)
    assert 0 < reader("mfu_pct")(ctx) < 100
