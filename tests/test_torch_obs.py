"""The port's telemetry (``repro_torch.obs``) and ``core.metrics`` against the
JAX reference's.

* Registry, catalog and tracer: the reference suite's scenarios
  (``tests/test_obs.py``) driven on both packages with a ``FakeClock``
  give equal snapshots, JSON, Prometheus text and Chrome traces, and the
  catalog holds the same metric names, kinds, labels and buckets.
* ``EngineConfig.obs`` coercion and ``sync_counter`` deltas as in the
  reference; ``ObsConfig(fidelity_every_n > 0)`` raises, naming ROADMAP
  queue 1, item 7 (the probes are not ported).
* Serving: obs on ≡ obs off bit for bit (tokens and every cache tensor);
  under seeded fault schedules (the tiny model of
  ``tests/test_torch_resilience.py``) each rid has exactly one finished
  trace with its result's status, and every counter and gauge of the
  registry, and every histogram's observation count, equals the
  reference's (histogram sums of wall-clock seconds differ by nature).
* ``core.metrics``: the analytic KV-size accounting equal to the
  reference's floats; the masked Frobenius reductions within 1e-6 relative.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.obs as RO  # noqa: E402
import repro.serving as R  # noqa: E402
import repro_torch.obs as PO  # noqa: E402
import repro_torch.serving as P  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.core import metrics as ref_metrics  # noqa: E402
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.obs.catalog import METRICS as REF_METRICS  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import metrics  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs.catalog import METRICS, build_registry  # noqa: E402

pytestmark = pytest.mark.obs

EOS = 3
CAP = 48
TINY = dict(name="tiny-obs", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
PKGS = (("ref", RO, R), ("port", PO, P))


def small(named):
    pol = named("gear_kcvt4")
    return dataclasses.replace(pol, buffer_size=8, group=8, rank=2, rank_decode=2)


def both(fn) -> dict:
    """``fn(obs package, serving package)`` on each side."""
    return {name: fn(obs, srv) for name, obs, srv in PKGS}


# ---------------------------------------------------------------------------
# registry


def registry_scenario(obs, srv):
    """The reference suite's counter / gauge / histogram / cardinality /
    re-registration scenarios on one registry under a fake clock."""
    clock = srv.FakeClock(100.0)
    r = obs.Registry(clock=clock)
    c = r.counter("reqs_total", "requests", labels=("status",))
    c.inc(status="ok")
    c.inc(2.0, status="ok")
    c.inc(status="failed")
    errors = []
    for bad in (lambda: c.inc(-1.0, status="ok"), lambda: c.inc(shard="0"),
                lambda: r.histogram("bad_seconds", "x", buckets=(2.0, 1.0)),
                lambda: r.counter("reqs_total", "requests", labels=("b",)),
                lambda: r.gauge("reqs_total", "requests", labels=("status",)),
                lambda: r.get("unregistered")):
        try:
            bad()
        except (ValueError, KeyError) as e:
            errors.append(type(e).__name__)
    g = r.gauge("depth", "queue depth")
    g.set(4)
    g.dec()
    bounded = r.counter("c_total", "bounded", labels=("rid",), max_label_sets=3)
    for i in range(3):
        bounded.inc(rid=str(i))
    try:
        bounded.inc(rid="explodes")
    except obs.CardinalityError:
        errors.append("CardinalityError")
    h = r.histogram("lat_seconds", "latency", buckets=(1.0, 2.0, 5.0))
    for v in (1.0, 1.0000001, 2.0, 5.0, 7.0):
        h.observe(v)
        clock.advance(1.0)
    hostile = r.counter("h_total", 'he says "hi"\nand leaves', labels=("path",))
    hostile.inc(3, path='a"b\\c\nd')
    assert r.counter("reqs_total", "requests", labels=("status",)) is c
    return {"json": r.to_json(), "prom": r.to_prometheus(), "errors": errors,
            "parsed": obs.parse_prometheus(r.to_prometheus()), "snapshot": r.snapshot(),
            "names": r.names(), "contains": ("depth" in r, "nope" in r)}


def test_registry_matches_reference():
    got = both(registry_scenario)
    assert got["port"] == got["ref"]
    snap = got["port"]["snapshot"]
    assert snap["schema"] == "gear-repro/metrics/v1" and snap["time"] == 105.0
    assert got["port"]["errors"] == ["ValueError"] * 5 + ["KeyError", "CardinalityError"]
    lat = next(m for m in snap["metrics"] if m["name"] == "lat_seconds")["series"][0]
    assert {b["le"]: b["count"] for b in lat["buckets"]} == {1.0: 1, 2.0: 3, 5.0: 4, "+Inf": 5}
    parsed = got["port"]["parsed"]
    assert parsed[("h_total", (("path", 'a"b\\c\nd'),))] == 3.0
    with pytest.raises(ValueError):
        PO.parse_prometheus("not a sample line at all{")


def test_catalog_matches_reference():
    assert [dataclasses.astuple(m) for m in METRICS] == [dataclasses.astuple(m)
                                                          for m in REF_METRICS]
    reg = build_registry()
    assert set(reg.names()) == {m.name for m in METRICS}
    for m in METRICS:
        assert reg.get(m.name).kind == m.kind
        assert tuple(reg.get(m.name).label_names) == tuple(m.labels)
    fresh = lambda pkg: pkg.build_registry(clock=lambda: 0.0).to_json()      # noqa: E731
    assert fresh(PO) == fresh(RO)


# ---------------------------------------------------------------------------
# tracer


def tracer_scenario(obs, srv):
    clock = srv.FakeClock()
    tr = obs.Tracer(clock=clock)
    tr.start(7)
    tr.begin(7, "queued")
    clock.advance(1.0)
    tr.end(7)
    tr.begin(7, "prefill", attempt=1)
    tr.event(7, "fault", site="nan_chunk")
    clock.advance(2.0)
    tr.end(7)
    tr.step(7)
    tr.step(7)
    tr.finish(7, "ok")
    for f in (lambda: tr.begin(99, "x"), lambda: tr.end(99), lambda: tr.event(99, "y"),
              lambda: tr.step(99), lambda: tr.finish(99, "ok"), lambda: tr.annotate(x=1),
              lambda: tr.event_bound("nope")):
        f()                                  # unknown rids and unbound calls: no-ops
    tr.start(1)
    tr.start(1)                              # resubmit: the old trace kept as evidence
    tr.finish(1, "ok")
    tr.start(2)
    tr.begin(2, "prefill")
    tr.bind(2)
    tr.annotate(bucket_tokens=16)
    with tr.span_bound("splice"):
        clock.advance(0.5)
    tr.event_bound("quarantine")
    tr.unbind()
    tr.end(2)
    tr.add_span(2, "decode", 0.25, steps=3)
    tr.finish(2, "failed")
    off = obs.Tracer(enabled=False)
    off.start(5)
    off.finish(5, "ok")
    return {"chrome": tr.to_json(), "coverage": [tr.coverage(r) for r in ([7], [1], [2, 3])],
            "traces": [t.as_dict() for t in tr.completed],
            "off": (off.completed, off.active)}


def test_tracer_matches_reference():
    got = both(tracer_scenario)
    assert got["port"] == got["ref"]
    doc = json.loads(got["port"]["chrome"])
    assert doc["schema"] == "gear-repro/trace/v1"
    req = next(e for e in doc["traceEvents"] if e["name"] == "request" and e["tid"] == 7)
    assert req["args"]["decode_steps"] == 2 and req["dur"] == pytest.approx(3e6)
    cov7, cov1, cov23 = got["port"]["coverage"]
    assert cov7["complete"] and not cov1["complete"] and cov1["duplicates"] == [1]
    assert cov23["missing"] == [3]


def test_profiler_span_is_a_record_function():
    with PO.profiler_span("gear.decode", True) as span:
        pass
    assert span is not None
    with PO.profiler_span("gear.decode", False) as span:
        assert span is None


# ---------------------------------------------------------------------------
# config plumbing


def test_engineconfig_obs_coercion():
    kw = dict(batch=1, capacity=32, policy=small(named_policy))
    assert P.EngineConfig(**kw).obs is None
    assert P.EngineConfig(**kw, obs=False).obs is None
    assert P.EngineConfig(**kw, obs=True).obs == PO.ObsConfig()
    assert P.EngineConfig(**kw, obs={"profiler": True}).obs == PO.ObsConfig(profiler=True)
    with pytest.raises(ValueError):
        P.EngineConfig(**kw, obs=42)
    with pytest.raises(ValueError):
        PO.ObsConfig(fidelity_every_n=-1)
    with pytest.raises(ValueError):
        PO.ObsConfig(fidelity_budget_frac=0.0)
    assert dataclasses.asdict(PO.ObsConfig()) == dataclasses.asdict(RO.ObsConfig())


@pytest.mark.parametrize("make", [lambda: PO.ObsConfig(fidelity_every_n=1),
                                  lambda: P.EngineConfig(batch=1, capacity=32,
                                                         policy=small(named_policy),
                                                         obs={"fidelity_every_n": 4})],
                         ids=["ObsConfig", "EngineConfig-dict"])
def test_fidelity_probes_raise_naming_item_7(make):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 7"):
        make()


def test_sync_counter_delta_and_reset_clamp():
    def run(obs, srv):
        o = obs.Observability(obs.ObsConfig(), clock=srv.FakeClock())
        o.sync_counter("pool_admits_total", 5)
        o.sync_counter("pool_admits_total", 8)
        a = o.registry.get("pool_admits_total").value()
        o.sync_counter("pool_admits_total", 2)       # a rebuilt pool restarts at 0
        return a, o.registry.get("pool_admits_total").value(), o.to_json()
    got = both(run)
    assert got["port"] == got["ref"]
    assert got["port"][:2] == (8.0, 10.0)


# ---------------------------------------------------------------------------
# serving


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(RefModelConfig(**TINY))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return {"ref": (ref_model, ref_params), "port": (build_model(cfg), params)}


def requests(srv, n=5, seed=0):
    rng = np.random.RandomState(seed)
    budgets = [6, 3, 9, 1, 5, 7, 2][:n]
    return [srv.Request(rid=i, tokens=rng.randint(4, 64, size=rng.randint(2, 9)),
                        max_new_tokens=b) for i, b in enumerate(budgets)]


def port_engine(models, **kw):
    model, params = models["port"]
    base = dict(batch=2, capacity=CAP, policy=small(named_policy), eos_id=EOS, layout="paged")
    return P.Engine(model, params, P.EngineConfig(**(base | kw)), device="cpu")


def test_obs_on_equals_obs_off_bit_for_bit(models):
    """Telemetry observes only: the same tokens, and every cache tensor of a
    view driven through prefills and decode steps, with it on and off
    (profiler ranges included)."""
    out = {}
    for obs in (None, PO.ObsConfig(profiler=True)):
        eng = port_engine(models, obs=obs)
        sched = P.Scheduler(eng)
        for r in requests(P):
            sched.submit(r)
        toks = {r.rid: r.tokens for r in sched.run_continuous()}
        view = eng.new_view()
        logits = [view.prefill_slot({"tokens": r.tokens[None]}, s, reserve_tokens=20)
                  for s, r in enumerate(requests(P, 2, seed=1))]
        pos = np.array([len(r.tokens) for r in requests(P, 2, seed=1)], np.int32)
        for i in range(4):
            logits.append(view.decode({"tokens": np.full((2, 1), 5 + i, np.int32)}, pos + i))
        caches = [t.clone() for lyr in view.caches for t in lyr.tensors().values()]
        out[obs is not None] = (toks, logits, caches)
        if obs is not None:
            assert eng.obs.registry.get("serving_decode_steps_total").value() > 0
    (t0, l0, c0), (t1, l1, c1) = out[False], out[True]
    assert t0.keys() == t1.keys()
    for rid in t0:
        np.testing.assert_array_equal(t0[rid], t1[rid])
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert len(c0) == len(c1) and all(torch.equal(a, b) for a, b in zip(c0, c1))


def deterministic_view(snapshot: dict) -> dict:
    """Counters and gauges by series, histograms by observation count (their
    sums and buckets of wall-clock seconds are not deterministic), except
    the bucket-size histogram, whose observations are token counts."""
    out = {}
    for m in snapshot["metrics"]:
        for s in m["series"]:
            key = (m["name"], tuple(sorted(s["labels"].items())))
            if m["type"] != "histogram" or m["name"] == "serving_prefill_bucket_tokens":
                out[key] = s.get("value", s.get("sum"))
                if m["type"] == "histogram":
                    out[key + ("count",)] = s["count"]
            else:
                out[key] = s["count"]
    return out


@pytest.fixture(scope="module")
def chaos_engines(models) -> dict:
    """Both packages' telemetry engines, shared by the chaos schedules (each
    schedule gives an engine a fresh ``Observability``)."""
    out = {}
    for name, obs, srv in PKGS:
        model, params = models[name]
        ecfg = srv.EngineConfig(batch=2, capacity=CAP, eos_id=EOS, layout="paged",
                                policy=small(ref_named_policy if name == "ref" else named_policy),
                                obs=obs.ObsConfig())
        out[name] = (srv.Engine(model, params, ecfg) if name == "ref"
                     else srv.Engine(model, params, ecfg, device="cpu"))
    return out


@pytest.mark.parametrize("rates", [
    {"pool_exhausted": 0.3, "nan_chunk": 0.2},
    {"prefill_error": 0.3, "decode_error": 0.15},
    {"pool_exhausted": 0.2, "nan_chunk": 0.1, "decode_error": 0.1, "clock_skew": 0.05},
])
def test_one_trace_per_rid_under_chaos(chaos_engines, rates):
    got = {}
    for name, obs, srv in PKGS:
        eng = chaos_engines[name]
        eng.obs = obs.Observability(obs.ObsConfig())
        clk = srv.FakeClock()
        inj = srv.FaultInjector(seed=11, rates=rates, clock=clk)
        sched = srv.Scheduler(eng, faults=inj, clock=clk,
                              retry=srv.RetryPolicy(max_attempts=2, backoff_s=0.1))
        for r in requests(srv):
            sched.submit(r)
        results = sched.run_continuous()
        cov = eng.obs.tracer.coverage([r.rid for r in requests(srv)])
        assert cov["complete"], cov
        assert cov["statuses"] == {r.rid: str(r.status) for r in results}
        by_status = {s["labels"]["status"]: s["value"]
                     for s in eng.obs.registry.get("serving_results_total").series()}
        assert by_status == {k: float(v) for k, v in sched.last_stats["statuses"].items()}
        assert sched.audit(results)["ok"]
        spans = sorted((t.rid, [s.name for s in t.spans], [e[0] for e in t.events], t.status,
                        t.attempts, t.decode_steps) for t in eng.obs.tracer.completed)
        got[name] = (deterministic_view(eng.obs.snapshot()), spans, inj.log)
    assert got["port"][2] == got["ref"][2]
    assert got["port"][1] == got["ref"][1]
    assert got["port"][0] == got["ref"][0]


# ---------------------------------------------------------------------------
# core/metrics


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2", "outlier_kivi2", "gear_l_kcvt4",
                                     "kivi2", "fp16"])
def test_kv_size_accounting_equals_reference(polname):
    for n, d, heads in ((1000, 4096, 32), (64, 128, 1), (333, 1600, 25)):
        for per_chunk in (False, True):
            for ideal in (False, True):
                kw = dict(num_heads=heads, per_chunk_lowrank=per_chunk, idealized_sparse=ideal)
                want = ref_metrics.kv_size_breakdown(ref_named_policy(polname), n, d, **kw)
                got = metrics.kv_size_breakdown(named_policy(polname), n, d, **kw)
                assert dataclasses.asdict(got) == dataclasses.asdict(want)
                assert got.total == want.total
                assert (metrics.kv_size_fraction(named_policy(polname), n, d, **kw)
                        == ref_metrics.kv_size_fraction(ref_named_policy(polname), n, d, **kw))


def test_masked_reductions_match_reference():
    """Within 1e-6 relative of the exact value (f64 sums of the f32 inputs),
    and of the reference up to the reference's own distance from it: its
    f32 sums are 1.1e-6 off the exact value on the second mask."""
    rng = np.random.RandomState(0)
    ref = rng.randn(4, 64, 32).astype(np.float32)
    approx = (ref + 0.01 * rng.randn(*ref.shape)).astype(np.float32)
    t = torch.from_numpy

    def exact(a, b, mask):
        m = np.broadcast_to(mask, a.shape).astype(np.float64)
        return (np.sqrt((a.astype(np.float64) ** 2 * m).sum())
                / max(np.sqrt((b.astype(np.float64) ** 2 * m).sum()), 1e-12))

    for mask in (np.ones((1, 64, 1), bool), (np.arange(64) < 40)[None, :, None],
                 np.zeros((1, 1, 1), bool)):
        for got, want, truth in (
                (metrics.masked_rel_frobenius(t(approx), t(ref), t(mask)),
                 ref_metrics.masked_rel_frobenius(jnp.asarray(approx), jnp.asarray(ref),
                                                  jnp.asarray(mask)),
                 exact(approx - ref, ref, mask)),
                (metrics.masked_share(t(approx - ref), t(approx), t(mask)),
                 ref_metrics.masked_share(jnp.asarray(approx - ref), jnp.asarray(approx),
                                          jnp.asarray(mask)),
                 exact(approx - ref, approx, mask))):
            got, want = float(got), float(want)
            assert got == pytest.approx(truth, rel=1e-6, abs=1e-12)
            assert abs(got - want) <= 1e-6 * abs(want) + abs(want - truth) + 1e-12
