"""The port's resilience layer against the JAX reference's, schedule for schedule.

Twins of ``tests/test_chaos.py``: the same tiny model (``TINY``: 2 layers,
d_model 32, n_b 8, on the reference's parameters through
``params_from_reference``), the same workloads and the same seeded
``FaultInjector`` schedules drive ``Scheduler.run_continuous`` in both
packages (the port's CPU tensors take the plain kernel versions).  Held
exactly against the reference: each rid's status, ``attempts`` and error
text, the injector's firing ``log``, and the audits.

Greedy tokens are held two ways:

* against the port's own fault-free run, bit for bit, for every ``OK`` /
  ``DEGRADED`` request (the reference suite's chaos property);
* at every position the port served, against the reference: both packages
  are teacher-forced at batch 1 along the port's own tokens; each token must
  be the port's argmax there, and the packages' largest logit gap must stay
  within ``GAP_BEFORE_CLOSE`` until a chunk closes during decode and within
  ``GAP_AFTER_CLOSE`` after.  The packages round their bf16 products after
  different sums, and a chunk closed on K/V one bf16 ulp apart gets
  different low-rank factors (ROADMAP §3), so equal tokens everywhere cannot
  be asked for: a request's tokens must equal the reference's up to its
  first difference, and that difference must fall where the reference's
  top-1/top-2 margin is no more than twice the gap, so rounding explains it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as R  # noqa: E402
import repro_torch.serving as P  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.prefixcache import PrefixCache as RefPrefixCache  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.prefixcache import PrefixCache  # noqa: E402

pytestmark = pytest.mark.chaos

EOS = 3
CAP = 48
# Largest |port - reference| teacher-forced logit, before and after the first
# chunk that closes during decode (measured over this file: 0.059 and 1.84).
GAP_BEFORE_CLOSE = 0.1
GAP_AFTER_CLOSE = 2.0
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)


def small(named):
    pol = named("gear_kcvt4")
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8), rank=2,
                               rank_decode=2)


class Side:
    """One package's model, policy and shared engines (engines are keyed by
    their config, as the reference suite shares them)."""

    def __init__(self, mod, model, params, policy, port: bool):
        self.mod, self.model, self.params, self.policy, self.port = (
            mod, model, params, policy, port)
        self.engines: dict = {}

    def engine(self, key="paged", **over):
        if key not in self.engines:
            kw = dict(batch=2, capacity=CAP, policy=self.policy, eos_id=EOS, layout="paged")
            kw.update(over)
            clock = kw.pop("clock", None)
            extra = {"device": "cpu"} if self.port else {}
            self.engines[key] = self.mod.Engine(self.model, self.params,
                                                self.mod.EngineConfig(**kw), clock=clock, **extra)
        return self.engines[key]

    def requests(self, n=5, seed=0, deadline_s=None):
        rng = np.random.RandomState(seed)
        budgets = [6, 3, 9, 1, 5, 7, 2][:n]
        return [self.mod.Request(rid=i, tokens=rng.randint(4, 64, size=rng.randint(2, 9)),
                                 max_new_tokens=b, deadline_s=deadline_s)
                for i, b in enumerate(budgets)]

    def drive(self, engine, faults=None, retry=None, valve=None, clock=None, reqs=None):
        engine.attach_faults(None)          # drop any injector a prior run wired
        sched = self.mod.Scheduler(engine, retry=retry or self.mod.RetryPolicy(max_attempts=2),
                                   valve=valve, faults=faults, clock=clock)
        for r in (reqs if reqs is not None else self.requests()):
            sched.submit(r)
        return sched, sched.run_continuous()


class Pair:
    def __init__(self):
        ref_model = ref_build_model(RefModelConfig(**TINY))
        ref_params = ref_model.init(jax.random.PRNGKey(0))
        cfg = ModelConfig(**TINY)
        params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        self.ref = Side(R, ref_model, ref_params, small(ref_named_policy), port=False)
        self.port = Side(P, build_model(cfg), params, small(named_policy), port=True)
        pol = self.ref.policy
        self._ref_prefill = jax.jit(lambda p, t: ref_model.prefill(p, {"tokens": t}, pol, CAP))
        self._ref_decode = jax.jit(lambda p, t, c, pos: ref_model.decode_step(
            p, {"tokens": t}, c, pos, pol, CAP))
        self._along: dict = {}

    def sides(self):
        return (("ref", self.ref), ("port", self.port))

    def along(self, prompt: np.ndarray, tokens: np.ndarray) -> tuple:
        """(reference logits, port logits) [T, V] at each position of
        ``tokens`` (a greedy stream from ``prompt``), teacher-forced at batch 1."""
        key = (tuple(int(t) for t in prompt), tuple(int(t) for t in tokens))
        if key not in self._along:
            logits, caches = self._ref_prefill(self.ref.params, jnp.asarray(prompt[None]))
            plogits, pcaches = self.port.model.prefill(self.port.params,
                                                       {"tokens": prompt[None]},
                                                       self.port.policy, CAP)
            ref, port = [], []
            for i in range(len(tokens)):
                ref.append(np.asarray(logits[0, -1].astype(jnp.float32)))
                port.append(plogits[0, -1].float().numpy())
                if i + 1 < len(tokens):
                    tok, pos = int(tokens[i]), len(prompt) + i
                    logits, caches = self._ref_decode(
                        self.ref.params, jnp.asarray([[tok]], jnp.int32), caches,
                        jnp.asarray([pos], jnp.int32))
                    plogits, pcaches = self.port.model.decode_step(
                        self.port.params, {"tokens": np.array([[tok]])}, pcaches,
                        np.array([pos]), self.port.policy, CAP)
            V = self.port.model.cfg.vocab_size
            self._along[key] = (np.reshape(ref, (-1, V)), np.reshape(port, (-1, V)))
        return self._along[key]

    def first_close(self, prompt_len: int) -> int:
        """Index of the first logits row computed after a chunk closed during
        decode (row i follows the token at position prompt_len + i - 1)."""
        nb = self.port.policy.buffer_size
        return nb - prompt_len % nb


@pytest.fixture(scope="module")
def pair():
    return Pair()


def by_rid(results):
    return {r.rid: r for r in results}


def outcome(results) -> dict:
    return {r.rid: (str(r.status), r.attempts, r.error) for r in results}


def compare_tokens(pair, prompts: dict, ref: dict, port: dict, poisoned=()) -> int:
    """The token rule of the module docstring over every rid but the
    ``poisoned`` ones (decoded from poisoned caches, which no clean
    teacher-forced run reproduces); returns the tokens equal to the
    reference's before each request's first difference."""
    shared = 0
    for rid, want in ref.items():
        if rid in poisoned:
            continue
        want, got = np.asarray(want.tokens), np.asarray(port[rid].tokens)
        prompt = np.asarray(prompts[rid], np.int32)
        rlog, plog = pair.along(prompt, got)
        gaps = np.abs(rlog - plog).max(-1)
        limit = np.where(np.arange(len(got)) < pair.first_close(len(prompt)),
                         GAP_BEFORE_CLOSE, GAP_AFTER_CLOSE)
        assert (gaps <= limit).all(), f"rid {rid}: gaps {gaps} over {limit}"
        np.testing.assert_array_equal(got, plog.argmax(-1), err_msg=f"rid {rid}")
        m = min(len(got), len(want))
        diff = np.flatnonzero(got[:m] != want[:m])
        if diff.size:
            n = diff[0]
            top2 = np.sort(rlog[n])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[n], f"rid {rid} token {n}: {got} vs {want}"
        else:
            n = m
            np.testing.assert_array_equal(got, want, err_msg=f"rid {rid}")
        shared += n
    return shared


def run_both(pair, key="paged", over=None, faults=None, reqs_kw=None, drive_kw=None):
    """Drive the same schedule through both packages.  ``faults(side)`` builds
    each side's injector; ``drive_kw(side)`` extra Scheduler knobs.  Returns
    {side: (scheduler, results, injector, engine)}."""
    out = {}
    for name, side in pair.sides():
        eng = side.engine(key, **(over or {}))
        inj = faults(side) if faults else None
        reqs = side.requests(**(reqs_kw or {}))
        sched, results = side.drive(eng, faults=inj, reqs=reqs,
                                    **(drive_kw(side) if drive_kw else {}))
        out[name] = (sched, results, inj, eng)
    return out


def assert_same_outcomes(pair, got, reqs_kw=None, check_tokens=True, poisoned=()) -> int:
    """Statuses, attempts, errors and the injector log exactly; audits clean;
    tokens by the rule of the module docstring.  Returns the tokens equal to
    the reference's before each request's first difference."""
    (rs, rres, rinj, _), (ps, pres, pinj, _) = got["ref"], got["port"]
    assert len(pres) == len(rres)
    assert outcome(pres) == outcome(rres)
    if rinj is not None:
        assert pinj.log == rinj.log
        assert pinj.fired == rinj.fired and pinj.visits == rinj.visits
    assert rs.audit(rres)["ok"]
    rep = ps.audit(pres)
    assert rep["ok"], rep["issues"]
    if not check_tokens:
        return 0
    prompts = {r.rid: r.tokens for r in pair.port.requests(**(reqs_kw or {}))}
    return compare_tokens(pair, prompts, by_rid(rres), by_rid(pres), poisoned)


def clean_port(pair, seed=0) -> dict:
    _, results = pair.port.drive(pair.port.engine(), reqs=pair.port.requests(seed=seed))
    return by_rid(results)


# ---------------------------------------------------------------------------
# fault-free lifecycle


def test_faultfree_all_ok_and_audit_clean(pair):
    got = run_both(pair)
    shared = assert_same_outcomes(pair, got)
    sched, results = got["port"][0], got["port"][1]
    assert [r.status for r in results].count(P.RequestStatus.OK) == len(results) == 5
    assert all(r.attempts == 1 for r in results)
    assert sched.last_stats["statuses"] == {"ok": 5}
    assert shared >= 8, shared


# ---------------------------------------------------------------------------
# bounded retries under pool pressure


def test_injected_pool_exhaustion_bounds_retries(pair):
    got = run_both(pair, faults=lambda s: s.mod.FaultInjector(
        seed=0, rates={"pool_exhausted": 1.0}, clock=s.mod.FakeClock()),
        drive_kw=lambda s: {"retry": s.mod.RetryPolicy(max_attempts=3, backoff_s=0.1)})
    assert_same_outcomes(pair, got)
    results, inj = got["port"][1], got["port"][2]
    assert all(r.status is P.RequestStatus.REJECTED and r.attempts == 3 and r.tokens.size == 0
               for r in results)
    assert inj.clock.now() == got["ref"][2].clock.now() > 0.0   # backoff ran on the fake clock


def test_transient_pool_pressure_completes_degraded(pair):
    clean = clean_port(pair)
    got = run_both(pair, faults=lambda s: s.mod.FaultInjector(
        seed=0, schedule=[s.mod.FaultEvent("pool_exhausted", 0)], clock=s.mod.FakeClock()),
        drive_kw=lambda s: {"retry": s.mod.RetryPolicy(max_attempts=3)})
    assert_same_outcomes(pair, got)
    res = by_rid(got["port"][1])
    assert res[0].status is P.RequestStatus.DEGRADED and res[0].attempts == 2
    for rid, r in clean.items():
        np.testing.assert_array_equal(res[rid].tokens, r.tokens)


def test_reclaim_valve_rejects_after_bounded_attempts(pair):
    """Every slot idle and the head still does not fit, with a reclaim valve
    that frees nothing (a fully pinned trie): the head ends REJECTED after
    ``max_attempts``, the run goes on and nothing raises.  Both packages'
    ``reclaim_pages`` are stubbed to free nothing and an outside holder
    keeps 2 of the pool's 5 pages: request 0 needs 4 pages and can never be
    admitted, request 1 needs 3 and is served after it."""
    got = {}
    for name, side in pair.sides():
        eng = side.engine("paged_small", pool_pages=6)
        eng.reclaim_pages = lambda n: 0
        real_new_view = type(eng).new_view

        def new_view(eng=eng, real=real_new_view):
            view = real(eng)
            for p in (5, 4):                 # an outside holder of 2 pages
                eng.pool._free.remove(p)
                eng.pool._refs[p] = 1
            return view

        eng.new_view = new_view
        reqs = [side.mod.Request(rid=0, tokens=np.arange(4, 12), max_new_tokens=22),
                side.mod.Request(rid=1, tokens=np.arange(4, 20), max_new_tokens=2)]
        clk = side.mod.FakeClock()
        sched, results = side.drive(eng, reqs=reqs, clock=clk,
                                    retry=side.mod.RetryPolicy(max_attempts=3, backoff_s=0.5))
        got[name] = (outcome(results), clk.now())
        for p in (5, 4):
            eng.pool._refs[p] = 0
            eng.pool._free.append(p)
    assert got["port"] == got["ref"]
    statuses = got["port"][0]
    assert statuses[0][:2] == ("rejected", 3) and "reclaim freed nothing" in statuses[0][2]
    assert statuses[1][0] == "ok"
    assert got["port"][1] == 1.5                 # backoff 0.5 + 1.0 on the fake clock


# ---------------------------------------------------------------------------
# numeric quarantine


def test_nan_quarantine_isolates_one_request(pair):
    clean = clean_port(pair)
    got = run_both(pair, faults=lambda s: s.mod.FaultInjector(
        seed=0, schedule=[s.mod.FaultEvent("nan_chunk", 1)]))
    assert_same_outcomes(pair, got)
    res = by_rid(got["port"][1])
    assert res[1].status is P.RequestStatus.FAILED and "quarantine" in res[1].error
    assert res[1].tokens.size == 0
    for rid, r in clean.items():
        if rid != 1:
            assert res[rid].status is P.RequestStatus.OK
            np.testing.assert_array_equal(res[rid].tokens, r.tokens)


@pytest.mark.parametrize("visit", [1, 4])
def test_numeric_guard_off_lets_nan_through(pair, visit):
    """With ``numeric_guard=False`` the poisoned request is not quarantined
    and its garbage stays in its own slot.  Visit 1 poisons a scale no step
    reads (request 1's prompt closes no chunk; decode rewrites it); visit 4
    poisons one request 4 decodes over: its tokens after the first are the
    reference's, bit for bit, from NaN logits in both."""
    got = run_both(pair, key="paged_noguard", over={"numeric_guard": False},
                   faults=lambda s: s.mod.FaultInjector(
                       seed=0, schedule=[s.mod.FaultEvent("nan_chunk", visit)]))
    assert_same_outcomes(pair, got, poisoned=(visit,))
    res, ref = by_rid(got["port"][1]), by_rid(got["ref"][1])
    assert all(r.status is P.RequestStatus.OK for r in res.values())
    np.testing.assert_array_equal(res[visit].tokens, ref[visit].tokens)


@pytest.mark.parametrize("arch", ["llama2-7b", "hymba-1.5b", "rwkv6-3b"])
def test_corrupt_tree_poisons_the_reference_leaf(arch):
    """``corrupt_tree`` poisons element 0 of the leaf the reference's
    ``tree_flatten`` visits first, on a clone: the same field of layer 0."""
    from repro.configs import smoke_config as ref_smoke_config
    from repro_torch.configs import smoke_config

    pol = "gear_kcvt4"
    ref_caches = ref_build_model(ref_smoke_config(arch)).init_caches(ref_named_policy(pol), 1, 128)
    path, leaf = next((p, x) for p, x in jax.tree_util.tree_flatten_with_path(ref_caches)[0]
                      if jnp.issubdtype(x.dtype, jnp.inexact))
    want = jax.tree_util.keystr(path).split(".")[-1]
    caches = build_model(smoke_config(arch)).init_caches(named_policy(pol), 1, 128, device="cpu")
    before = [[t for part in (c if isinstance(c, tuple) else (c,))
               for t in part.tensors().values()] for c in caches]
    inj = P.FaultInjector(schedule=[P.FaultEvent("nan_chunk", 0)])
    out = inj.corrupt_tree(caches)
    hit = [(i, name, t) for i, c in enumerate(out) for part in (c if isinstance(c, tuple) else (c,))
           for name, t in part.tensors().items()
           if t.is_floating_point() and bool(torch.isnan(t).any())]
    assert [(i, name) for i, name, _ in hit] == [(0, want)]
    t = hit[0][2]
    assert tuple(t.shape) == tuple(leaf.shape[1:]) and torch.isnan(t).sum() == 1
    assert bool(torch.isnan(t[(0,) * t.dim()]))
    assert not any(bool(torch.isnan(x).any()) for layer in before for x in layer
                   if x.is_floating_point())                # the original leaf is untouched


# ---------------------------------------------------------------------------
# engine-step faults


def test_prefill_fault_retries_then_degraded(pair):
    clean = clean_port(pair)
    got = run_both(pair, faults=lambda s: s.mod.FaultInjector(
        seed=0, schedule=[s.mod.FaultEvent("prefill_error", 0)], clock=s.mod.FakeClock()),
        drive_kw=lambda s: {"retry": s.mod.RetryPolicy(max_attempts=3)})
    assert_same_outcomes(pair, got)
    res = by_rid(got["port"][1])
    assert res[0].status is P.RequestStatus.DEGRADED
    for rid, r in clean.items():
        np.testing.assert_array_equal(res[rid].tokens, r.tokens)


def test_decode_fault_storm_fails_active_slots(pair):
    got = run_both(pair, faults=lambda s: s.mod.FaultInjector(
        seed=0, rates={"decode_error": 1.0}, clock=s.mod.FakeClock()))
    assert_same_outcomes(pair, got)
    res = by_rid(got["port"][1])
    assert res[3].status is P.RequestStatus.OK                  # budget-1 request
    for r in res.values():
        assert r.status in (P.RequestStatus.OK, P.RequestStatus.FAILED)
        assert r.tokens.size <= 1 if r.status is P.RequestStatus.OK else "decode failed" in r.error


# ---------------------------------------------------------------------------
# deadlines and the admission valve


def test_deadline_timeout_while_queued(pair):
    out = {}
    for name, side in pair.sides():
        clk = side.mod.FakeClock()
        eng = side.engine()
        eng.attach_faults(None)
        sched = side.mod.Scheduler(eng, clock=clk)
        for r in side.requests(deadline_s=5.0):
            sched.submit(r)
        clk.advance(10.0)                   # every deadline elapses before the run
        results = sched.run_continuous()
        assert sched.audit(results)["ok"]
        out[name] = outcome(results)
    assert out["port"] == out["ref"]
    assert all(s == "timeout" for s, _, _ in out["port"].values()) and len(out["port"]) == 5


def test_clock_skew_times_out_inflight_requests(pair):
    got = run_both(pair, faults=lambda s: s.mod.FaultInjector(
        seed=0, rates={"clock_skew": 1.0}, skew_s=50.0, clock=s.mod.FakeClock()),
        reqs_kw={"deadline_s": 5.0})
    assert_same_outcomes(pair, got, reqs_kw={"deadline_s": 5.0})
    assert any(r.status is P.RequestStatus.TIMEOUT for r in got["port"][1])


def test_admission_valve_sheds_at_submit(pair):
    got = run_both(pair, drive_kw=lambda s: {"valve": s.mod.AdmissionValve(max_queue=2)})
    assert_same_outcomes(pair, got)
    results = got["port"][1]
    shed = [r for r in results if r.attempts == 0]
    assert len(results) == 5 and len(shed) == 3
    assert all(r.status is P.RequestStatus.REJECTED for r in shed)


# ---------------------------------------------------------------------------
# the trie under eviction and TTL


def test_trie_pin_survives_eviction_and_ttl_then_drains():
    """The reference suite's trie scenario on both packages' PrefixCache:
    the same survivors, the same drain, the same audits."""
    out = {}
    for name, cls, clock in (("ref", RefPrefixCache, R.FakeClock()),
                             ("port", PrefixCache, P.FakeClock())):
        pc = cls(chunk=2, budget_bytes=1 << 20, ttl=10.0, clock=clock)
        a = np.array([1, 2, 3, 4], np.int32)
        b = np.array([5, 6, 7, 8], np.int32)
        pc.insert(a, [np.ones((2, 4), np.float32)] * 2)
        pc.insert(b, [np.ones((2, 4), np.float32)] * 2)
        match = pc.match(a)                 # pin path A (a warm prefill in flight)
        clock.advance(100.0)                # everything is TTL-stale now
        pc.evict_bytes(1 << 30)             # eviction storm mid-flight
        alive = [pc.store.get(nd.handle) is not None for nd in match.nodes]
        steps = [match.n_chunks, alive, pc.match(b).n_chunks, pc.audit()["ok"]]
        pc.release(match)
        steps += [pc.match(a).n_chunks, pc.trie.n_nodes, len(pc.trie.pending_free),
                  len(pc.store), pc.audit()["ok"]]
        out[name] = steps
    assert out["port"] == out["ref"] == [2, [True, True], 0, True, 0, 0, 0, 0, True]


def test_chaos_with_prefix_cache_trie_eviction_midflight(pair):
    """Paged + prefix-cache engine under forced trie eviction and TTL skew:
    the same outcomes and firing log as the reference, audits clean."""
    over = dict(prefix_cache=True, prefix_cache_bytes=1 << 16, prefix_cache_ttl=30.0,
                prefill_mode="streaming")
    out = {}
    for name, side in pair.sides():
        clk = side.engines.setdefault("paged_prefix.clock", side.mod.FakeClock())
        eng = side.engine("paged_prefix", clock=clk, **over)
        inj = side.mod.FaultInjector(seed=2, rates={"trie_evict": 0.5, "clock_skew": 0.3},
                                     skew_s=40.0, clock=clk)
        reqs = side.requests(seed=1) + [
            side.mod.Request(rid=10 + i, tokens=np.asarray(r.tokens),
                             max_new_tokens=r.max_new_tokens)
            for i, r in enumerate(side.requests(seed=1)[:3])]   # warm repeats
        sched, results = side.drive(eng, faults=inj, reqs=reqs)
        rep = sched.audit(results)
        assert rep["ok"], rep["issues"]
        out[name] = (outcome(results), inj.log, sched.last_stats["prefix_evictions"])
    assert out["port"] == out["ref"]
    assert len(out["port"][0]) == 8


# ---------------------------------------------------------------------------
# seeded schedule sweep


@pytest.mark.parametrize("seed,p_pool,p_nan,p_dec", [
    (0, 0.0, 0.0, 0.0),
    (1, 0.4, 0.0, 0.0),
    (2, 0.0, 0.4, 0.0),
    (3, 0.0, 0.0, 0.3),
    (4, 0.3, 0.3, 0.2),
])
def test_chaos_schedule_invariants_seeded(pair, seed, p_pool, p_nan, p_dec):
    clean = clean_port(pair, seed=3)
    got = run_both(pair, faults=lambda s: s.mod.FaultInjector(
        seed=seed, clock=s.mod.FakeClock(),
        rates={"pool_exhausted": p_pool, "nan_chunk": p_nan, "decode_error": p_dec}),
        reqs_kw={"seed": 3},
        drive_kw=lambda s: {"retry": s.mod.RetryPolicy(max_attempts=2, backoff_s=0.01)})
    assert_same_outcomes(pair, got, reqs_kw={"seed": 3})
    eng = got["port"][3]
    assert eng.pool.audit()["ok"]
    for r in got["port"][1]:
        if r.status in (P.RequestStatus.OK, P.RequestStatus.DEGRADED):
            np.testing.assert_array_equal(r.tokens, clean[r.rid].tokens)


# ---------------------------------------------------------------------------
# the auditor and the injector


def test_pool_audit_catches_manufactured_leak():
    """The same admit / retain / release sequence on both pools: the same
    reports at every step, and the leak caught."""
    reports = {}
    for name, mod in (("ref", R), ("port", P)):
        pool = mod.PagePool(n_pages=6, batch=2, n_chunks=4, page_bytes=128)
        pool.admit(0, 2)
        rep = [pool.audit(retained=[])]
        page = int(pool.block_tables[0, 0])
        pool.retain(page)                   # a dangling reference with no holder
        rep.append(pool.audit(retained=[]))
        rep.append(pool.audit(retained=[page]))
        pool.release(page)
        pool.release_slot(0)
        rep.append(pool.audit(retained=[]))
        reports[name] = rep
    assert reports["port"] == reports["ref"]
    ok = [r["ok"] for r in reports["port"]]
    assert ok == [True, False, True, True] and reports["port"][-1]["used_pages"] == 0


def test_fault_injector_is_deterministic():
    def mk(mod):
        return mod.FaultInjector(seed=7, rates={"decode_error": 0.5, "pool_exhausted": 0.25},
                                 schedule=[mod.FaultEvent("nan_chunk", 2)])
    a, b, ref = mk(P), mk(P), mk(R)
    for _ in range(32):
        for site in ("decode_error", "nan_chunk", "pool_exhausted"):
            assert a.fire(site) == b.fire(site) == ref.fire(site)
    assert a.log == b.log == ref.log
    assert a.fired["nan_chunk"] >= 1
    with pytest.raises(ValueError):
        P.FaultInjector(rates={"bogus": 0.1})
    with pytest.raises(ValueError):
        P.FaultEvent("nan_chunk", -1)


def test_retry_policy_and_valve_match_reference():
    for kw in ({}, {"backoff_s": 0.1}, {"backoff_s": 0.3, "backoff_mult": 3.0,
                                         "max_backoff_s": 2.0}):
        ref, port = R.RetryPolicy(max_attempts=4, **kw), P.RetryPolicy(max_attempts=4, **kw)
        assert [port.backoff(i) for i in range(6)] == [ref.backoff(i) for i in range(6)]
    for q in (None, 0, 2):
        assert ([P.AdmissionValve(q).shed(n) for n in range(4)]
                == [R.AdmissionValve(q).shed(n) for n in range(4)])
    with pytest.raises(ValueError):
        P.RetryPolicy(max_attempts=0)


def test_pool_bytes_sizes_the_pool_as_the_reference(pair):
    """``EngineConfig.pool_bytes``: pool_bytes // page_bytes + 1 pages (the
    zero page included), exclusive with ``pool_pages``, paged only; the
    same page size and page count as the reference's engine."""
    page = pair.port.engine()._page_bytes
    assert page == pair.ref.engine()._page_bytes
    for budget in (2 * page, 3 * page + page // 2, 7 * page - 1):
        got = [side.engine(f"bytes{budget}", pool_bytes=budget)._n_pages
               for _, side in pair.sides()]
        assert got[0] == got[1] == budget // page + 1
    for side in (P, R):
        with pytest.raises(ValueError, match="not both"):
            side.EngineConfig(batch=2, capacity=CAP, policy=pair.port.policy if side is P
                              else pair.ref.policy, layout="paged", pool_pages=4,
                              pool_bytes=page)
        with pytest.raises(ValueError, match="only apply to layout='paged'"):
            side.EngineConfig(batch=2, capacity=CAP, policy=pair.port.policy if side is P
                              else pair.ref.policy, pool_bytes=page)
    with pytest.raises(ValueError, match="cannot hold page 0"):
        pair.port.engine("bytes_small", pool_bytes=page - 1)
