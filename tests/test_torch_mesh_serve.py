"""Serving on a device mesh over ``torch.distributed`` (gloo, CPU
processes): ``Engine(..., mesh=...)`` against the reference's one-device
engine and the port's one-process engine, the storage each process keeps,
``set_params`` on the mesh and the paged layout's refusal.

The reference's own mesh engine does not run under jax 0.9 (ROADMAP §3 n),
but its rule is "layout, not semantics": a mesh engine serves what the
one-device engine serves.  So the parent draws every case's weights with
the reference's init (``PRNGKey(seed)``), hands the port's copy
(``params_from_reference``) to one spawn of four processes on a 2×2 (data ×
model) mesh, runs the reference's one-device ``Engine`` / ``Scheduler`` on
the same requests while they serve, then the port's one-process CPU engine,
and holds every process's run against both.  Each process rendezvouses
through a ``FileStore`` in ``tmp_path``; the spawn joins with a timeout and
kills its children when it runs out, so a hung collective fails here.

* The reference's mesh case (``tests/test_distributed.py::test_serving_on_mesh``):
  minicpm-2b smoke, gear_kcvt4 with ``buffer_size`` 16, batch 4, capacity
  96, 24-token prompts, ``generate(..., 8)``.
* ``Scheduler.run_continuous`` on mixed-length requests for minicpm-2b
  (4 KV heads: 2 a process), rwkv6-3b (its per-head state split over
  ``model``) and hymba-1.5b (2 KV heads on a model axis of 2; its SSM state
  whole).

The rule (the margin rule of ROADMAP §3 g, slot by slot): both engines log
the logits of every prefill and decode call in order; each logged row lies
within a tolerance of the other engine's, and the two argmaxes are equal
wherever the other engine's top-1/top-2 margin exceeds twice that.  A slot
may leave the other's tokens only at a row under that margin (at these
widths the bf16 logits often tie: margin 0), and its rows are skipped
until its next prefill.  The tolerance is ``REF_LOGIT_ATOL`` against the
reference (bf16 products summed in another order, K/V compressed an ulp
apart: §3 g) and ``LOGIT_ATOL`` against the port's one-process engine (the
same arithmetic on a view of the rows and heads).  The smoke configs'
logits have a standard deviation of about 1.0 and magnitudes up to about 7.
The stored parameter and cache bytes equal those the spec trees give,
exactly, and a forward holds one layer's gathered weights at a time.
In-process, a 1 × 1 mesh gives the one-device engine's tokens, logits and
caches bit for bit.

A child imports this module, so it imports JAX only inside the parent's
functions.
"""

import dataclasses
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each

import torch.distributed as dist  # noqa: E402

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import axis_sizes, make_test_mesh  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.perf.comm_stats import CollectiveCounter  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, Request, Scheduler  # noqa: E402

TESTS = pathlib.Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
SPAWN_TIMEOUT = 240.0
LOGIT_ATOL = 0.05
# largest gap to the reference over the compared rows: 0.082 (rwkv6-3b)
REF_LOGIT_ATOL = 0.125
POLICY = dataclasses.replace(named_policy("gear_kcvt4"), buffer_size=16)
WAVE = dict(batch=4, capacity=96, policy=POLICY)
CONT_ARCHS = ("minicpm-2b", "rwkv6-3b", "hymba-1.5b")
# the weights every case serves: (arch, reference init seed)
WEIGHTS = (("minicpm-2b", 0), ("minicpm-2b", 1), ("rwkv6-3b", 0), ("hymba-1.5b", 0))
PAGED_WORDS = ("paged layout is single-host for now: the block tables are engine-owned host "
               "state (ROADMAP: sharded pool)")


def wave_batch(cfg) -> dict:
    return {"tokens": np.random.RandomState(1).randint(0, cfg.vocab_size, (4, 24)).astype(np.int32)}


def requests(cfg, request=Request) -> list:
    """Six requests of three lengths (12, 26 and 40 tokens: 0, 1 and 2
    chunks closed in prefill, one more during decode), 6–10 new tokens each
    (``request``: the port's class or the reference's)."""
    rng = np.random.RandomState(7)
    return [request(rid=i, tokens=rng.randint(0, cfg.vocab_size, 12 + 14 * (i % 3)).astype(
        np.int32), max_new_tokens=6 + i % 5) for i in range(6)]


def _f32(logits) -> np.ndarray:
    """A torch tensor's or a JAX array's values as f32 numpy."""
    if isinstance(logits, torch.Tensor):
        return logits.float().cpu().numpy()
    return np.asarray(logits).astype(np.float32)


def logged(eng) -> list:
    """Wrap ``eng``'s (the port's or the reference's) prefill and decode
    entry points so that each call lands in the returned list as (its name,
    its logits as f32 numpy rows, the batch slot of each row)."""
    log = []
    for name in ("prefill", "prefill_slot", "decode"):
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            logits, caches = _fn(*a, **k)
            rows = _f32(logits).reshape(logits.shape[0], -1)
            slots = [a[2]] if _name == "prefill_slot" else list(range(len(rows)))
            log.append((_name, rows, slots))
            return logits, caches

        setattr(eng, name, wrapped)
    return log


def serve_wave(model, params, mesh=None) -> dict:
    eng = Engine(model, params, EngineConfig(**WAVE), device="cpu", mesh=mesh)
    log = logged(eng)
    toks, stats = eng.generate(wave_batch(model.cfg), 8)
    return {"tokens": toks, "log": log, "cache_bytes": stats["cache_bytes"]}


def serve_continuous(arch: str, params, mesh=None) -> dict:
    cfg = smoke_config(arch)
    eng = Engine(build_model(cfg), params, EngineConfig(batch=4, capacity=64, policy=POLICY),
                 device="cpu", mesh=mesh)
    log = logged(eng)
    sched = Scheduler(eng)
    for r in requests(cfg):
        sched.submit(r)
    results = sched.run_continuous()
    return {"tokens": {r.rid: r.tokens for r in results}, "log": log}


# -- the reference side: the parent only --------------------------------------


def reference_weights() -> dict:
    """(arch, seed) -> (the reference's model, its parameters from
    ``PRNGKey(seed)``, the port's module holding the same weights)."""
    import jax

    from repro.configs import smoke_config as ref_smoke_config
    from repro.models.model import build_model as ref_build_model

    out = {}
    for arch, seed in WEIGHTS:
        ref_model = ref_build_model(ref_smoke_config(arch))
        ref_params = ref_model.init(jax.random.PRNGKey(seed))
        out[arch, seed] = (ref_model, ref_params, params_from_reference(
            jax.tree.map(np.asarray, ref_params), smoke_config(arch), device="cpu"))
    return out


def reference_runs(weights: dict) -> dict:
    """The reference's one-device engine on every case: the wave under the
    seed-0 and seed-1 weights, ``run_continuous`` for each arch."""
    import jax.numpy as jnp

    from repro.core.policy import named_policy as ref_named_policy
    from repro.serving import Engine as RefEngine
    from repro.serving import EngineConfig as RefEngineConfig
    from repro.serving import Request as RefRequest
    from repro.serving import Scheduler as RefScheduler

    pol = dataclasses.replace(ref_named_policy("gear_kcvt4"), buffer_size=16)
    out = {}
    for seed in (0, 1):
        ref_model, ref_params, _ = weights["minicpm-2b", seed]
        eng = RefEngine(ref_model, ref_params, RefEngineConfig(**dict(WAVE, policy=pol)))
        log = logged(eng)
        toks, _ = eng.generate({"tokens": jnp.asarray(wave_batch(ref_model.cfg)["tokens"])}, 8)
        out["wave", seed] = {"tokens": np.asarray(toks), "log": log}
    for arch in CONT_ARCHS:
        ref_model, ref_params, _ = weights[arch, 0]
        eng = RefEngine(ref_model, ref_params, RefEngineConfig(batch=4, capacity=64, policy=pol))
        log = logged(eng)
        sched = RefScheduler(eng)
        for r in requests(ref_model.cfg, RefRequest):
            sched.submit(r)
        results = sched.run_continuous()
        out["continuous", arch] = {"tokens": {r.rid: np.asarray(r.tokens) for r in results},
                                   "log": log}
    return out


# -- the mesh side: one child process of the spawn ---------------------------


def _spec_bytes(shapes: dict, specs: dict, mesh) -> int:
    """Bytes of one process's share of every leaf: ``shapes`` maps a name to
    (shape, itemsize), ``specs`` to its spec."""
    sizes = axis_sizes(mesh)
    total = 0
    for n, spec in specs.items():
        split = int(np.prod([sizes[a] for e in spec for a in shd._axes_of(e)] or [1]))
        shape, item = shapes[n]
        total += int(np.prod(shape)) // split * item
    return total


def _tree_leaves(tree) -> dict:
    out = {}
    for i, layer in enumerate(tree):
        for j, part in enumerate(layer if isinstance(layer, tuple) else (layer,)):
            for f, t in part.tensors().items():
                out[f"{i}.{j}.{f}"] = t
    return out


def _flat_specs(specs) -> dict:
    out = {}
    for i, layer in enumerate(specs):
        for j, part in enumerate(layer if isinstance(layer, tuple) else (layer,)):
            for f, s in part.items():
                out[f"{i}.{j}.{f}"] = s
    return out


def _mesh_worker(rank: int, weights: dict) -> dict:
    mesh = make_test_mesh(2, 2, device="cpu")
    res = {}
    cfg = smoke_config("minicpm-2b")
    model = build_model(cfg)
    params = weights["minicpm-2b", 0]
    res["wave"] = serve_wave(model, params, mesh)

    # storage: what this process keeps against what the spec trees give
    eng = Engine(model, params, EngineConfig(**WAVE), device="cpu", mesh=mesh)
    pspecs = shd.param_pspecs(cfg, params, mesh)
    pshapes = {n: (tuple(p.shape), p.element_size()) for n, p in params.named_parameters()}
    res["param_bytes"] = sum(p.numel() * p.element_size() for p in eng.params.parameters())
    res["param_bytes_want"] = _spec_bytes(pshapes, pspecs, mesh)
    res["wq_shape"] = tuple(eng.params.blocks[0].wq.shape)
    caches = eng.init_caches()
    whole = model.init_caches(POLICY, 4, 96, device="meta")
    leaves = _tree_leaves(whole)
    cshapes = {n: (tuple(t.shape), t.element_size()) for n, t in leaves.items()}
    res["cache_bytes"] = eng.cache_nbytes(caches)
    res["cache_bytes_want"] = _spec_bytes(cshapes, _flat_specs(
        shd.cache_pspecs(cfg, whole, mesh, 4)), mesh)
    res["buf_k_shape"] = tuple(caches[0].buf_k.shape)

    # set_params on the mesh: the seed-1 weights serve what they serve alone;
    # meanwhile, the most bytes of gathered weight copies alive at once
    eng.set_params(weights["minicpm-2b", 1])
    log = logged(eng)
    whole, peak = eng._whole, [0]
    put = whole._put

    def held(name):
        owner, _, attr = name.rpartition(".")
        return getattr(whole._whole.get_submodule(owner), attr)

    def counted_put(stored, names):
        put(stored, names)
        peak[0] = max(peak[0], sum(t.numel() * t.element_size()
                                   for t in map(held, whole.split) if t is not None))

    whole._put = counted_put
    toks, _ = eng.generate(wave_batch(cfg), 8)
    del whole._put
    res["gathered"] = {"peak": peak[0],
                       "by_block": whole.gathered_bytes(eng.params, by_block=True),
                       "all": whole.gathered_bytes(eng.params)}
    res["set_params"] = {"tokens": toks, "log": log}
    res["weight_version"] = eng.weight_version

    res["continuous"] = {arch: serve_continuous(arch, weights[arch, 0], mesh)
                         for arch in CONT_ARCHS}

    try:
        Engine(model, params, EngineConfig(**WAVE, layout="paged"), device="cpu", mesh=mesh)
        res["paged"] = "accepted"
    except NotImplementedError as e:
        res["paged"] = str(e)
    return res


def _child(rank: int, world: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(out, "store"), world),
                            rank=rank, world_size=world)
    try:
        weights = torch.load(os.path.join(out, "weights.pt"), weights_only=False)
        torch.save(_mesh_worker(rank, weights), os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(tmp_path: pathlib.Path, weights: dict, world: int = 4, meanwhile=None):
    """Serve every case on ``world`` processes with the port's ``weights``
    ((arch, seed) -> module); ``meanwhile()`` runs in this process while
    they do.  Returns (each rank's results, what ``meanwhile`` returned)."""
    out = tmp_path / "mesh"
    out.mkdir()
    torch.save(weights, out / "weights.pt")
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    procs = []
    for rank in range(world):
        code = (f"import sys; sys.path.insert(0, {str(TESTS)!r}); import {__name__} as t; "
                f"t._child({rank}, {world}, {str(out)!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        alongside = None if meanwhile is None else meanwhile()
    except BaseException:
        for p in procs:
            p.kill()
            p.communicate()
        raise
    deadline = time.monotonic() + SPAWN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1.0))[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"the {world} processes did not finish in {SPAWN_TIMEOUT} s")
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank} exited {p.returncode}:\n{log[-4000:]}"
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(world)], alongside


@pytest.fixture(scope="module")
def served(tmp_path_factory) -> dict:
    """Every rank's results, the reference's runs (made while the ranks
    serve) and the port's weights."""
    weights = reference_weights()
    port = {k: w[2] for k, w in weights.items()}
    ranks, ref = spawn(tmp_path_factory.mktemp("mesh_serve"), port,
                       meanwhile=lambda: reference_runs(weights))
    return {"ranks": ranks, "ref": ref, "weights": port}


@pytest.fixture(scope="module")
def ranks(served) -> list:
    return served["ranks"]


# -- the one-process side and the rule ---------------------------------------


def margin(row: np.ndarray) -> float:
    top = np.sort(row)[-2:]
    return float(top[1] - top[0])


def check_margin_rule(mesh_log: list, one_log: list, atol: float = LOGIT_ATOL) -> tuple:
    """Walk both logs call by call, ``one_log`` the other engine's, slot by
    slot: each row of a slot that still follows the other engine's tokens
    lies within ``atol`` of the other's, and a slot whose argmaxes differ
    must do so where the other's top-1/top-2 margin is within twice that.
    Such a slot has left the other's stream: its rows are skipped until a
    prefill starts it afresh (a row's logits depend on its own slot only,
    and with no EOS both runs make the same calls).  Returns (the rows
    compared, whether any slot left)."""
    assert mesh_log and len(mesh_log) == len(one_log)
    compared, left, ever = 0, set(), False
    for (kind_m, lm, slots_m), (kind_o, lo, slots_o) in zip(mesh_log, one_log):
        assert (kind_m, slots_m) == (kind_o, slots_o) and lm.shape == lo.shape, (
            kind_m, kind_o, slots_m, slots_o, lm.shape, lo.shape)
        if kind_m != "decode":
            left -= set(slots_m)
        for slot, rm, ro in zip(slots_m, lm, lo):
            if slot in left:
                continue
            gap = float(np.abs(rm - ro).max())
            assert gap <= atol, f"{kind_m}, slot {slot}: logits {gap} apart"
            compared += 1
            if int(rm.argmax()) != int(ro.argmax()):
                assert margin(ro) <= 2 * atol, (kind_m, slot, margin(ro))
                left.add(slot)
                ever = True
    return compared, ever


def check_run(run: dict, other: dict, atol: float, at_least: int) -> None:
    """``run``'s logits against ``other``'s under the margin rule, over at
    least ``at_least`` rows, and its tokens equal to ``other``'s unless it
    left them at a step under the margin."""
    compared, left = check_margin_rule(run["log"], other["log"], atol)
    assert compared >= at_least
    if left:
        return
    want = other["tokens"]
    for key in (want if isinstance(want, dict) else [None]):
        got = run["tokens"] if key is None else run["tokens"][key]
        np.testing.assert_array_equal(got, want if key is None else want[key])


def test_generate_matches_the_reference_engine(served):
    """The reference's mesh case against the reference's one-device engine:
    every process's tokens equal its tokens under the margin rule."""
    ref = served["ref"]["wave", 0]
    for r in served["ranks"]:
        check_run(r["wave"], ref, REF_LOGIT_ATOL, 28)


@pytest.mark.parametrize("arch", CONT_ARCHS)
def test_run_continuous_matches_the_reference_engine(served, arch):
    """Mixed-length continuous batching against the reference's one-device
    ``Scheduler.run_continuous``: every process's logits and tokens under
    the margin rule."""
    ref = served["ref"]["continuous", arch]
    for r in served["ranks"]:
        check_run(r["continuous"][arch], ref, REF_LOGIT_ATOL, 30)


def test_generate_matches_the_one_process_engine(served):
    """The reference's mesh case: every process's tokens equal the
    one-process engine's under the margin rule, and the whole tree's
    ``cache_bytes``."""
    ranks = served["ranks"]
    model = build_model(smoke_config("minicpm-2b"))
    one = serve_wave(model, served["weights"]["minicpm-2b", 0])
    for r in ranks:
        w = r["wave"]
        assert w["tokens"].shape == (4, 8)
        check_run(w, one, LOGIT_ATOL, 30)
        assert w["cache_bytes"] == one["cache_bytes"]


@pytest.mark.parametrize("arch", CONT_ARCHS)
def test_run_continuous_matches_the_one_process_engine(served, arch):
    """Mixed-length continuous batching: every process's scheduler serves
    the one-process engine's tokens under the margin rule (minicpm-2b's
    cache split over heads, rwkv6-3b's per-head state, hymba-1.5b's 2 KV
    heads split and its SSM state whole)."""
    one = serve_continuous(arch, served["weights"][arch, 0])
    for r in served["ranks"]:
        check_run(r["continuous"][arch], one, LOGIT_ATOL, 50)


def test_each_process_stores_its_spec_slices(served):
    """Parameter and cache bytes equal those ``param_pspecs`` /
    ``cache_pspecs`` give one process; the split leaves have local shapes."""
    cfg = smoke_config("minicpm-2b")
    ranks = served["ranks"]
    for r in ranks:
        assert r["param_bytes"] == r["param_bytes_want"]
        assert r["cache_bytes"] == r["cache_bytes_want"]
        assert r["wq_shape"] == (cfg.d_model, cfg.q_dim // 2)
        # 2 of 4 batch rows, 2 of 4 KV heads
        assert r["buf_k_shape"] == (2, 2, POLICY.buffer_size, cfg.head_dim)
    whole = sum(p.numel() * p.element_size()
                for p in served["weights"]["minicpm-2b", 0].parameters())
    assert ranks[0]["param_bytes"] < whole


def test_engine_gathers_one_layer_at_a_time(served):
    """A forward on the mesh holds the gathered copies of the weights
    outside the layers and of one layer at a time: their bytes peak at
    ``gathered_bytes(by_block=True)``, under every split weight's (the smoke
    config's 2 layers: the embedding and one layer's)."""
    for r in served["ranks"]:
        g = r["gathered"]
        assert 0 < g["peak"] == g["by_block"] < g["all"], g


def test_set_params_on_the_mesh(served):
    """``set_params`` re-slices the new weights: the engine then serves
    what the one-process engine and the reference's engine serve with
    them."""
    model = build_model(smoke_config("minicpm-2b"))
    one = serve_wave(model, served["weights"]["minicpm-2b", 1])
    for r in served["ranks"]:
        assert r["weight_version"] == 1
        check_run(r["set_params"], one, LOGIT_ATOL, 30)
        check_run(r["set_params"], served["ref"]["wave", 1], REF_LOGIT_ATOL, 28)


def test_paged_layout_refused_on_a_mesh(ranks):
    """The engine refuses the paged layout on a mesh with the reference's
    words, and so does the launcher, before it builds a mesh."""
    assert all(r["paged"] == PAGED_WORDS for r in ranks)
    with pytest.raises(SystemExit, match="paged layout is single-host for now"):
        serve.main(["--smoke", "--device", "cpu", "--mesh", "2x2", "--layout", "paged"])
    assert not dist.is_initialized()


def test_one_by_one_mesh_is_the_one_device_engine_bit_for_bit():
    """On a 1 × 1 mesh (one gloo process) every axis has size 1: no
    collective, and the tokens, every logged logit and every cache leaf
    equal the one-device engine's bit for bit."""
    cfg = smoke_config("minicpm-2b")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    assert not dist.is_initialized()
    mesh = make_test_mesh(1, 1, device="cpu")
    try:
        runs = []
        with CollectiveCounter() as coll:
            for m in (None, mesh):
                eng = Engine(model, params, EngineConfig(**WAVE), device="cpu", mesh=m)
                log = logged(eng)
                toks, _ = eng.generate(wave_batch(cfg), 8)
                view = eng.new_view()
                batch = wave_batch(cfg)["tokens"]
                for slot in range(4):
                    view.prefill_slot({"tokens": batch[slot:slot + 1, :20 + slot]}, slot)
                tok = torch.as_tensor(batch[:, :1])
                for step in range(20):
                    view.decode({"tokens": tok}, np.arange(20, 24) + step)
                view.reset_slot(2)
                runs.append((toks, log, _tree_leaves(view.caches)))
        assert coll.stats()["total_count"] == 0
        (t0, l0, c0), (t1, l1, c1) = runs
        np.testing.assert_array_equal(t0, t1)
        assert len(l0) == len(l1)
        for (k0, a, s0), (k1, b, s1) in zip(l0, l1):
            assert (k0, s0) == (k1, s1)
            np.testing.assert_array_equal(a, b)
        assert c0.keys() == c1.keys()
        for n in c0:
            assert torch.equal(c0[n], c1[n]), n
    finally:
        dist.destroy_process_group()
