"""The port's other cache kinds and its portable decode attention against the
JAX reference (``repro.core.cache``'s ``FP16LayerCache`` /
``WindowLayerCache``, ``dense_kv``, ``attend`` and ``attend_paged``), and the
serving paths they open: the paper's FP16 and per-token baselines and
``fused="off"``.

Inputs come from numpy seeds and go through both packages.  What is held:

* FP16 and window caches through init, prefill, append (past the FP16
  capacity, around the window ring), splice and reset: every leaf bit for
  bit, a reset ring's ``pos`` back at -1;
* ``dense_kv`` of a GEAR cache (per-channel and per-token-group K, ragged
  slots, closed chunks and buffers) within ``DENSE_RTOL`` of the largest
  entry (measured: equal), as the packages' f32 low-rank products may sum
  in another order;
* ``attend``'s branches within ``ATTEND_ATOL`` of the reference's (outputs
  of magnitude ~0.6): f32 softmax over the window ring and the FP16 cache
  (1e-6), the dense reconstruction (measured 2.2e-7) and the factored GEAR
  branch, which rounds to bf16 where the reference does (measured 3.0e-8);
* ``attend_paged`` equal to ``attend`` on the dense cache, bit for bit;
* ``Scheduler.run_continuous`` under ``fp16``, ``per_token_q4``,
  ``per_token_q2`` and ``fused="off"``, dense and (where the reference
  allows it) paged, against the reference engine on the tiny model of
  ``tests/test_torch_resilience.py``: statuses exactly, attend path as the
  reference reports it, and every served token by that file's
  teacher-forced rule with the bound ``GAP`` of its policy.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as R  # noqa: E402
import repro_torch.serving as P  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402


DENSE_RTOL = 1e-6
ATTEND_ATOL = 1e-6
# teacher-forced |port - reference| logit bound of the served tokens, per
# policy (measured max over this file: fp16 0.039, per_token_q4 0.082,
# per_token_q2 0.219, gear_kcvt4 with fused="off" 0.0625); 2-bit codes of a
# chunk closed on K/V one bf16 ulp apart flip most (ROADMAP §3, standing
# difference d)
GAP = {"fp16": 0.1, "per_token_q4": 0.125, "per_token_q2": 0.3, "gear_kcvt4": 0.1}
EOS = 3
CAP = 48
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_t(x) -> torch.Tensor:
    t = torch.from_numpy(to_np(x).copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def bf16(shape, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32)
                       ).astype(jnp.bfloat16)


def assert_same(port, ref):
    """Every leaf of a port cache equal to the reference's, dtype included."""
    for name, p in port.tensors().items():
        r = getattr(ref, name)
        assert str(p.dtype).split(".")[-1] == str(r.dtype), name
        np.testing.assert_array_equal(to_np(p), to_np(r), err_msg=name)


# ---------------------------------------------------------------------------
# FP16 and window caches


KINDS = {"fp16": dict(kind="fp16", capacity=32, n=26, policy="fp16"),
         "window": dict(kind="window", capacity=8, window=8, n=13, policy="gear_kcvt4")}


@pytest.mark.parametrize("kind", list(KINDS))
def test_uncompressed_cache_protocol_matches_reference(kind):
    """init, prefill (the window keeps the last 8 of 13 tokens), 9 appends
    (the FP16 cache fills at 32 and drops the rest; the ring wraps), a
    batch-1 prefill of 5 tokens spliced into slot 1, a reset of slot 0, and
    ``attend`` after each step."""
    spec = dict(KINDS[kind])
    n, polname = spec.pop("n"), spec.pop("policy")
    geo = dict(kv_heads=2, head_dim=16, **spec)
    jcfg = jcache.CacheConfig(batch=2, policy=jnamed(polname), **geo)
    pcfg = cache.CacheConfig(batch=2, policy=named_policy(polname), **geo)
    jcfg1, pcfg1 = (dataclasses.replace(c, batch=1) for c in (jcfg, pcfg))
    q = jnp.asarray(np.random.RandomState(9).randn(2, 4, 16).astype(np.float32))

    def check(pc, jc):
        assert_same(pc, jc)
        want = np.asarray(jcache.attend(jcfg, jc, q, 0.25))
        got = cache.attend(pcfg, pc, to_t(q), 0.25).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)

    jc, pc = jcache.init_layer_cache(jcfg), cache.init_layer_cache(pcfg, device="cpu")
    assert_same(pc, jc)
    k, v = bf16((2, 2, n, 16), 0), bf16((2, 2, n, 16), 1)
    jc = jcache.prefill_layer_cache(jcfg, jc, k, v)
    cache.prefill_layer_cache(pcfg, pc, to_t(k), to_t(v))
    check(pc, jc)
    for t in range(9):
        kt, vt = bf16((2, 2, 16), 10 + t), bf16((2, 2, 16), 20 + t)
        jc = jcache.append_token(jcfg, jc, kt, vt)
        cache.append_token(pcfg, pc, to_t(kt), to_t(vt), np.full(2, n + t))
        check(pc, jc)
    k1, v1 = bf16((1, 2, 5, 16), 30), bf16((1, 2, 5, 16), 31)
    one_j = jcache.prefill_layer_cache(jcfg1, jcache.init_layer_cache(jcfg1), k1, v1)
    one_p = cache.prefill_layer_cache(pcfg1, cache.init_layer_cache(pcfg1, device="cpu"),
                                      to_t(k1), to_t(v1))
    jc = jcache.splice_slot(jc, one_j, 1)
    cache.splice_slot(pc, one_p, 1)
    check(pc, jc)
    jc = jcache.reset_slot(jcfg, jc, 0)
    cache.reset_slot(pc, 0)
    check(pc, jc)
    assert int(pc.length[0]) == 0
    if kind == "window":
        assert pc.pos[0].tolist() == [-1] * 8       # empty, not "slot 0 holds position 0"


def test_cache_kinds_pass_through_the_slot_protocol_and_guard():
    """``tree_finite`` sees an FP16 cache's K/V; ``Engine.cache_nbytes`` counts
    its leaves; a hybrid-style pair with a window ring resets both parts."""
    pol = named_policy("fp16")
    pcfg = cache.CacheConfig(batch=2, kv_heads=2, head_dim=16, capacity=32, policy=pol,
                             kind="fp16")
    c = cache.init_layer_cache(pcfg, device="cpu")
    assert bool(cache.tree_finite([c]))
    c.v[1, 0, 3, 2] = float("inf")
    assert not bool(cache.tree_finite(c))
    assert P.Engine.cache_nbytes([c]) == 2 * (2 * 2 * 32 * 16 * 2) + 2 * 4
    wcfg = dataclasses.replace(pcfg, kind="window", window=4, capacity=4)
    ring = cache.init_layer_cache(wcfg, device="cpu")
    cache.prefill_layer_cache(wcfg, ring, torch.ones(2, 2, 6, 16), torch.ones(2, 2, 6, 16))
    pair = (ring, c)
    cache.reset_slot(pair, 1)
    assert ring.pos[1].tolist() == [-1] * 4 and ring.pos[0].tolist() == [4, 5, 2, 3]
    assert not c.v[1].any() and int(ring.length[1]) == 0


# ---------------------------------------------------------------------------
# dense_kv, attend, attend_paged over GEAR caches


GEAR_POLICIES = ["gear_kcvt4", "gear_kivi2", "per_token_q4", "per_token_q2"]


def ragged_gear_caches(polname):
    """Both packages' batch-3 GEAR cache (H 2, Dh 64, capacity 256): a
    200-token prefill, then slot lengths 63 / 100 / 190 with random buffers,
    then three appends (slot 0 closes chunk 0, slot 2 closes chunk 2)."""
    geo = dict(batch=3, kv_heads=2, head_dim=64, capacity=256)
    jcfg = jcache.CacheConfig(policy=jnamed(polname), **geo)
    pcfg = cache.CacheConfig(policy=named_policy(polname), **geo)
    k, v = bf16((3, 2, 200, 64), 0), bf16((3, 2, 200, 64), 1)
    jc = jax.jit(lambda a, b: jcache.prefill_layer_cache(
        jcfg, jcache.init_layer_cache(jcfg), a, b))(k, v)
    jc = dataclasses.replace(jc, length=jnp.asarray([63, 100, 190], jnp.int32),
                             buf_k=bf16((3, 2, 64, 64), 7), buf_v=bf16((3, 2, 64, 64), 8))
    step = jax.jit(lambda c, a, b: jcache.append_token(jcfg, c, a, b))
    for t in range(3):
        jc = step(jc, bf16((3, 2, 64), 100 + t), bf16((3, 2, 64), 200 + t))
    pc = cache.GEARLayerCache(**{f: None if getattr(jc, f) is None else to_t(getattr(jc, f))
                                 for f in cache.FIELDS})
    return jcfg, pcfg, jc, pc


def paged_twin(pcfg, pc):
    """The port's paged cache holding ``pc``'s chunks in shuffled pool pages,
    and its block tables."""
    B, C = pcfg.batch, pcfg.n_chunks
    pages = 1 + np.random.RandomState(3).permutation(B * C).reshape(B, C)
    pp = cache.init_paged_layer_cache(pcfg, B * C + 1, device="cpu")
    pcfg1 = dataclasses.replace(pcfg, batch=1)
    for b in range(B):
        chunks = cache.extract_prefix_chunks(pcfg1, cache.GEARLayerCache(
            **{f: None if t is None else t[b:b + 1] for f, t in dataclasses.asdict(pc).items()}),
            C)
        cache.scatter_pool_chunks(pcfg1, pp, torch.from_numpy(pages[b]), chunks)
    for name in ("buf_k", "buf_v", "length"):
        getattr(pp, name).copy_(getattr(pc, name))
    return pp, torch.from_numpy(pages.astype(np.int32))


@pytest.fixture(scope="module", params=GEAR_POLICIES)
def gear(request):
    return ragged_gear_caches(request.param)


def test_dense_kv_matches_reference(gear):
    jcfg, pcfg, jc, pc = gear
    for want, got in zip(jcache.dense_kv(jcfg, jc), cache.dense_kv(pcfg, pc)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=DENSE_RTOL * np.abs(want).max())
    # positions past each slot's length read 0; buffered tokens their bf16 values
    k_hat, _ = cache.dense_kv(pcfg, pc)
    assert not k_hat[0, :, 66:].any() and not k_hat[2, :, 193:].any()
    assert torch.equal(k_hat[1, :, 64:103], pc.buf_k[1, :, :39].float())


@pytest.mark.parametrize("factored", [True, False], ids=["factored", "dense"])
def test_attend_matches_reference_and_paged_equals_dense(gear, factored):
    jcfg, pcfg, jc, pc = gear
    q = np.random.RandomState(5).randn(3, 4, 64).astype(np.float32)
    want = np.asarray(jcache.attend(jcfg, jc, jnp.asarray(q), 0.125, use_factored=factored))
    got = cache.attend(pcfg, pc, torch.from_numpy(q), 0.125, use_factored=factored)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATTEND_ATOL)
    pp, bt = paged_twin(pcfg, pc)
    paged = cache.attend_paged(pcfg, pp, bt, torch.from_numpy(q), 0.125, use_factored=factored)
    assert torch.equal(paged, got)


# ---------------------------------------------------------------------------
# serving: the FP16 and per-token baselines, fused="off"


def small(named, polname):
    pol = named(polname)
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8),
                               rank=min(pol.rank, 2), rank_decode=min(pol.rank_decode, 2))


class Tiny:
    """Both packages' tiny model on the reference's parameters."""

    def __init__(self):
        self.ref_model = ref_build_model(RefModelConfig(**TINY))
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        cfg = ModelConfig(**TINY)
        self.model = build_model(cfg)
        self.params = params_from_reference(jax.tree.map(np.asarray, self.ref_params), cfg,
                                            device="cpu")
        self._jit: dict = {}

    def requests(self, mod, seed=0):
        """Five requests of two prompt lengths (fewer reference compiles), each
        long enough for a decode chunk close."""
        rng = np.random.RandomState(seed)
        return [mod.Request(rid=i, tokens=rng.randint(4, 64, size=n), max_new_tokens=b)
                for i, (n, b) in enumerate(zip([6, 13, 6, 13, 6], [12, 5, 14, 9, 11]))]

    def ref_fns(self, polname, fused):
        """The reference's jitted batch-1 prefill and decode step."""
        if (polname, fused) not in self._jit:
            m, pol = self.ref_model, small(jnamed, polname)
            self._jit[polname, fused] = (
                jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP, fused=fused)),
                jax.jit(lambda p, t, c, pos: m.decode_step(p, {"tokens": t}, c, pos, pol, CAP,
                                                           fused=fused)))
        return self._jit[polname, fused]

    def along(self, polname, fused, prompt, tokens):
        """(reference, port) logits [T, V] at each of ``tokens``, teacher-forced
        at batch 1 through each package's model with the engine's policy and
        attend path."""
        ppol = small(named_policy, polname)
        prefill, decode = self.ref_fns(polname, fused)
        logits, caches = prefill(self.ref_params, jnp.asarray(prompt[None]))
        plogits, pcaches = self.model.prefill(self.params, {"tokens": prompt[None]}, ppol, CAP)
        ref, port = [], []
        for i, tok in enumerate(tokens):
            ref.append(np.asarray(logits[0, -1].astype(jnp.float32)))
            port.append(plogits[0, -1].float().numpy())
            if i + 1 < len(tokens):
                pos = len(prompt) + i
                logits, caches = decode(self.ref_params, jnp.asarray([[tok]], jnp.int32),
                                        caches, jnp.asarray([pos], jnp.int32))
                plogits, pcaches = self.model.decode_step(
                    self.params, {"tokens": np.array([[tok]])}, pcaches, np.array([pos]), ppol,
                    CAP, fused=fused)
        return np.stack(ref), np.stack(port)


@pytest.fixture(scope="module")
def tiny():
    return Tiny()


SERVING = {                          # id: (policy, EngineConfig overrides, reference path)
    "fp16-dense": ("fp16", {}, "xla"),
    "per_token_q4-dense": ("per_token_q4", {}, "xla"),
    "per_token_q4-paged": ("per_token_q4", {"layout": "paged"}, "xla"),
    "per_token_q2-dense": ("per_token_q2", {}, "xla"),
    "gear_kcvt4-fused_off-dense": ("gear_kcvt4", {"fused": "off"}, "xla"),
    "gear_kcvt4-fused_off-paged": ("gear_kcvt4", {"fused": "off", "layout": "paged"}, "xla"),
}


@pytest.mark.parametrize("case", list(SERVING))
def test_run_continuous_matches_reference_engine(tiny, case):
    polname, over, path = SERVING[case]
    got = {}
    for name, mod, model, params, named, extra in (
            ("ref", R, tiny.ref_model, tiny.ref_params, jnamed, {}),
            ("port", P, tiny.model, tiny.params, named_policy, {"device": "cpu"})):
        eng = mod.Engine(model, params, mod.EngineConfig(
            batch=2, capacity=CAP, policy=small(named, polname), eos_id=EOS, **over), **extra)
        sched = mod.Scheduler(eng)
        for r in tiny.requests(mod):
            sched.submit(r)
        got[name] = (sched.run_continuous(), sched.last_stats["attend_path"])
    (ref, ref_path), (port, port_path) = got["ref"], got["port"]
    assert port_path == ref_path == path
    assert [(r.rid, str(r.status)) for r in port] == [(r.rid, str(r.status)) for r in ref]
    prompts = {r.rid: r.tokens for r in tiny.requests(P)}
    want = {r.rid: np.asarray(r.tokens) for r in ref}
    for r in port:
        toks = np.asarray(r.tokens)
        rlog, plog = tiny.along(polname, over.get("fused", "auto"), prompts[r.rid], toks)
        gaps = np.abs(rlog - plog).max(-1)
        assert (gaps <= GAP[polname]).all(), (r.rid, gaps)
        np.testing.assert_array_equal(toks, plog.argmax(-1))
        m = min(len(toks), len(want[r.rid]))
        diff = np.flatnonzero(toks[:m] != want[r.rid][:m])
        if diff.size:                  # only where rounding can explain it
            top2 = np.sort(rlog[diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[diff[0]], (r.rid, toks, want[r.rid])
        else:
            np.testing.assert_array_equal(toks, want[r.rid])


@pytest.mark.parametrize("polname", ["fp16", "per_token_q4"])
def test_streaming_prefill_falls_back_to_monolithic(tiny, polname):
    """A layer the streaming pipeline cannot take (an FP16 cache, per-token
    K stats) prefills monolithically under ``prefill_mode="streaming"``, as
    in the reference: logits and every cache tensor equal the monolithic
    prefill's, and such an engine does not length-bucket."""
    pol = small(named_policy, polname)
    prompt = {"tokens": np.random.RandomState(2).randint(4, 64, size=(1, 21))}
    mono = tiny.model.prefill(tiny.params, prompt, pol, CAP)
    stream = tiny.model.prefill(tiny.params, prompt, pol, CAP, prefill_mode="streaming")
    assert torch.equal(mono[0], stream[0])
    for a, b in zip(mono[1], stream[1], strict=True):
        for name, t in a.tensors().items():
            assert torch.equal(t, getattr(b, name)), name
    eng = P.Engine(tiny.model, tiny.params, P.EngineConfig(
        batch=1, capacity=CAP, policy=pol, prefill_mode="streaming"), device="cpu")
    assert not eng._can_bucket
