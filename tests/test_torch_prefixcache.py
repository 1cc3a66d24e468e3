"""The port's prefix cache (radix trie over compressed chunks, the suffix
prefill it rides on, shared pool pages and the reclaim valve) against the
JAX reference's, and warm ≡ cold within the port.

The same numpy-seeded inputs and weights go to both packages; the port's
CPU tensors take the plain kernel versions.  What is held, and how:

* the trie and its facade (``RadixTrie``, ``PrefixCache``): the same
  operation sequences drive both packages' structures; every returned
  handle, eviction, stat and audit report is equal (pure Python on both
  sides);
* chunk extraction / splicing (``extract_prefix_chunks`` from a start
  chunk, ``splice_prefix_chunks``) and the suffix streaming pipeline
  (``start_chunk`` > 0): cache leaves bit-equal to the reference's
  (low-rank factors through ``A·Bᵀ`` within 1e-2 relative, the standing
  one-ulp difference, ROADMAP §3), attention outputs within ``OUT_ATOL``;
  within the port, the suffix run equals the cold run bit for bit;
* the engine, warm ≡ cold within the port: prefill logits and the slot's
  cache (paged: gathered through the block table) bit for bit, dense and
  paged, aligned and mixed-length prompts, a padded suffix tail;
* the engine against the reference engine on the same request sequence
  (smoke llama2-7b on the reference's parameters): trie and page
  bookkeeping after every prefill (block tables, refcounts, trie stats)
  bit-exact; the layer-0 closed chunks of every request's batch-1 cache
  bit-exact (low-rank 1e-2 relative); prefill logits within
  ``PREFILL_LOGIT_ATOL`` and teacher-forced decode logits within
  ``DECODE_LOGIT_ATOL`` (``tests/test_torch_paged.py``); greedy tokens
  equal (gear_kivi2, on a head_dim-64 model: the first token, by that
  file's margin rule, and logits within ``KIVI2_DH64_PREFILL_ATOL``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.prefixcache import PrefixCache as RefPrefixCache  # noqa: E402
from repro.prefixcache import RadixTrie as RefRadixTrie  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving.scheduler import Request as RefRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as RefScheduler  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import FP16, named_policy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.prefixcache import PrefixCache, RadixTrie  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

NB = 64
CAP = 320
EOS = 3
OUT_ATOL = 1 / 64
PREFILL_LOGIT_ATOL = 0.1
DECODE_LOGIT_ATOL = 0.125
PREFILL_MARGIN = 0.125
DECODE_MARGIN = 0.3
# gear_kivi2 runs on a head_dim-64 variant of the smoke model (its 64-wide V
# groups need it); there the port's cold streaming prefill logits already
# differ from the reference's by up to 0.227: rounding-level differences in
# the K/V each layer compresses flip 2-bit codes, and the reference's logits
# move as far under its own rounding changes (the witness test below and
# this file's ``__main__`` readings; ROADMAP §3), so its warm logits are held
# to that, and to the port's cold logits bit for bit
KIVI2_DH64_PREFILL_ATOL = 0.25


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_t(x) -> torch.Tensor:
    t = torch.from_numpy(to_np(x).copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


# ---------------------------------------------------------------------------
# the trie and its facade, driven identically in both packages


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def K(*chunks):
    return [tuple(c) for c in chunks]


A, B_, C, D, E = (1, 1), (2, 2), (3, 3), (4, 4), (5, 5)

# scenario: (RadixTrie kwargs, ops).  Ops: ("insert", keys, [(handle, nbytes)
# | None]), ("lookup", keys, acquire), ("release", index into the held
# pins), ("tick", seconds), ("bump",), ("evict",), ("drain",)
TRIE_SCENARIOS = {
    "longest-match": (dict(budget_bytes=1000), [
        ("insert", K(A, B_, C), [(0, 10), (1, 10), (2, 10)]),
        ("lookup", K(A, B_, D), False), ("lookup", K(D), False), ("lookup", K(A, B_, C, D), False),
        ("insert", K(A, B_, D), [None, None, (3, 10)]),     # shares the prefix, no duplicate
        ("lookup", K(A, B_, D), False)]),
    "orphan-handles": (dict(budget_bytes=1000), [
        ("insert", K(A), [(0, 10)]),
        ("insert", K(A, B_, C), [None, None, (5, 10)]),      # past a missing unbacked node
        ("insert", K(A, B_), [(6, 10), (7, 10)])]),          # racing insert of A
    "lru": (dict(budget_bytes=30), [
        ("insert", K(A), [(0, 10)]), ("insert", K(B_), [(1, 10)]), ("insert", K(C), [(2, 10)]),
        ("lookup", K(A), False), ("insert", K(D), [(3, 10)]), ("insert", K(E), [(4, 10)])]),
    "lfu": (dict(budget_bytes=30, eviction="lfu"), [
        ("insert", K(A), [(0, 10)]), ("insert", K(B_), [(1, 10)]), ("insert", K(C), [(2, 10)]),
        ("lookup", K(A), False), ("lookup", K(A), False), ("lookup", K(C), False),
        ("insert", K(D), [(3, 10)]), ("insert", K(E), [(4, 10)])]),
    "interior-survives": (dict(budget_bytes=25), [
        ("insert", K(A, B_), [(0, 10), (1, 10)]), ("insert", K(A, C), [None, (2, 10)]),
        ("lookup", K(A, C), False), ("evict",)]),
    "ttl": (dict(budget_bytes=1000, ttl=30.0), [
        ("insert", K(A, B_), [(0, 10), (1, 10)]), ("tick", 20.0),
        ("insert", K(A, B_, C), [None, None, (2, 10)]), ("tick", 15.0),
        ("lookup", K(A, B_, C), False), ("drain",), ("insert", K(A), [(3, 10)]),
        ("lookup", K(A), False)]),
    "version-bump": (dict(budget_bytes=1000), [
        ("insert", K(A, B_), [(0, 10), (1, 10)]), ("insert", K(C), [(2, 10)]), ("bump",),
        ("lookup", K(A, B_), False), ("drain",), ("insert", K(A), [(3, 10)]),
        ("lookup", K(A, B_), False), ("lookup", K(C), False), ("drain",)]),
    "pinned-stale-subtree": (dict(budget_bytes=1000), [
        ("insert", K(A, B_), [(0, 10), (1, 10)]), ("lookup", K(A, B_), True), ("bump",),
        ("lookup", K(A, B_), False),                         # blocked: pinned below
        ("insert", K(A, C), [(2, 10), (3, 10)]),             # handed back, nothing replaced
        ("release", 0), ("lookup", K(A), False), ("drain",), ("insert", K(A), [(4, 10)])]),
    "pinned-never-evicted": (dict(budget_bytes=15), [
        ("insert", K(A), [(0, 10)]), ("lookup", K(A), True), ("insert", K(B_), [(1, 10)]),
        ("insert", K(C), [(2, 10)]), ("release", 0), ("evict",)]),
}


def drive_trie(trie_cls, kwargs, ops) -> list:
    clock = FakeClock()
    trie = trie_cls(clock=clock, **kwargs)
    held, log = [], []
    for op in ops:
        kind = op[0]
        if kind == "insert":
            created, unused, evicted = trie.insert(op[1], op[2])
            out = ([nd.handle for nd in created], list(unused), list(evicted))
        elif kind == "lookup":
            path = trie.lookup(op[1], acquire=op[2])
            if op[2]:
                held.append(path)
            out = [nd.handle for nd in path]
        elif kind == "release":
            trie.release(held.pop(op[1]))
            out = None
        elif kind == "tick":
            clock.t += op[1]
            out = None
        elif kind == "bump":
            trie.bump_version()
            out = None
        elif kind == "evict":
            out = trie.evict_to_budget()
        else:
            out = trie.drain_pruned()
        log.append((kind, out, dataclasses.asdict(trie.stats), trie.total_bytes, trie.n_nodes,
                    sorted(trie.live_handles()), trie.audit(),
                    round(trie.stats.prefix_hit_rate, 12)))
    return log


@pytest.mark.parametrize("name", sorted(TRIE_SCENARIOS))
def test_trie_matches_reference(name):
    """LRU / LFU order, TTL expiry, version invalidation, pinned subtrees,
    orphan handles: every returned handle list, stat and audit report equal
    the reference trie's, step by step."""
    kwargs, ops = TRIE_SCENARIOS[name]
    assert drive_trie(RadixTrie, kwargs, ops) == drive_trie(RefRadixTrie, kwargs, ops)


def _facade_state(pc) -> tuple:
    return (pc.stats, pc.snapshot().as_dict(), sorted(pc.live_handles()), pc.audit(),
            pc.store.total_bytes, len(pc.store))


def test_trie_property_interleavings():
    """The interleavings of ``tests/test_prefixcache.py``'s property (insert
    / lookup / acquire / release under a byte budget) drive both packages'
    ``PrefixCache`` with the same operations: every match, stat, store byte
    count and audit is equal, and the reference's invariants hold on the
    port's (budget after release, longest match)."""
    from hypothesis import HealthCheck, given, settings
    from hypothesis import strategies as st

    chunk = 2
    tokens_strat = st.lists(st.integers(0, 2), min_size=0, max_size=10)
    op = st.one_of(
        st.tuples(st.just("insert"), tokens_strat, st.integers(1, 40)),
        st.tuples(st.just("lookup"), tokens_strat, st.just(0)),
        st.tuples(st.just("acquire"), tokens_strat, st.just(0)),
        st.tuples(st.just("release"), st.just(None), st.integers(0, 5)),
        st.tuples(st.just("evict_bytes"), st.just(None), st.integers(0, 60)),
    )

    @given(budget=st.integers(0, 200), ops=st.lists(op, max_size=40))
    @settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
    def run(budget, ops):
        pcs = [PrefixCache(chunk=chunk, budget_bytes=budget),
               RefPrefixCache(chunk=chunk, budget_bytes=budget)]
        held = [[], []]
        for kind, tokens, arg in ops:
            outs = []
            for pc, h in zip(pcs, held):
                if kind == "insert":
                    n_full = len(tokens) // chunk
                    outs.append(pc.insert(tokens, [np.zeros(arg, np.uint8)
                                                   for _ in range(n_full)]))
                elif kind == "lookup":
                    from repro_torch.prefixcache import chunk_keys
                    keys = chunk_keys(tokens, chunk)
                    path = pc.trie.lookup(keys)
                    tip = path[-1] if path else pc.trie.root
                    assert len(path) == len(keys) or keys[len(path)] not in tip.children
                    outs.append([nd.key for nd in path])
                elif kind == "acquire":
                    m = pc.match(tokens)
                    h.append(m)
                    outs.append([nd.handle for nd in m.nodes])
                elif kind == "release" and h:
                    pc.release(h.pop(arg % len(h)))
                elif kind == "evict_bytes":
                    outs.append(pc.evict_bytes(arg))
            assert all(o == outs[0] for o in outs), (kind, outs)
            assert _facade_state(pcs[0]) == _facade_state(pcs[1])
        for pc, h in zip(pcs, held):
            while h:
                pc.release(h.pop())
            pc.trie.evict_to_budget()
            assert pc.trie.total_bytes <= budget and pc.audit()["ok"]
        assert _facade_state(pcs[0]) == _facade_state(pcs[1])

    run()


# ---------------------------------------------------------------------------
# chunk extraction / splicing and the suffix pipeline, against repro.core.cache


def _cfgs(polname, batch, Dh=64, S=CAP):
    return (jcache.CacheConfig(batch=batch, kv_heads=2, head_dim=Dh, capacity=S,
                               policy=jnamed(polname)),
            cache.CacheConfig(batch=batch, kv_heads=2, head_dim=Dh, capacity=S,
                              policy=named_policy(polname)))


def _bf16(shape, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32)
                       ).astype(jnp.bfloat16)


def _port_cache(jc) -> cache.GEARLayerCache:
    return cache.GEARLayerCache(**{f: None if getattr(jc, f) is None else to_t(getattr(jc, f))
                                   for f in cache.FIELDS})


def _assert_chunks_equal(pc, jc, rows=slice(None)):
    """Every leaf bit-equal except the low-rank factors, held through A·Bᵀ."""
    for f in cache.FIELDS:
        if getattr(jc, f) is not None and not f.endswith(("_a", "_b")):
            np.testing.assert_array_equal(to_np(getattr(pc, f))[rows],
                                          to_np(getattr(jc, f))[rows], err_msg=f)
    if getattr(jc, "k_a") is None:
        return
    B, H, S = jc.k_a.shape[:3]
    for kv in ("k", "v"):
        ab = [to_np(getattr(c, f"{kv}_a"))[rows].reshape(-1, H, S // NB, NB, jc.k_a.shape[-1])
              @ np.swapaxes(to_np(getattr(c, f"{kv}_b"))[rows], -1, -2) for c in (pc, jc)]
        assert np.linalg.norm(ab[0] - ab[1]) <= 1e-2 * np.linalg.norm(ab[1]), kv


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2", "kcvt4"])
def test_extract_splice_roundtrip_matches_reference(polname):
    """Chunks [1, 3) of a prefilled cache, extracted and spliced into slot 2
    of a wider cache at chunk 1: every leaf bit-equal to the reference's
    round trip, and the spliced rows equal the source's."""
    jcfg1, pcfg1 = _cfgs(polname, 1)
    jcfg3, pcfg3 = _cfgs(polname, 3)
    k, v = _bf16((1, 2, 250, 64), 0), _bf16((1, 2, 250, 64), 1)
    jsrc = jax.jit(lambda a, b: jcache.prefill_layer_cache(
        jcfg1, jcache.init_layer_cache(jcfg1), a, b))(k, v)
    psrc = _port_cache(jsrc)
    jdst = jcache.splice_prefix_chunks(jcfg3, jcache.init_layer_cache(jcfg3), 2,
                                       jcache.extract_prefix_chunks(jcfg1, jsrc, 2, 1), 1)
    pdst = cache.splice_prefix_chunks(pcfg3, cache.init_layer_cache(pcfg3, device="cpu"), 2,
                                      cache.extract_prefix_chunks(pcfg1, psrc, 2, 1), 1)
    for f in cache.FIELDS:
        if getattr(jdst, f) is not None:
            np.testing.assert_array_equal(to_np(getattr(pdst, f)), to_np(getattr(jdst, f)),
                                          err_msg=f)
    for f, (rpc, ax) in cache._chunk_row_axes(pcfg1).items():
        src, dst = getattr(psrc, f)[0], getattr(pdst, f)[2]
        rows = dst.dim() + ax
        assert torch.equal(src.narrow(rows, rpc, 2 * rpc), dst.narrow(rows, rpc, 2 * rpc)), f
        assert not dst.narrow(rows, 0, rpc).any() and not dst.narrow(rows, 3 * rpc, rpc).any()


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("n_suf,true_n", [(128, None), (100, None), (128, 70)],
                         ids=["aligned", "raw-tail", "padded-tail"])
def test_suffix_pipeline_matches_reference_and_cold(polname, n_suf, true_n):
    """A suffix streaming prefill (``start_chunk`` 2) over a cache holding 2
    spliced prefix chunks: leaves bit-equal to the reference's suffix run
    (low-rank 1e-2), outputs within OUT_ATOL of it; and within the port the
    cache and the suffix rows' outputs equal the cold run over prefix +
    suffix bit for bit."""
    jcfg, pcfg = _cfgs(polname, 1)
    pre, n = 2 * NB, 2 * NB + n_suf
    rng = np.random.RandomState(n_suf + (true_n or 0))
    q = jnp.asarray(rng.randn(1, 4, n, 64).astype(np.float32)).astype(jnp.bfloat16)
    k = jnp.asarray(rng.randn(1, 2, n, 64).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.randn(1, 2, n, 64).astype(np.float32)).astype(jnp.bfloat16)
    padded = true_n is not None
    scale = 64 ** -0.5
    pcold, pout_cold = cache.streaming_prefill_layer_cache(
        pcfg, cache.init_layer_cache(pcfg, device="cpu"), to_t(q), to_t(k), to_t(v), scale,
        tail_is_padded=padded, true_n=None if not padded else pre + true_n)
    chunks = cache.extract_prefix_chunks(pcfg, pcold, 2)
    pscaf = cache.splice_prefix_chunks(pcfg, cache.init_layer_cache(pcfg, device="cpu"), 0,
                                       [{f: t.clone() for f, t in c.items()} for c in chunks])
    pwarm, pout = cache.streaming_prefill_layer_cache(
        pcfg, pscaf, to_t(q)[:, :, pre:], to_t(k)[:, :, pre:], to_t(v)[:, :, pre:], scale,
        start_chunk=2, tail_is_padded=padded, true_n=true_n)
    for f, t in pcold.tensors().items():
        assert torch.equal(t, getattr(pwarm, f)), f
    assert torch.equal(pout, pout_cold[:, :, pre:])
    assert pwarm.length.tolist() == [pre + (n_suf if true_n is None else true_n)]

    jscaf = jcache.splice_prefix_chunks(jcfg, jcache.init_layer_cache(jcfg), 0, [
        {f: jnp.asarray(to_np(t)).astype(t.dtype == torch.bfloat16 and jnp.bfloat16
                                          or jnp.int32) for f, t in c.items()} for c in chunks])
    tn = None if not padded else jnp.int32(true_n)
    jwarm, jout = jax.jit(lambda c0, a, b, c, t: jcache.streaming_prefill_layer_cache(
        jcfg, c0, a, b, c, scale, start_chunk=2, tail_is_padded=padded, true_n=t))(
        jscaf, q[:, :, pre:], k[:, :, pre:], v[:, :, pre:], tn)
    _assert_chunks_equal(pwarm, jwarm)
    real = n_suf if true_n is None else true_n
    np.testing.assert_allclose(to_np(pout)[:, :, :real], to_np(jout)[:, :, :real],
                               atol=OUT_ATOL)


# ---------------------------------------------------------------------------
# the engine


@pytest.fixture(scope="module")
def smoke():
    """Both packages' smoke llama2-7b on the reference's parameters (head_dim
    16), and a head_dim-64 variant for gear_kivi2, whose 64-wide V groups
    need Dh >= 64 to take the streaming layout."""
    out = {}
    for name, over in (("dh16", {}), ("dh64", {"head_dim": 64})):
        rcfg = dataclasses.replace(ref_smoke_config("llama2-7b"), **over)
        ref_model = ref_build_model(rcfg)
        ref_params = ref_model.init(jax.random.PRNGKey(0))
        cfg = dataclasses.replace(smoke_config("llama2-7b"), **over)
        params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
        out[name] = (ref_model, ref_params, build_model(cfg), params)
    return out


def shared_prompts(vocab: int = 512):
    """A 2-chunk system prompt shared by every request, then suffixes of
    raw length 1 (a padded tail), 64 (aligned), 100 (one closed chunk and a
    padded tail), 30 and 150, numpy seed 0."""
    rng = np.random.RandomState(0)
    system = rng.randint(4, vocab, size=2 * NB)
    return [np.concatenate([system, rng.randint(4, vocab, size=n)]).astype(np.int32)
            for n in (100, 1, 64, 30, 150)]


def ecfg(polname="gear_kcvt4", batch=2, **kw):
    return EngineConfig(batch=batch, capacity=CAP, policy=named_policy(polname), eos_id=EOS,
                        prefill_mode="streaming", **kw)


def slot_dense(eng, view, slot: int) -> list:
    """Every leaf of ``slot``'s cache, per layer (paged: gathered from the
    pool through the slot's block-table row)."""
    out = []
    for lyr in view.caches:
        if eng.ecfg.layout == "paged":
            lyr = cache.paged_to_dense(eng._ccfg, lyr, eng.block_tables.device)
        out.append({f: t[slot].clone() for f, t in lyr.tensors().items()})
    return out


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_warm_prefill_equals_cold_bit_for_bit(smoke, layout):
    """Each request through a warm engine (prefix cache on) and a cold one:
    prefill logits and the slot's whole cache bit-equal, request after
    request, while the trie serves the shared system prompt (hits of 2
    chunks) and each request's own closed chunks (a repeat hits 3)."""
    _, _, model, params = smoke["dh16"]
    cold = Engine(model, params, ecfg(layout=layout), device="cpu")
    warm = Engine(model, params, ecfg(layout=layout, prefix_cache=True), device="cpu")
    vc, vw = cold.new_view(), warm.new_view()
    prompts = shared_prompts()
    for i, p in enumerate(prompts + [prompts[0]]):
        slot = i % 2
        lc = vc.prefill_slot({"tokens": p[None]}, slot, reserve_tokens=len(p) + 8)
        lw = vw.prefill_slot({"tokens": p[None]}, slot, reserve_tokens=len(p) + 8)
        assert torch.equal(lc, lw), i
        for a, b in zip(slot_dense(cold, vc, slot), slot_dense(warm, vw, slot)):
            for f in a:
                assert torch.equal(a[f], b[f]), (i, f)
    st = warm.prefix_cache.stats
    assert st["hit_chunks"] == 4 * 2 + 3 and st["prefill_toks_saved"] == 11 * NB
    assert warm.audit()["ok"], warm.audit()["issues"]
    if layout == "paged":
        warm.pool.check()
        # the system prompt's two pages are shared by both slots and the trie
        shared = warm.pool.block_tables[:, :2]
        assert (shared[0] == shared[1]).all()
        assert [warm.pool.refcount(int(p)) for p in shared[0]] == [3, 3]


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_run_continuous_warm_equals_cold_tokens(smoke, layout):
    """Continuous batching with the prefix cache on and off: identical greedy
    tokens per request; this run's hit rate and saved tokens are reported,
    and a replay hits every eligible chunk (dense: the trie outlives a run;
    paged: each run starts a new pool and trie)."""
    _, _, model, params = smoke["dh16"]
    prompts = shared_prompts()

    def run(eng):
        sched = Scheduler(eng)
        for rid, p in enumerate(prompts):
            sched.submit(Request(rid=rid, tokens=p, max_new_tokens=6))
        return {r.rid: r.tokens for r in sched.run_continuous()}, sched.last_stats

    off, _ = run(Engine(model, params, ecfg(layout=layout), device="cpu"))
    warm = Engine(model, params, ecfg(layout=layout, prefix_cache=True), device="cpu")
    on, stats = run(warm)
    for rid in off:
        np.testing.assert_array_equal(on[rid], off[rid])
    eligible = sum((len(p) - 1) // NB for p in prompts)
    assert 0 < stats["prefix_hit_rate"] < 1 and stats["prefill_toks_saved"] >= 8 * NB
    _, again = run(warm)
    want = 1.0 if layout == "dense" else stats["prefix_hit_rate"]
    assert again["prefix_hit_rate"] == want
    if layout == "dense":
        assert again["prefill_toks_saved"] == eligible * NB
    assert warm.audit()["ok"]


def margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def _record_prefills(eng, log: list, ref: bool):
    """Wrap ``eng.prefill_slot`` to log, after every call, the bookkeeping
    (block tables, refcounts, trie stats), the logits and the batch-1
    cache's layer-0 closed chunks."""
    real = eng.prefill_slot

    def wrapped(batch1, caches, slot, admit=True, reserve_tokens=None):
        logits, caches = real(batch1, caches, slot, admit=admit, reserve_tokens=reserve_tokens)
        pool = eng.pool
        pc = eng.prefix_cache
        book = {"slot": slot, "trie": pc.snapshot().as_dict(),
                "live": sorted(int(h) for h in pc.live_handles()) if pool is not None else None}
        if pool is not None:
            book.update(tables=pool.block_tables.tolist(),
                        refs=[pool.refcount(p) for p in range(pool.n_pages)],
                        pool=pool.snapshot().as_dict())
        if ref:                                 # a copy of layer 0 (repeat axis 0)
            layer0 = jax.tree.map(lambda x: np.asarray(x[0]), caches[0])
        else:
            layer0 = dataclasses.replace(caches[0], **{
                f: t.clone() for f, t in caches[0].tensors().items()})
        log.append((book, to_np(logits[0, -1]), np.asarray(batch1["tokens"])[0], slot, layer0))
        return logits, caches

    eng.prefill_slot = wrapped


@pytest.mark.parametrize("layout,polname", [("dense", "gear_kcvt4"), ("paged", "gear_kcvt4"),
                                            ("paged", "gear_kivi2")])
def test_engine_matches_reference_engine(smoke, layout, polname):
    """The same request sequence through the port's and the reference's
    engines with ``prefix_cache=True`` (``run_continuous``, batch 2): after
    every prefill the block tables, page refcounts, pool counters, trie
    handles and trie stats are equal; every prefill's logits are within
    PREFILL_LOGIT_ATOL and its slot's layer-0 closed chunks bit-equal
    (low-rank 1e-2); greedy tokens follow the margin rule and each request
    ends OK."""
    ref_model, ref_params, model, params = smoke["dh64" if polname == "gear_kivi2" else "dh16"]
    kw = dict(layout=layout, prefix_cache=True)
    ref_eng = RefEngine(ref_model, ref_params, RefEngineConfig(
        batch=2, capacity=CAP, policy=jnamed(polname), eos_id=EOS, prefill_mode="streaming",
        **kw))
    eng = Engine(model, params, ecfg(polname, **kw), device="cpu")
    logs = {"ref": [], "port": []}
    _record_prefills(ref_eng, logs["ref"], ref=True)
    _record_prefills(eng, logs["port"], ref=False)
    prompts = shared_prompts()[:3]
    budgets = [6, 12, 3]
    ref_sched, sched = RefScheduler(ref_eng), Scheduler(eng)
    for rid, (p, b) in enumerate(zip(prompts, budgets)):
        ref_sched.submit(RefRequest(rid=rid, tokens=p, max_new_tokens=b))
        sched.submit(Request(rid=rid, tokens=p, max_new_tokens=b))
    ref = {r.rid: r.tokens for r in ref_sched.run_continuous()}
    port = {r.rid: r for r in sched.run_continuous()}
    assert sched.last_stats["statuses"] == {"ok": len(prompts)}
    for key in ("prefix_hit_rate", "prefill_toks_saved", "prefix_evictions"):
        assert sched.last_stats[key] == ref_sched.last_stats[key], key
    assert sched.last_stats["prefix"].as_dict() == ref_sched.last_stats["prefix"].as_dict()
    assert len(logs["port"]) == len(logs["ref"]) == len(prompts)
    jcfg1 = jcache.CacheConfig(batch=2, kv_heads=eng._ccfg.kv_heads, head_dim=eng._ccfg.head_dim,
                               capacity=CAP, policy=jnamed(polname))
    H, r = eng._ccfg.kv_heads, eng._ccfg.policy.rank
    atol = KIVI2_DH64_PREFILL_ATOL if polname == "gear_kivi2" else PREFILL_LOGIT_ATOL
    cold = Engine(model, params, ecfg(polname), device="cpu").new_view()
    for (pb, pl, toks, slot, p0), (rb, rl, _, _, r0) in zip(logs["port"], logs["ref"]):
        n = len(toks)
        assert pb == rb
        assert np.abs(pl - rl).max() <= atol
        lc = cold.prefill_slot({"tokens": toks[None]}, 0)
        np.testing.assert_array_equal(to_np(lc[0, -1]), pl)
        if layout == "paged":
            p0 = cache.paged_to_dense(eng._ccfg, p0,
                                      torch.as_tensor(np.asarray(pb["tables"], np.int32)))
            r0 = jcache.paged_to_dense(jcfg1, jax.tree.map(jnp.asarray, r0),
                                       jnp.asarray(pb["tables"], jnp.int32))
        closed = slice(0, n // NB * NB)
        for f in ("k_packed", "v_packed", "v_scale", "v_zero", "v_sp_val", "v_sp_idx"):
            np.testing.assert_array_equal(to_np(getattr(p0, f))[slot, :, closed],
                                          to_np(getattr(r0, f))[slot, :, closed], err_msg=f)
        for f in ("k_scale", "k_zero", "k_sp_val", "k_sp_idx"):
            np.testing.assert_array_equal(to_np(getattr(p0, f))[slot, :, :n // NB],
                                          to_np(getattr(r0, f))[slot, :, :n // NB], err_msg=f)
        for kv in ("k", "v"):
            ab = [to_np(getattr(c, f"{kv}_a"))[slot, :, closed].reshape(H, -1, NB, r)
                  @ np.swapaxes(to_np(getattr(c, f"{kv}_b"))[slot, :, :n // NB], -1, -2)
                  for c in (p0, r0)]
            assert np.linalg.norm(ab[0] - ab[1]) <= 1e-2 * np.linalg.norm(ab[1]), kv
    for rid in ref:
        got, want = port[rid].tokens, ref[rid]
        assert len(got) == budgets[rid] or got[-1] == EOS
        if polname == "gear_kcvt4":
            np.testing.assert_array_equal(got, want, err_msg=f"rid {rid}")
        elif margin(logs["ref"][rid][1]) > PREFILL_MARGIN:
            assert got[0] == want[0], rid


def compression_witness(pair, prompt: np.ndarray, polname: str = "gear_kivi2",
                        eager: bool = False) -> dict:
    """The port's and the reference's cold streaming prefill of ``prompt``,
    with the input of every compression event recorded in both; then the
    reference again with the port's inputs in place of its own (and, with
    ``eager``, once more with its scan bodies run op by op: the reference
    against its own rounding).  Returns the readings: max |Δ logit| of each
    pair, and per layer how many compressed K/V inputs differ (and by how
    many bf16 ulps of the reference's value at most) and how many packed
    code words of the closed chunks differ, before and after the swap."""
    from repro.kernels import ops as jops

    ref_model, ref_params, model, params = pair
    cfg = model.cfg
    rpol, pol = jnamed(polname), named_policy(polname)
    L, H, C = cfg.num_layers, cfg.num_kv_heads, len(prompt) // NB
    port_x, ref_x, swap = [], [], {"on": False, "i": 0}
    real_port, real_ref = cache.gear_compress, jops.gear_compress_chunks

    def port_hook(x, **kw):
        port_x.append(x.numpy().copy())
        return real_port(x, **kw)

    def next_port_input(x):
        out = port_chunks[swap["i"]].reshape(x.shape)
        swap["i"] += 1
        return out

    def ref_hook(x, **kw):
        if swap["on"]:
            x = jax.pure_callback(next_port_input, jax.ShapeDtypeStruct(x.shape, x.dtype), x)
        else:
            jax.debug.callback(lambda v: ref_x.append(np.asarray(v)), x, ordered=True)
        return real_ref(x, **kw)

    def ref_prefill():
        logits, caches = ref_model.prefill(ref_params, {"tokens": jnp.asarray(prompt[None])},
                                           rpol, CAP, prefill_mode="streaming")
        jax.effects_barrier()
        return (to_np(logits[0, -1]),           # per layer (repeat axis 0)
                [jax.tree.map(lambda x, i=i: np.asarray(x[i]), caches[0]) for i in range(L)])

    def code_diffs(a, b):
        return [tuple(int((to_np(getattr(a[i], f))[:, :, :C * NB]
                           != to_np(getattr(b[i], f))[:, :, :C * NB]).sum())
                      for f in ("k_packed", "v_packed")) for i in range(L)]

    cache.gear_compress, jops.gear_compress_chunks = port_hook, ref_hook
    try:
        logits, port_caches = model.prefill(params, {"tokens": prompt[None]}, pol, CAP,
                                            prefill_mode="streaming")
        port_logits = to_np(logits[0, -1])
        ref_logits, ref_caches = ref_prefill()
        # the reference compresses chunk by chunk (K, then V), the port each
        # layer's chunks in one event ([H * C, nb, Dh] for B = 1)
        port_chunks = [port_x[2 * i + kv].reshape(H, C, NB, -1)[:, c]
                       for i in range(L) for c in range(C) for kv in range(2)]
        assert len(ref_x) == len(port_chunks)
        inputs = []
        for i in range(L):
            got = np.stack(port_chunks[2 * C * i:2 * C * (i + 1)])
            want = np.stack(ref_x[2 * C * i:2 * C * (i + 1)]).reshape(got.shape)
            ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126))) - 7)
            ulps = np.abs(got - want) / ulp
            inputs.append((int((ulps > 0).sum()), want.size, float(ulps.max())))
        swap["on"] = True
        swapped_logits, swapped_caches = ref_prefill()
        out = {"gap": float(np.abs(port_logits - ref_logits).max()),
               "gap_swapped": float(np.abs(port_logits - swapped_logits).max()),
               "swapped_events": swap["i"], "events": len(port_chunks), "inputs": inputs,
               "codes": code_diffs(port_caches, ref_caches),
               "codes_swapped": code_diffs(port_caches, swapped_caches)}
        swap["on"] = False
        if eager:
            with jax.disable_jit():
                eager_logits, eager_caches = ref_prefill()
            out["ref_gap_eager"] = float(np.abs(ref_logits - eager_logits).max())
            out["ref_codes_eager"] = code_diffs(eager_caches, ref_caches)
        return out
    finally:
        cache.gear_compress, jops.gear_compress_chunks = real_port, real_ref


def test_kivi2_dh64_gap_comes_from_compression_input_rounding(smoke):
    """Witness for ``KIVI2_DH64_PREFILL_ATOL``: on the prompt that sets it
    (shared_prompts()[3], 0.227), the K/V that layer 0 compresses differ
    from the reference's in a handful of elements by rounding only, and
    with the port's compression inputs in place of its own, the reference
    stores the port's codes in every layer and its logits come within
    PREFILL_LOGIT_ATOL of the port's."""
    w = compression_witness(smoke["dh64"], shared_prompts()[3])
    n_diff, n_all, _ = w["inputs"][0]
    assert n_diff <= 1e-3 * n_all, w["inputs"]
    assert w["gap"] <= KIVI2_DH64_PREFILL_ATOL, w
    assert w["swapped_events"] == w["events"], w
    assert all(k == v == 0 for k, v in w["codes_swapped"]), w["codes_swapped"]
    assert w["gap_swapped"] <= PREFILL_LOGIT_ATOL, w


def test_warm_decode_follows_reference(smoke):
    """Teacher-forced along the reference's greedy tokens, a warm request's
    decode logits (its prefix spliced from pool pages another request left
    in the trie) stay within DECODE_LOGIT_ATOL of the reference's until its
    first decode chunk close."""
    ref_model, ref_params, model, params = smoke["dh16"]
    pol = jnamed("gear_kcvt4")
    eng = Engine(model, params, ecfg(batch=1, layout="paged", prefix_cache=True), device="cpu")
    view = eng.new_view()
    prompts = shared_prompts()
    view.prefill_slot({"tokens": prompts[0][None]}, 0, reserve_tokens=len(prompts[0]) + 2)
    step = jax.jit(lambda p, t, c, pos: ref_model.decode_step(p, {"tokens": t}, c, pos, pol, CAP))
    for p in prompts[2:3]:
        n = len(p)
        logits_r, caches_r = ref_model.prefill(ref_params, {"tokens": jnp.asarray(p[None])}, pol,
                                               CAP, prefill_mode="streaming")
        hits = eng.prefix_cache.stats["hit_chunks"]
        logits = view.prefill_slot({"tokens": p[None]}, 0, reserve_tokens=n + 24)
        assert eng.prefix_cache.stats["hit_chunks"] == hits + 2
        for i in range(24):
            err = np.abs(to_np(logits[0, -1]) - to_np(logits_r[0, -1])).max()
            assert err <= (DECODE_LOGIT_ATOL if i else PREFILL_LOGIT_ATOL), (n, i, err)
            if (n + i + 1) // NB > n // NB:
                break                              # the next step closes a chunk
            tok = int(np.argmax(to_np(logits_r[0, -1])))
            logits_r, caches_r = step(ref_params, jnp.asarray([[tok]], jnp.int32), caches_r,
                                      jnp.asarray([n + i], jnp.int32))
            logits = view.decode({"tokens": np.array([[tok]], np.int32)}, np.array([n + i]))
    eng.pool.check()


def test_reclaim_valve_matches_reference(smoke):
    """A pool of 10 pages (9 allocatable) under a trie that keeps every
    request's closed chunks: the head cannot fit with every slot idle, the
    scheduler reclaims trie pages, every request ends OK, and the pool and
    trie bookkeeping (evictions, pages freed) equal the reference's."""
    ref_model, ref_params, model, params = smoke["dh16"]
    rng = np.random.RandomState(4)
    prompts = [rng.randint(4, 512, size=n).astype(np.int32) for n in (260, 250, 200)]
    kw = dict(layout="paged", prefix_cache=True, pool_pages=10)
    ref_eng = RefEngine(ref_model, ref_params, RefEngineConfig(
        batch=2, capacity=CAP, policy=jnamed("gear_kcvt4"), eos_id=-1, prefill_mode="streaming",
        **kw))
    eng = Engine(model, params, dataclasses.replace(ecfg(**kw), eos_id=-1), device="cpu")
    reclaims = []
    real = eng.reclaim_pages
    eng.reclaim_pages = lambda n: reclaims.append(real(n)) or reclaims[-1]
    ref_sched, sched = RefScheduler(ref_eng), Scheduler(eng)
    for rid, p in enumerate(prompts):
        ref_sched.submit(RefRequest(rid=rid, tokens=p, max_new_tokens=4))
        sched.submit(Request(rid=rid, tokens=p, max_new_tokens=4))
    ref_sched.run_continuous()
    out = sched.run_continuous()
    assert [str(r.status) for r in out] == ["ok"] * 3
    assert reclaims and reclaims[0] > 0
    assert sched.last_stats["prefix_evictions"] == ref_sched.last_stats["prefix_evictions"] > 0
    assert sched.last_stats["pool"].as_dict() == ref_sched.last_stats["pool"].as_dict()
    assert eng.audit()["ok"], eng.audit()["issues"]


def test_admission_off_budget_and_store_bytes(smoke):
    """``prefix_admission="off"`` reuses nothing new and inserts nothing; a
    budget of two chunks' payload evicts while serving stays equal to the
    unbounded engine; the store's bytes equal the trie's."""
    _, _, model, params = smoke["dh16"]
    prompts = shared_prompts()
    eng = Engine(model, params, ecfg(prefix_cache=True), device="cpu")
    sched = Scheduler(eng, prefix_admission="off")
    for rid, p in enumerate(prompts[:3]):
        sched.submit(Request(rid=rid, tokens=p, max_new_tokens=2))
    sched.run_continuous()
    st = eng.prefix_cache.stats
    assert st["inserts"] == 0 and st["hit_chunks"] == 0
    with pytest.raises(ValueError, match="prefix_admission"):
        Scheduler(eng, prefix_admission="some")

    full = Engine(model, params, ecfg(prefix_cache=True), device="cpu")
    v = full.new_view()
    v.prefill_slot({"tokens": prompts[0][None]}, 0)
    per_chunk = full.prefix_cache.stats["bytes"] // full.prefix_cache.stats["nodes"]
    outs = {}
    for name, budget in (("small", 2 * per_chunk), ("big", 256 << 20)):
        e = Engine(model, params, ecfg(prefix_cache=True, prefix_cache_bytes=budget),
                   device="cpu")
        s = Scheduler(e)
        for rid, p in enumerate(prompts):
            s.submit(Request(rid=rid, tokens=p, max_new_tokens=3))
        outs[name] = {r.rid: r.tokens for r in s.run_continuous()}
        st = e.prefix_cache.stats
        assert e.prefix_cache.store.total_bytes == st["bytes"] <= budget
        if name == "small":
            assert st["evictions"] > 0
    for rid in outs["big"]:
        np.testing.assert_array_equal(outs["small"][rid], outs["big"][rid])


def test_set_params_and_ttl_invalidate(smoke):
    """A weight swap bumps the version and nothing cached before it is
    reused; with a TTL, a request after expiry recomputes and still equals
    the cold engine bit for bit (the engine's injected clock)."""
    _, _, model, params = smoke["dh16"]
    p = shared_prompts()[0]
    eng = Engine(model, params, ecfg(prefix_cache=True), device="cpu")
    v = eng.new_view()
    v.prefill_slot({"tokens": p[None]}, 0)
    assert eng.prefix_cache.stats["nodes"] == 3
    eng.set_params(params)
    assert eng.weight_version == 1
    v.prefill_slot({"tokens": p[None]}, 1)
    st = eng.prefix_cache.stats
    assert st["version_evictions"] == 3 and st["hit_chunks"] == 0 and st["nodes"] == 3
    assert eng.prefix_cache.store.total_bytes == st["bytes"]

    clock = FakeClock()
    cold = Engine(model, params, ecfg(), device="cpu")
    ttl = Engine(model, params, ecfg(prefix_cache=True, prefix_cache_ttl=30.0), device="cpu",
                 clock=clock)
    vc, vt = cold.new_view(), ttl.new_view()
    lc = vc.prefill_slot({"tokens": p[None]}, 0)
    vt.prefill_slot({"tokens": p[None]}, 0)
    clock.t = 31.0
    lt = vt.prefill_slot({"tokens": p[None]}, 1)
    st = ttl.prefix_cache.stats
    assert st["expiries"] == 3 and st["hit_chunks"] == 0
    assert torch.equal(lc, lt)


def test_config_validation_and_unsupported_reasons(smoke):
    """The reference's errors: prefix_cache needs streaming prefill; bad
    lifecycle knobs; the models and policies the prefix cache cannot take
    (hymba, rwkv6-3b, an fp16 policy) name the reference's reason."""
    from repro.serving.engine import prefix_cache_unsupported_reason as ref_reason
    from repro_torch.serving.engine import prefix_cache_unsupported_reason

    pol = named_policy("gear_kcvt4")
    with pytest.raises(ValueError, match="prefix_cache requires prefill_mode='streaming'"):
        EngineConfig(batch=1, capacity=CAP, policy=pol, prefix_cache=True)
    with pytest.raises(ValueError, match="prefix_cache_eviction"):
        ecfg(prefix_cache=True, prefix_cache_eviction="mru")
    with pytest.raises(ValueError, match="prefix_cache_ttl"):
        ecfg(prefix_cache=True, prefix_cache_ttl=-1.0)
    with pytest.raises(ValueError, match="require prefix_cache"):
        ecfg(prefix_cache_ttl=5.0)
    from repro.core.policy import FP16 as REF_FP16

    for arch, rpol, ppol in (("hymba-1.5b", jnamed("gear_kcvt4"), pol),
                             ("rwkv6-3b", jnamed("gear_kcvt4"), pol),
                             ("llama2-7b", REF_FP16, FP16)):
        want = ref_reason(ref_smoke_config(arch), rpol, CAP)
        assert want is not None
        assert prefix_cache_unsupported_reason(smoke_config(arch), ppol, CAP) == want
        cfg = smoke_config(arch)
        model = build_model(cfg)
        with pytest.raises(ValueError, match=f"prefix_cache unsupported here: {want}"):
            Engine(model, model.init(seed=0, device="cpu"),
                   EngineConfig(batch=1, capacity=CAP, policy=ppol, prefill_mode="streaming",
                                prefix_cache=True), device="cpu")
    assert prefix_cache_unsupported_reason(smoke_config("llama2-7b"), pol, CAP) is None


def test_kernel_operands_are_contiguous_on_short_prefills(smoke, monkeypatch):
    """The kernels take contiguous operands only; their CPU twins take any
    layout, so a view that only the card would refuse is caught here: a
    streaming prefill that closes exactly one chunk beside a tail block (a
    cold 100-token prompt; a warm suffix of 100) hands ``gear_compress`` its
    K / V tiles, and a one-block prefill (a warm suffix of 1 or 64 tokens)
    hands ``flash_prefill_block`` its ``kv_len``, both contiguous."""
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops

    seen = {"compress": 0, "block": 0}
    real_compress, real_block = cache.gear_compress, ops.flash_prefill_block

    def compress(x, **kw):
        assert x.is_contiguous(), tuple(x.shape)
        seen["compress"] += 1
        return real_compress(x, **kw)

    def block(q, k, v, kv_len, **kw):
        assert all(t.is_contiguous() for t in (q, k, v, kv_len)), tuple(kv_len.shape)
        seen["block"] += 1
        return fp.flash_prefill_block(q, k, v, kv_len, **kw)

    monkeypatch.setattr(cache, "gear_compress", compress)
    monkeypatch.setattr(ops, "flash_prefill_block", block)
    _, _, model, params = smoke["dh16"]
    eng = Engine(model, params, ecfg(batch=1, prefix_cache=True), device="cpu")
    view = eng.new_view()
    rng = np.random.RandomState(7)
    system = rng.randint(4, 512, size=2 * NB)
    view.prefill_slot({"tokens": rng.randint(4, 512, size=(1, 100)).astype(np.int32)}, 0)
    for n in (100, 1, 64):
        p = np.concatenate([system, rng.randint(4, 512, size=n)]).astype(np.int32)[None]
        view.prefill_slot({"tokens": p}, 0)
    assert eng.prefix_cache.stats["hit_chunks"] == 2 * 2
    assert seen["compress"] > 0 and seen["block"] > 0


if __name__ == "__main__":
    # readings behind KIVI2_DH64_PREFILL_ATOL (ROADMAP §3): the witness on
    # the shared prompts and on five random prompts (numpy seeds 0-4, raw
    # length 130-299), for gear_kivi2 and gear_kcvt4 on the head_dim-64 model
    import sys

    pair = smoke.__wrapped__()["dh64"]
    prompts = [(f"shared_prompts()[{i}]", p) for i, p in enumerate(shared_prompts())]
    for seed in range(5):
        rng = np.random.RandomState(seed)
        prompts.append((f"seed {seed}", rng.randint(4, 512, size=rng.randint(130, 300))
                        .astype(np.int32)))
    for polname in sys.argv[1:] or ["gear_kivi2", "gear_kcvt4"]:
        for label, prompt in prompts:
            print(polname, label, len(prompt), compression_witness(pair, prompt, polname,
                                                                   eager=True), flush=True)
