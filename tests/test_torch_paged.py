"""The port's paged compressed KV pool and the streaming + paged serving path
against the JAX reference's.

Same numpy-seeded inputs go to both packages; the port's CPU tensors take
the plain kernel versions.  What is held, and how:

* paged cache functions (``init_paged_layer_cache``, ``scatter_pool_chunks``,
  ``zero_pool_pages``, ``gather_pool_chunks``, ``paged_to_dense``,
  ``append_token_paged``): every leaf bit-equal to the reference's (a
  closing decode chunk's low-rank factors through ``A·Bᵀ`` within 1e-2
  relative, the rule of ``test_torch_core``), and paged ≡ dense bit for bit
  within the port;
* ``gear_decode_paged`` plain version vs ``gear_decode_paged_ref``: 1e-4 on
  the normalized output and score max (f32 both sides);
* ``PagePool``: block tables identical to the reference allocator's over
  the same admit/release sequence, and ``check()`` after every step;
* the whole slice: ``Engine(prefill_mode="streaming", layout="paged")`` +
  ``Scheduler.run_continuous`` against the reference engine of the same
  config on mixed raw prompt lengths.  Activations are bf16 in both and
  round after differently ordered sums, so greedy tokens are held by the
  margin rule of ``test_torch_serving``: a token must equal the
  reference's wherever the reference's top-1/top-2 logit margin exceeds
  0.125 (the first token, from prefill logits) or 0.3 (decode steps); a
  request's comparison stops at its first step below the margin.  Along
  the reference's tokens (teacher forcing), the port's logits stay within
  0.1 after prefill (measured 0.065) and 0.125 at decode steps before the
  first decode chunk close (measured 0.086); a chunk closed on K/V one
  bf16 ulp apart gets visibly different low-rank factors, so later steps
  have no bound (PR 11's monolithic path moves by up to 1.0 there too).
  Within the port, the paged engine equals the dense one bit for bit.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving.pagedpool import PagePool as RefPagePool  # noqa: E402
from repro.serving.scheduler import Request as RefRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as RefScheduler  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import gear_decode as gd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.pagedpool import PagePool, PoolExhausted, pages_needed  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

DECODE_ATOL = 1e-4
PREFILL_MARGIN = 0.125
DECODE_MARGIN = 0.3
PREFILL_LOGIT_ATOL = 0.1
DECODE_LOGIT_ATOL = 0.125
POLICIES = ["gear_kcvt4", "gear_kivi2"]


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


def cfgs(polname, B, H=2, Dh=64, S=256):
    return (jcache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                               policy=jnamed(polname)),
            cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                              policy=named_policy(polname)))


def one_prefill(polname, n=200, seed=0):
    """A batch-1 cache of ``n`` prefilled tokens in both packages (the
    port's from the reference's leaves)."""
    jcfg1, pcfg1 = cfgs(polname, 1)
    k, v = bf16((1, 2, n, 64), seed), bf16((1, 2, n, 64), seed + 1)
    jc = jax.jit(lambda a, b: jcache.prefill_layer_cache(
        jcfg1, jcache.init_layer_cache(jcfg1), a, b))(k, v)
    pc = cache.GEARLayerCache(**{f: None if getattr(jc, f) is None else to_t(getattr(jc, f))
                                 for f in cache.FIELDS})
    return jcfg1, pcfg1, jc, pc


def assert_leaves_equal(port, ref, fields):
    for f in fields:
        r, p = getattr(ref, f), getattr(port, f)
        assert (r is None) == (p is None), f
        if r is not None:
            assert str(p.dtype).split(".")[-1] == str(r.dtype), f
            np.testing.assert_array_equal(to_np(p), to_np(r), err_msg=f)


@pytest.mark.parametrize("polname", POLICIES)
def test_paged_cache_functions_match_reference(polname):
    """Pool geometry, then one admission's device work: zero the reserved
    pages, scatter the prefill's closed chunks, gather them back."""
    jcfg1, pcfg1, jc, pc = one_prefill(polname)
    jcfg, pcfg = cfgs(polname, 3)
    assert cache.page_nbytes(pcfg) == jcache.page_nbytes(jcfg)
    shapes = cache.page_field_shapes(pcfg)
    for f, (shape, dt) in jcache.page_field_shapes(jcfg).items():
        assert shapes[f][0] == shape and str(shapes[f][1]).split(".")[-1] == str(dt), f

    P = 9
    jp = jcache.init_paged_layer_cache(jcfg, P)
    pp = cache.init_paged_layer_cache(pcfg, P, device="cpu")
    assert_leaves_equal(pp, jp, cache.FIELDS)
    # dirty every page so zeroing shows, then admit pages [5, 2, 7] (3 closed chunks)
    for f in cache.POOLED_FIELDS:
        if getattr(pp, f) is not None:
            fill = np.random.RandomState(1).randint(1, 9, getattr(jp, f).shape)
            jp = dataclasses.replace(jp, **{f: jnp.asarray(fill).astype(getattr(jp, f).dtype)})
            getattr(pp, f).copy_(torch.from_numpy(fill))
    pages, zero = [5, 2, 7], [4, 8]
    jp = jcache.zero_pool_pages(jcfg1, jp, jnp.asarray(zero))
    jp = jcache.scatter_pool_chunks(jcfg1, jp, jnp.asarray(pages),
                                    jcache.extract_prefix_chunks(jcfg1, jc, 3))
    cache.zero_pool_pages(pcfg1, pp, torch.tensor(zero))
    cache.scatter_pool_chunks(pcfg1, pp, torch.tensor(pages),
                              cache.extract_prefix_chunks(pcfg1, pc, 3))
    assert_leaves_equal(pp, jp, cache.POOLED_FIELDS)

    back = cache.gather_pool_chunks(pcfg1, pp, torch.tensor(pages))
    want = jcache.gather_pool_chunks(jcfg1, jp, jnp.asarray(pages))
    for b, w, e in zip(back, want, cache.extract_prefix_chunks(pcfg1, pc, 3)):
        for f in w:
            np.testing.assert_array_equal(to_np(b[f]), to_np(w[f]), err_msg=f)
            assert torch.equal(b[f], e[f]), f

    bt = np.zeros((3, 4), np.int32)
    bt[1, :3] = pages
    bt[2, :2] = zero
    dense_j = jcache.paged_to_dense(jcfg, jp, jnp.asarray(bt))
    dense_p = cache.paged_to_dense(pcfg, pp, torch.from_numpy(bt))
    assert_leaves_equal(dense_p, dense_j, cache.POOLED_FIELDS)
    for f in cache.POOLED_FIELDS:                 # slot 1 holds the prefill's chunks
        if getattr(pc, f) is not None:
            rows = cache._chunk_row_axes(pcfg1)[f][0] * 3
            ax = getattr(pc, f).dim() + cache._chunk_row_axes(pcfg1)[f][1]
            assert torch.equal(getattr(dense_p, f)[1:2].narrow(ax, 0, rows),
                               getattr(pc, f).narrow(ax, 0, rows)), f


@pytest.mark.parametrize("polname", POLICIES)
def test_append_token_paged_matches_reference_and_dense(polname):
    """Three slots: slot 0 closes chunk 1 into its page, slot 1 is idle
    (an all-zero table row) and crosses a chunk boundary, slot 2 closes a
    chunk past its reservation.  The pool equals the reference's, page 0
    stays zero, and gathering the pool gives the port's dense cache for the
    live slot."""
    jcfg, pcfg = cfgs(polname, 3)
    P = 6
    bt = np.zeros((3, 4), np.int32)
    bt[0, :2] = [3, 1]
    bt[2, :1] = [5]
    lengths = np.array([126, 63, 127])
    jp = jcache.init_paged_layer_cache(jcfg, P)
    jp = dataclasses.replace(jp, length=jnp.asarray(lengths, jnp.int32),
                             buf_k=bf16((3, 2, 64, 64), 3), buf_v=bf16((3, 2, 64, 64), 4))
    pp = cache.PagedGEARLayerCache(**{f: None if getattr(jp, f) is None else to_t(getattr(jp, f))
                                      for f in cache.FIELDS})
    dense = cache.init_layer_cache(pcfg, device="cpu")
    for f in ("length", "buf_k", "buf_v"):
        getattr(dense, f).copy_(getattr(pp, f))
    step = jax.jit(lambda c, a, b: jcache.append_token_paged(jcfg, c, jnp.asarray(bt), a, b))
    for t in range(3):
        kt, vt = bf16((3, 2, 64), 10 + t), bf16((3, 2, 64), 20 + t)
        jp = step(jp, kt, vt)
        cache.append_token_paged(pcfg, pp, bt, to_t(kt), to_t(vt), lengths)
        cache.append_token(pcfg, dense, to_t(kt), to_t(vt), lengths)
        lengths = lengths + 1
    lowrank = ("k_a", "k_b", "v_a", "v_b")
    assert_leaves_equal(pp, jp, [f for f in cache.FIELDS if f not in lowrank])
    if pcfg.policy.use_lowrank:
        for kv in ("k", "v"):
            ab = [to_np(getattr(c, f"{kv}_a")) @ np.swapaxes(to_np(getattr(c, f"{kv}_b"))[:, :, 0],
                                                             -1, -2) for c in (pp, jp)]
            assert np.linalg.norm(ab[0] - ab[1]) <= 1e-2 * np.linalg.norm(ab[1]), kv
    for f, x in pp.tensors().items():
        if f in cache.POOLED_FIELDS:
            assert not x[0].any(), f"page 0 of {f} was written"
    assert pp.length.tolist() == [129, 66, 130]
    gathered = cache.paged_to_dense(pcfg, pp, torch.from_numpy(bt))
    for f in cache.POOLED_FIELDS:
        if getattr(dense, f) is not None:
            assert torch.equal(getattr(gathered, f)[0], getattr(dense, f)[0]), f


@pytest.mark.parametrize("polname", POLICIES)
def test_gear_decode_paged_plain_matches_reference(polname):
    """A shuffled block table whose entries past each slot's extent name
    the zero page; the plain paged decode also equals the dense decode on
    the gathered operands exactly."""
    H, Dh, nb, C = 2, 64, 64, 4
    rng = np.random.RandomState(7)
    P = 8
    bt = np.zeros((2, C), np.int32)
    bt[0, :3] = [6, 2, 4]
    bt[1, :2] = [1, 7]
    jcfg1, pcfg1, jc, pc = one_prefill(polname, n=256, seed=5)
    pools = {}
    for f, (rpc, ax) in cache._chunk_row_axes(pcfg1).items():
        x = to_np(getattr(jc, f))[0]                  # [H, C*rpc, ...]
        x = np.moveaxis(x.reshape(x.shape[:ax + x.ndim] + (C, rpc) + x.shape[x.ndim + ax + 1:]),
                        x.ndim + ax, 0)               # [C, H, rpc, ...]
        pool = np.zeros((P,) + x.shape[1:], x.dtype)
        pool[rng.permutation(np.arange(1, P))[:C]] = x
        pools[f] = pool.reshape((P * H,) + x.shape[2:])
    n_comp = np.repeat(np.array([192, 128], np.int32), H)
    q = rng.randn(2 * H, 1, Dh).astype(np.float32)
    kw = dict(bits=pcfg1.policy.bits, chunk=nb, scale_factor=Dh ** -0.5)
    names = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero")
    extra = [f for f in pools if f not in names]
    dt = {f: getattr(jc, f).dtype for f in pools}
    j_args = {f: jnp.asarray(pools[f]).astype(dt[f]) for f in pools}
    t_args = {f: to_t(j_args[f]) for f in pools}
    acc_r, m_r, l_r = jref.gear_decode_paged_ref(
        jnp.asarray(q), *[j_args[n] for n in names], jnp.asarray(n_comp), jnp.asarray(bt), **kw,
        **{f: j_args[f] for f in extra})
    acc, m, l = gd.gear_decode_paged(
        torch.from_numpy(q), *[t_args[n] for n in names], torch.from_numpy(n_comp),
        torch.from_numpy(bt), **kw, **{f: t_args[f] for f in extra})
    np.testing.assert_allclose((acc / l[..., None]).numpy(), np.asarray(acc_r / l_r[..., None]),
                               atol=DECODE_ATOL)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=DECODE_ATOL)
    g = ops.ref.gather_paged_operands(torch.from_numpy(bt), 2 * H, t_args)
    flat = gd.gear_decode(torch.from_numpy(q), *[g[n] for n in names], torch.from_numpy(n_comp),
                          **kw, **{f: g[f] for f in extra})
    for a, b in zip((acc, m, l), flat):
        assert torch.equal(a, b)


def test_page_pool_matches_reference_and_keeps_invariants():
    """Seeded admit/release interleavings: the same block tables and free
    counts as the reference allocator, ``check()`` after every step, and a
    refused admission changes nothing."""
    rng = np.random.RandomState(0)
    ref_pool, pool = RefPagePool(12, 3, 5, 100), PagePool(12, 3, 5, 100)
    exhausted = 0
    for _ in range(200):
        slot = int(rng.randint(3))
        if pool.slot_pages(slot).size and rng.rand() < 0.5:
            assert pool.release_slot(slot) == ref_pool.release_slot(slot)
        elif not pool.slot_pages(slot).size:
            n = int(rng.randint(1, 6))
            try:
                want = ref_pool.admit(slot, n)
            except Exception as e:                    # the reference's PoolExhausted
                assert type(e).__name__ == "PoolExhausted"
                with pytest.raises(PoolExhausted):
                    pool.admit(slot, n)
                exhausted += 1
            else:
                np.testing.assert_array_equal(pool.admit(slot, n), want)
        np.testing.assert_array_equal(pool.block_tables, ref_pool.block_tables)
        assert pool.free_pages == ref_pool.free_pages
        assert pool.can_admit(3) == ref_pool.can_admit(3)
        pool.check()
    assert exhausted > 0 and pool.stats["rejects"] == exhausted
    assert pages_needed(129, 64) == 3 and not pool.can_admit(6)
    with pytest.raises(ValueError):
        PagePool(1, 1, 1, 1)


def test_paged_init_runs_on_cuda_unless_the_cpu_is_named():
    _, pcfg = cfgs("gear_kcvt4", 1)
    if torch.cuda.is_available():
        assert cache.init_paged_layer_cache(pcfg, 3).k_packed.is_cuda
        assert cache.init_layer_cache(pcfg).k_packed.is_cuda
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cache.init_paged_layer_cache(pcfg, 3)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cache.init_layer_cache(pcfg)
    assert cache.init_paged_layer_cache(pcfg, 3, device="cpu").k_packed.device.type == "cpu"


CAP = 256
EOS = 3
# raw prompt lengths cross chunk boundaries (64) in every way: aligned,
# one token past, one token short, and long enough to close several chunks
WORKLOAD = [(150, 24), (64, 12), (40, 20), (129, 8), (191, 16), (70, 1)]


def workload():
    rng = np.random.RandomState(11)
    return [(rid, rng.randint(0, 512, size=n).astype(np.int32), b)
            for rid, (n, b) in enumerate(WORKLOAD)]


@pytest.fixture(scope="module")
def smoke_pair():
    ref_model = ref_build_model(ref_smoke_config("llama2-7b"))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = smoke_config("llama2-7b")
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_model, ref_params, build_model(cfg), params


def margin(logits) -> float:
    top2 = np.sort(np.asarray(logits, np.float32))[-2:]
    return float(top2[1] - top2[0])


def ref_logits_along(ref_eng, prompt, tokens):
    """The reference's logits behind each of ``tokens`` (greedy from
    ``prompt``), teacher-forced at batch 1 through its engine's own bucketed
    streaming prefill and a dense decode (its paged decode gives the same
    bits)."""
    n, (model, params, pol) = len(prompt), (ref_eng.model, ref_eng.params, ref_eng.ecfg.policy)
    logits, caches = ref_eng._cold_prefill({"tokens": jnp.asarray(prompt[None])})
    if not hasattr(ref_eng, "teacher_step"):
        ref_eng.teacher_step = jax.jit(
            lambda p, t, c, pos: model.decode_step(p, {"tokens": t}, c, pos, pol, CAP))
    step = ref_eng.teacher_step
    out = [logits[0, -1]]
    for i, tok in enumerate(tokens[:-1]):
        logits, caches = step(params, jnp.asarray([[tok]], jnp.int32), caches,
                              jnp.asarray([n + i], jnp.int32))
        out.append(logits[0, -1])
    return out


def run_port(model, params, **kw):
    eng = Engine(model, params, EngineConfig(batch=3, capacity=CAP,
                                             policy=named_policy("gear_kcvt4"), eos_id=EOS,
                                             prefill_mode="streaming", **kw), device="cpu")
    sched = Scheduler(eng)
    for rid, toks, budget in workload():
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=budget))
    results = {r.rid: r for r in sched.run_continuous()}
    return results, sched.last_stats, eng


def test_streaming_paged_engine_matches_reference_engine(smoke_pair):
    """The whole slice on the smoke llama2-7b: the port's streaming + paged
    engine and the reference's (CPU oracles) serve mixed raw-length prompts
    to identical greedy tokens; every request ends OK with its budget or
    EOS, and the pool's invariants hold."""
    ref_model, ref_params, model, params = smoke_pair
    ref_eng = RefEngine(ref_model, ref_params, RefEngineConfig(
        batch=3, capacity=CAP, policy=jnamed("gear_kcvt4"), eos_id=EOS,
        prefill_mode="streaming", layout="paged"))
    ref_sched = RefScheduler(ref_eng)
    for rid, toks, budget in workload():
        ref_sched.submit(RefRequest(rid=rid, tokens=toks, max_new_tokens=budget))
    ref = {r.rid: r for r in ref_sched.run_continuous()}
    port, stats, eng = run_port(model, params, layout="paged")
    assert stats["statuses"] == {"ok": len(WORKLOAD)} and stats["layout"] == "paged"
    eng.pool.check()
    notes, compared = [], 0
    along = {rid: ref_logits_along(ref_eng, toks, ref[rid].tokens) for rid, toks, _ in workload()}
    for rid, toks, budget in workload():
        want, got = ref[rid].tokens, port[rid].tokens
        assert len(got) == budget or got[-1] == EOS
        for i, (w, lg) in enumerate(zip(want, along[rid])):
            if margin(lg) <= (PREFILL_MARGIN if i == 0 else DECODE_MARGIN):
                notes.append(f"rid {rid}: stopped at token {i} (margin {margin(lg):.4f})")
                break
            assert i < len(got) and got[i] == w, f"rid {rid} token {i}"
            compared += 1
        else:
            np.testing.assert_array_equal(got, want)
    print("; ".join(notes))
    assert compared >= 3, notes

    # teacher-forced along the reference's tokens, through a batch-1 view
    solo = Engine(model, params, EngineConfig(batch=1, capacity=CAP,
                                              policy=named_policy("gear_kcvt4"),
                                              prefill_mode="streaming", layout="paged"),
                  device="cpu")
    for rid, toks, budget in workload():
        want, n = ref[rid].tokens, len(toks)
        view = solo.new_view()
        logits = view.prefill_slot({"tokens": toks[None]}, 0, reserve_tokens=n + budget)
        for i, lg in enumerate(along[rid]):
            if i:
                logits = view.decode({"tokens": np.array([[want[i - 1]]])}, np.array([n + i - 1]))
            if (n + i) // 64 > n // 64:
                break                      # past the first decode chunk close
            err = np.abs(logits[0, -1].float().numpy() - np.asarray(lg, np.float32)).max()
            assert err <= (DECODE_LOGIT_ATOL if i else PREFILL_LOGIT_ATOL), (rid, i, err)
        solo.pool.check()


def test_small_pool_queues_an_admission_and_matches_dense(smoke_pair):
    """A pool of 9 pages (8 allocatable, the dense layout's 3 x 4 would be
    12) makes at least one admission wait for pages; every request still
    completes, with the tokens of the streaming dense engine bit for bit.
    A wait counts only when a decode step runs with a slot free and the
    queue head still waiting, so the dense engine counts none."""
    _, _, model, params = smoke_pair
    paged, stats, eng = run_port(model, params, layout="paged", pool_pages=9)
    dense, dense_stats, _ = run_port(model, params)
    assert stats["waited_for_pages"] >= 1
    assert stats["page_wait_steps"] >= stats["waited_for_pages"]
    assert dense_stats["waited_for_pages"] == dense_stats["page_wait_steps"] == 0
    assert stats["pool"]["admits"] == len(WORKLOAD)
    for rid in dense:
        np.testing.assert_array_equal(paged[rid].tokens, dense[rid].tokens, err_msg=f"rid {rid}")
    eng.pool.check()
    tiny = Engine(model, params, EngineConfig(batch=1, capacity=CAP, policy=named_policy(
        "gear_kcvt4"), prefill_mode="streaming", layout="paged", pool_pages=3), device="cpu")
    with pytest.raises(ValueError, match="pool pages"):
        Scheduler(tiny).submit(Request(rid=9, tokens=np.zeros(150, np.int32), max_new_tokens=2))
