"""Head_dim 256 (gemma-2b's, and gemma3's and paligemma's to come) through
the port's plain kernel versions, against the reference's Pallas kernels
in interpret mode (as ``tests/test_kernels.py`` runs them on the CPU), and
gemma-2b's smoke config at head_dim 256 served against the reference.

The CUDA builds at head_dim 256 (``csrc/flash_prefill.cu``'s two consumer
warpgroups, ``csrc/gear_decode.cuh``'s two channels a thread and its
channel-split history body) are held against these same plain versions on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phases 3, 4 and 7);
this file closes the chain from the plain versions to the reference.

Tolerances: ``flash_prefill`` ``PREFILL_TOL`` (3e-2) on the bf16 output
(the kernel keeps P in f32, the plain version too; bf16 rounding of the
outputs); ``gear_decode`` / ``_paged`` / ``_history`` ``DECODE_TOL`` (1e-3)
on the normalized output and score max of rows with history (f32 both
sides, different summation order); the paged plain version equal to the
dense one on the gathered operands, bit for bit; the served run under the
teacher-forced rule of ``tests/test_torch_attend.py`` with every gap
within ``GAP``.
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
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as j_flash_prefill  # noqa: E402
from repro.kernels.gear_decode import gear_decode as j_gear_decode  # noqa: E402
from repro.kernels.gear_decode import gear_decode_paged as j_gear_decode_paged  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

PREFILL_TOL = 3e-2
DECODE_TOL = 1e-3
GAP = 0.1                # measured 0.078, before and after a decode close
DH = 256


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_t(x) -> torch.Tensor:
    t = torch.from_numpy(to_np(x).copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


FLASH = {"causal": dict(), "window_softcap": dict(window=100, softcap=30.0),
         "prefix": dict(prefix_len=256)}


@pytest.mark.parametrize("mask", list(FLASH))
def test_flash_prefill_plain_matches_reference_kernel(mask):
    """gemma-2b's MQA (8 query heads over one KV head: kv_repeat 8) at S 320
    (a ragged last 64-token tile of the card's kernel), under each mask."""
    kw = dict(FLASH[mask], kv_repeat=8)
    rng = np.random.RandomState(len(mask))
    S = 320
    q, k, v = (jnp.asarray(rng.randn(n, S, DH).astype(np.float32)).astype(jnp.bfloat16)
               for n in (8, 1, 1))
    want = to_np(j_flash_prefill(q, k, v, bq=64, bk=64, interpret=True, **kw))
    got = to_np(ref.flash_prefill_ref(to_t(q), to_t(k), to_t(v), **kw))
    assert np.abs(got - want).max() <= PREFILL_TOL


def to_j(t: torch.Tensor):
    x = jnp.asarray(to_np(t))
    return x.astype(jnp.bfloat16) if t.dtype == torch.bfloat16 else x


POLICIES = ["gear_kcvt4", "gear_kivi2"]


def prefilled(polname, B=2, H=1, S=256):
    """The reference's prefilled head_dim-256 cache (one K channel and one V
    token constant, so an outlier index is stored twice) and the port's copy."""
    jcfg = jcache.CacheConfig(batch=B, kv_heads=H, head_dim=DH, capacity=S,
                              policy=jnamed(polname))
    rng = np.random.RandomState(3)
    k = jnp.asarray(rng.randn(B, H, S, DH).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.randn(B, H, S, DH).astype(np.float32)).astype(jnp.bfloat16)
    k = k.at[0, 0, :, 3].set(2.0)
    v = v.at[0, 0, 4, :].set(-1.5)
    jc = jax.jit(lambda a, b: jcache.prefill_layer_cache(jcfg, jcache.init_layer_cache(jcfg),
                                                         a, b))(k, v)
    pc = cache.GEARLayerCache(**{f: None if getattr(jc, f) is None else to_t(getattr(jc, f))
                                 for f in cache.FIELDS})
    pcfg = cache.CacheConfig(batch=B, kv_heads=H, head_dim=DH, capacity=S,
                             policy=named_policy(polname))
    return jcfg, jc, pcfg, pc


_CACHES: dict = {}


@pytest.fixture(params=POLICIES)
def gear(request):
    if request.param not in _CACHES:
        _CACHES[request.param] = prefilled(request.param)
    return _CACHES[request.param]


def assert_triples_close(got, want, live):
    acc, m, l = (to_np(x) for x in got)
    acc_j, m_j, l_j = (np.asarray(x) for x in want)
    m_j, l_j = m_j.reshape(m.shape + (-1,))[..., 0], l_j.reshape(l.shape + (-1,))[..., 0]
    np.testing.assert_allclose((acc / l[..., None])[live], (acc_j / l_j[..., None])[live],
                               rtol=0, atol=DECODE_TOL)
    np.testing.assert_allclose(m[live], m_j[live], rtol=0, atol=DECODE_TOL)


@pytest.mark.parametrize("G", [8, 2])
def test_gear_decode_plain_matches_reference_kernel(gear, G):
    """gemma-2b's G = 8 and gemma3's G = 2 over ragged extents (0 and 3
    chunks): the dense plain version against the reference's Pallas kernel,
    and the paged plain version against the reference's paged kernel and,
    bit for bit, the dense plain version on the gathered operands."""
    jcfg, jc, pcfg, pc = gear
    BH = 2
    n_comp = np.array([0, 192], np.int32)
    q = np.random.RandomState(G).randn(BH, G, DH).astype(np.float32)
    kw = dict(bits=jcfg.policy.bits, chunk=64, scale_factor=DH ** -0.5)
    jarr, jlr, jsp = jops._gear_operands(jcfg, jc, BH)
    want = j_gear_decode(jnp.asarray(q), *jarr, jnp.asarray(n_comp), **kw, **jlr, **jsp,
                         interpret=True)
    arr, lr, sp = ops._gear_operands(pcfg, pc, BH)
    got = ref.gear_decode_ref(torch.from_numpy(q), *arr, torch.from_numpy(n_comp), **kw, **lr,
                              **sp)
    live = n_comp > 0
    assert_triples_close(got, want, live)

    # the same chunks as pool pages: slot b's chunk c at page 1 + 4 b + (3 - c)
    # (reversed), every page past the extent the zero page
    C = 4
    bt = np.zeros((2, C), np.int32)
    for b in range(2):
        for c in range(C):
            bt[b, c] = 1 + 4 * b + (C - 1 - c)
    names = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero")
    dense = dict(zip(names, arr)) | lr | sp
    pools = {}
    for name, x in dense.items():
        rpc = x.shape[1] // C
        pool = torch.zeros((1 + 4 * 2, rpc) + tuple(x.shape[2:]), dtype=x.dtype)
        for b in range(2):
            for c in range(C):
                pool[bt[b, c]] = x[b, c * rpc:(c + 1) * rpc]
        pools[name] = pool
    extra = {n: pools[n] for n in dense if n not in names}
    paged = ref.gear_decode_paged_ref(torch.from_numpy(q), *[pools[n] for n in names],
                                      torch.from_numpy(n_comp), torch.from_numpy(bt), **kw,
                                      **extra)
    for a, b in zip(paged, got):
        assert torch.equal(a, b)
    jpaged = j_gear_decode_paged(jnp.asarray(q), *[to_j(pools[n]) for n in names],
                                 jnp.asarray(n_comp), jnp.asarray(bt), **kw,
                                 **{n: to_j(t) for n, t in extra.items()}, interpret=True)
    assert_triples_close(paged, jpaged, live)


def test_gear_decode_history_plain_matches_reference_kernel(gear):
    """The history scorer's plain version over 4 in-flight blocks of 64 query
    rows (extents 0, 64, 128, 192) against the reference's kernel called
    once per block, as its streaming prefill runs it."""
    jcfg, jc, pcfg, pc = gear
    BH, NB = 2, 4
    extents = [0, 64, 128, 192]
    q = np.random.RandomState(9).randn(BH, NB, 64, DH).astype(np.float32)
    kw = dict(bits=jcfg.policy.bits, chunk=64, scale_factor=DH ** -0.5)
    arr, lr, sp = ops._gear_operands(pcfg, pc, BH)
    got = ref.gear_decode_history_ref(torch.from_numpy(q), *arr, extents, **kw, **lr, **sp)
    jarr, jlr, jsp = jops._gear_operands(jcfg, jc, BH)
    for i, e in enumerate(extents[1:], start=1):
        want = j_gear_decode(jnp.asarray(q[:, i]), *jarr, jnp.int32(e), **kw, **jlr, **jsp,
                             interpret=True)
        assert_triples_close([x[:, i] for x in got], want, np.ones(BH, bool))


# ---------------------------------------------------------------------------
# gemma-2b's smoke config at head_dim 256, served


SERVING = {"gear_kcvt4-monolithic-dense": ("gear_kcvt4", {}),
           "gear_kivi2-streaming-paged": ("gear_kivi2", dict(prefill_mode="streaming",
                                                             layout="paged"))}
CAP = 256
EOS = 3


class Gemma256:
    """Both packages' gemma-2b smoke model at head_dim 256 (4 query heads over
    one KV head) on the reference's parameters."""

    def __init__(self):
        self.ref_cfg = dataclasses.replace(ref_smoke_config("gemma-2b"), head_dim=DH)
        self.cfg = dataclasses.replace(smoke_config("gemma-2b"), head_dim=DH)
        self.ref_model = ref_build_model(self.ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.model = build_model(self.cfg)
        self.params = params_from_reference(jax.tree.map(np.asarray, self.ref_params), self.cfg,
                                            device="cpu")
        self._jit: dict = {}

    def requests(self, mod):
        """Three requests whose prompts close one chunk in prefill and whose
        budgets close one during decode."""
        rng = np.random.RandomState(0)
        return [mod.Request(rid=i, tokens=rng.randint(4, self.cfg.vocab_size, size=n),
                            max_new_tokens=b)
                for i, (n, b) in enumerate(zip([100, 120, 100], [30, 12, 40]))]

    def along(self, polname, mode, prompt, tokens):
        if (polname, mode) not in self._jit:
            m, pol = self.ref_model, jnamed(polname)
            self._jit[polname, mode] = (
                jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP, prefill_mode=mode,
                                               fused="interpret")),
                jax.jit(lambda p, t, c, pos: m.decode_step(p, {"tokens": t}, c, pos, pol, CAP,
                                                           fused="interpret")))
        prefill, decode = self._jit[polname, mode]
        ppol = named_policy(polname)
        logits, caches = prefill(self.ref_params, jnp.asarray(prompt[None]))
        plogits, pcaches = self.model.prefill(self.params, {"tokens": prompt[None]}, ppol, CAP,
                                              prefill_mode=mode)
        out_r, out_p = [], []
        for i, tok in enumerate(tokens):
            out_r.append(np.asarray(logits[0, -1].astype(jnp.float32)))
            out_p.append(plogits[0, -1].float().numpy())
            if i + 1 < len(tokens):
                pos = len(prompt) + i
                logits, caches = decode(self.ref_params, jnp.asarray([[tok]], jnp.int32),
                                        caches, jnp.asarray([pos], jnp.int32))
                plogits, pcaches = self.model.decode_step(
                    self.params, {"tokens": np.array([[tok]])}, pcaches, np.array([pos]), ppol,
                    CAP)
        return np.stack(out_r), np.stack(out_p)


@pytest.fixture(scope="module")
def gemma():
    return Gemma256()


@pytest.mark.parametrize("case", list(SERVING))
def test_gemma_smoke_at_head_dim_256_matches_reference_engine(gemma, case):
    polname, over = SERVING[case]
    got = {}
    for name, mod, model, params, named, extra in (
            ("ref", R, gemma.ref_model, gemma.ref_params, jnamed, {}),
            ("port", P, gemma.model, gemma.params, named_policy, {"device": "cpu"})):
        eng = mod.Engine(model, params, mod.EngineConfig(
            batch=2, capacity=CAP, policy=named(polname), eos_id=EOS, **over), **extra)
        sched = mod.Scheduler(eng)
        for r in gemma.requests(mod):
            sched.submit(r)
        got[name] = sched.run_continuous()
    ref_res, port = got["ref"], got["port"]
    assert [(r.rid, str(r.status)) for r in port] == [(r.rid, str(r.status)) for r in ref_res]
    prompts = {r.rid: r.tokens for r in gemma.requests(P)}
    want = {r.rid: np.asarray(r.tokens) for r in ref_res}
    mode = over.get("prefill_mode", "monolithic")
    for r in port:
        toks = np.asarray(r.tokens)
        rlog, plog = gemma.along(polname, mode, prompts[r.rid], toks)
        gaps = np.abs(rlog - plog).max(-1)
        print(f"{case} rid {r.rid}: largest gap {gaps.max():.4f}")
        assert (gaps <= GAP).all(), (r.rid, gaps)
        np.testing.assert_array_equal(toks, plog.argmax(-1))
        m = min(len(toks), len(want[r.rid]))
        diff = np.flatnonzero(toks[:m] != want[r.rid][:m])
        if diff.size:
            top2 = np.sort(rlog[diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[diff[0]], (r.rid, toks, want[r.rid])
        else:
            np.testing.assert_array_equal(toks, want[r.rid])
