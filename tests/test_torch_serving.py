"""End-to-end parity of the port's serving path with the JAX reference.

The smoke llama2-7b model (``smoke_config``) runs in both packages on the
reference's own randomly initialised parameters (moved across with
``params_from_reference``), with gear_kcvt4.  The JAX side runs as its own
tests do on the CPU: ``fused="interpret"``, i.e. the ``flash_prefill`` and
``gear_decode`` Pallas kernels in interpret mode; the port's CPU path takes
their plain versions.

Activations are bf16 in both, and torch and XLA round their bf16 products
after different sums, so logits agree within a tolerance and tokens by a
margin rule:

* prefill logits within ``PREFILL_ATOL`` (0.0625, i.e. 4 bf16 ulps at |x| ≈ 2;
  measured max 0.035);
* a greedy token must equal the reference's wherever the reference's
  top-1/top-2 logit margin exceeds ``2 * PREFILL_ATOL`` (the first token,
  from prefill logits) or ``DECODE_MARGIN`` (0.3; a decode step's margin
  moved by at most 0.22 over 128 measured steps — more than prefill, since a
  chunk that closes on bf16-perturbed K/V gets chaotically different
  low-rank factors).  In free-running generation the comparison of a
  request stops at its first step below the margin, and the test says so.
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
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving.scheduler import Request as RefRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as RefScheduler  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

POLICY = "gear_kcvt4"
CAP = 128
EOS = 3
PREFILL_ATOL = 0.0625
DECODE_MARGIN = 0.3


class Pair:
    """Both packages' smoke llama2-7b on the reference's parameters, plus
    the reference's jitted batch-1 prefill/decode (interpret kernels)."""

    def __init__(self):
        self.ref_model = ref_build_model(ref_smoke_config("llama2-7b"))
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.ref_policy = ref_named_policy(POLICY)
        self.cfg = smoke_config("llama2-7b")
        self.model = build_model(self.cfg)
        self.params = params_from_reference(jax.tree.map(np.asarray, self.ref_params),
                                            self.cfg, device="cpu")
        self.policy = named_policy(POLICY)
        m, pol = self.ref_model, self.ref_policy
        self.ref_prefill = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP,
                                                          fused="interpret"))
        self.ref_decode = jax.jit(lambda p, t, c, pos: m.decode_step(
            p, {"tokens": t}, c, pos, pol, CAP, fused="interpret"))

    def ref_logits_along(self, prompt: np.ndarray, tokens: np.ndarray) -> list:
        """Reference logits that produced each of ``tokens`` (greedy from
        ``prompt``), teacher-forced at batch 1."""
        logits, caches = self.ref_prefill(self.ref_params, jnp.asarray(prompt[None]))
        out = [np.asarray(logits[0, -1].astype(jnp.float32))]
        for i, tok in enumerate(tokens[:-1]):
            logits, caches = self.ref_decode(self.ref_params, jnp.asarray([[tok]], jnp.int32),
                                             caches, jnp.asarray([len(prompt) + i], jnp.int32))
            out.append(np.asarray(logits[0, -1].astype(jnp.float32)))
        return out


@pytest.fixture(scope="module")
def pair():
    return Pair()


def margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def test_engine_runs_on_cuda_unless_the_cpu_is_named(pair):
    ecfg = EngineConfig(batch=1, capacity=CAP, policy=pair.policy)
    expected = ValueError if torch.cuda.is_available() else RuntimeError
    with pytest.raises(expected):
        Engine(pair.model, pair.params, ecfg)            # CPU weights, CUDA default
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Transformer(pair.cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pair.model.init_caches(pair.policy, 1, CAP)
    assert Engine(pair.model, pair.params, ecfg, device="cpu").device.type == "cpu"


STREAM_PAGED = dict(prefill_mode="streaming", layout="paged")


# The ids keep their names from before the portable attend path and the
# fidelity probes were ported: "fused-off" and "obs-True" now assert that the
# option works (exc None), the others are unchanged.
@pytest.mark.parametrize("options,exc", [
    (dict(fused="off"), None), (dict(fused="interpret"), NotImplementedError),
    (dict(STREAM_PAGED, prefix_cache=True), None),
    (dict(pool_pages=8), ValueError),
    (dict(prefix_cache=True), ValueError),
    (dict(obs={"fidelity_every_n": 1}), None),
    (dict(fused="bogus"), ValueError),
], ids=["fused-off-NotImplementedError", "fused-interpret-NotImplementedError",
        "prefix_cache-streaming-paged-accepted", "pool_pages-dense-ValueError",
        "prefix_cache-monolithic-ValueError", "obs-True-NotImplementedError",
        "fused-bogus-ValueError"])
def test_engine_config_rejects_unported_options(options, exc):
    """``fused="interpret"`` raises ``NotImplementedError`` (CUDA has no
    interpret mode), invalid options the reference's ``ValueError`` (the
    prefix cache needs streaming prefill); the prefix cache with streaming
    prefill is accepted on either layout, ``fused="off"`` decodes through
    the portable attend path (``attend_path`` "xla", as the reference
    reports it), and telemetry with the fidelity probes builds a probe."""
    if exc is None:
        ecfg = EngineConfig(batch=1, capacity=CAP, policy=named_policy(POLICY), **options)
        if "fused" in options or "obs" in options:
            model = build_model(smoke_config("llama2-7b"))
            eng = Engine(model, model.init(seed=0, device="cpu"), ecfg, device="cpu")
            assert eng.attend_path == ("xla" if "fused" in options else "fused")
            assert (eng.obs is not None and eng.obs.fidelity is not None) == ("obs" in options)
    else:
        with pytest.raises(exc):
            EngineConfig(batch=1, capacity=CAP, policy=named_policy(POLICY), **options)
    EngineConfig(batch=1, capacity=CAP, policy=named_policy(POLICY), **STREAM_PAGED)
    EngineConfig(batch=1, capacity=CAP, policy=named_policy(POLICY), obs=True)
    if options == dict(prefix_cache=True):
        with pytest.raises(ValueError, match="prefix_cache requires prefill_mode='streaming'"):
            EngineConfig(batch=1, capacity=CAP, policy=named_policy(POLICY), **options)


def test_prefill_logits_and_greedy_decode_match_reference(pair):
    """Prefill logits within PREFILL_ATOL, then 32 greedy decode steps
    (crossing a chunk close at length 64).  Both packages are fed the
    reference's greedy tokens (teacher forcing), so one near-tie cannot make
    the sequences diverge and every step whose margin clears the tolerance
    is compared."""
    prompt = np.random.RandomState(7).randint(0, pair.cfg.vocab_size, size=50).astype(np.int32)
    ref_logits, ref_caches = pair.ref_prefill(pair.ref_params, jnp.asarray(prompt[None]))
    logits, caches = pair.model.prefill(pair.params, {"tokens": prompt[None]}, pair.policy, CAP)
    ref_last = np.asarray(ref_logits[0, -1].astype(jnp.float32))
    last = logits[0, -1].float().numpy()
    assert np.abs(ref_last - last).max() <= PREFILL_ATOL
    assert caches[0].length.tolist() == [50]

    compared = 0
    tok = int(ref_last.argmax())
    if margin(ref_last) > 2 * PREFILL_ATOL:
        assert int(last.argmax()) == tok
        compared += 1
    for i in range(32):
        pos = len(prompt) + i
        ref_logits, ref_caches = pair.ref_decode(pair.ref_params, jnp.asarray([[tok]], jnp.int32),
                                                 ref_caches, jnp.asarray([pos], jnp.int32))
        logits, caches = pair.model.decode_step(pair.params, {"tokens": np.array([[tok]])},
                                                caches, np.array([pos]), pair.policy, CAP)
        ref_last = np.asarray(ref_logits[0, -1].astype(jnp.float32))
        last = logits[0, -1].float().numpy()
        tok = int(ref_last.argmax())
        if margin(ref_last) > DECODE_MARGIN:
            assert int(last.argmax()) == tok, f"decode step {i}: margin {margin(ref_last)}"
            compared += 1
    assert caches[0].length.tolist() == [len(prompt) + 32]
    assert int(caches[0].k_scale[0, :, 0].abs().sum() > 0)          # the chunk closed
    assert compared >= 5, f"only {compared} of 33 tokens cleared the margin"


def workload():
    rng = np.random.RandomState(3)
    lengths = [40, 70, 40, 70, 40]
    budgets = [6, 30, 1, 12, 28]
    return [(rid, rng.randint(0, 512, size=n).astype(np.int32), b)
            for rid, (n, b) in enumerate(zip(lengths, budgets))]


def run_port(pair, batch):
    eng = Engine(pair.model, pair.params,
                 EngineConfig(batch=batch, capacity=CAP, policy=pair.policy, eos_id=EOS),
                 device="cpu")
    sched = Scheduler(eng)
    for rid, toks, budget in workload():
        sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=budget))
    results = {r.rid: r for r in sched.run_continuous()}
    return results, sched.last_stats


def test_run_continuous_matches_reference_engine(pair):
    """Mixed-budget continuous batching (3 slots, 5 requests, chunk closes
    during decode): per-rid greedy tokens equal the reference Engine's
    (fused="interpret") under the margin rule, and every request ends OK
    with its own budget or EOS."""
    ref_eng = RefEngine(pair.ref_model, pair.ref_params,
                        RefEngineConfig(batch=3, capacity=CAP, policy=pair.ref_policy,
                                        eos_id=EOS, fused="interpret"))
    ref_sched = RefScheduler(ref_eng)
    for rid, toks, budget in workload():
        ref_sched.submit(RefRequest(rid=rid, tokens=toks, max_new_tokens=budget))
    ref = {r.rid: r for r in ref_sched.run_continuous()}
    port, stats = run_port(pair, batch=3)
    assert sorted(port) == sorted(ref) == list(range(5))
    assert stats["decode_steps"] > 0 and stats["statuses"] == {"ok": 5}

    notes, compared = [], 0
    for rid, toks, budget in workload():
        want, got = ref[rid].tokens, port[rid].tokens
        assert str(port[rid].status) == "ok"
        assert len(got) == budget or (len(got) and got[-1] == EOS)
        ref_logits = pair.ref_logits_along(toks, want)
        for i, (w, lg) in enumerate(zip(want, ref_logits)):
            tol = 2 * PREFILL_ATOL if i == 0 else DECODE_MARGIN
            if margin(lg) <= tol:
                notes.append(f"rid {rid}: stopped at token {i} (margin {margin(lg):.4f})")
                break
            assert i < len(got) and got[i] == w, f"rid {rid} token {i}"
            compared += 1
        else:
            np.testing.assert_array_equal(got, want)
    print("; ".join(notes))
    assert compared >= 3, notes


def test_run_continuous_splice_isolation():
    """A request's greedy tokens do not depend on what shares the batch:
    the 3-slot run equals one slot at a time, bit for bit."""
    p = Pair.__new__(Pair)
    p.cfg = smoke_config("llama2-7b")
    p.model = build_model(p.cfg)
    p.params = Transformer.random(p.cfg, seed=1, device="cpu")
    p.policy = named_policy(POLICY)
    batched, _ = run_port(p, batch=3)
    solo, _ = run_port(p, batch=1)
    for rid in batched:
        np.testing.assert_array_equal(batched[rid].tokens, solo[rid].tokens)


@pytest.mark.parametrize("pos_shape", [(12,), (3, 1), (3, 12)])
def test_model_components_match_reference(pos_shape):
    """RoPE (shared [S] and per-slot [B, S] positions), RMSNorm with its
    (1 + scale) gain, and SwiGLU, on identical bf16 inputs: equal up to one
    bf16 rounding of the output (torch and XLA order the f32 math apart)."""
    from repro.models import common as ref_common
    from repro.models import mlp as ref_mlp
    from repro_torch.models import common, mlp

    rng = np.random.RandomState(len(pos_shape))
    S = pos_shape[-1]
    x = jnp.asarray(rng.randn(3, S, 4, 16).astype(np.float32)).astype(jnp.bfloat16)
    pos = rng.randint(0, 500, size=pos_shape).astype(np.int32)
    ref = np.asarray(ref_common.apply_rope(x, jnp.asarray(pos), 10_000.0).astype(jnp.float32))
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    out = common.apply_rope(xt, torch.from_numpy(pos), 10_000.0).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=1e-6)

    scale = rng.randn(16).astype(np.float32) * 0.1
    ref = np.asarray(ref_common.rmsnorm(x, jnp.asarray(scale)).astype(jnp.float32))
    out = common.rmsnorm(xt, torch.from_numpy(scale)).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=2 ** -7, atol=1e-6)

    cfg = ref_smoke_config("llama2-7b")
    w = {n: rng.randn(*s).astype(np.float32) * 0.1
         for n, s in (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    h = jnp.asarray(rng.randn(2, S, 64).astype(np.float32)).astype(jnp.bfloat16)
    ref = np.asarray(ref_mlp.mlp_apply(cfg, {k: jnp.asarray(v) for k, v in w.items()}, h)
                     .astype(jnp.float32))
    layer = type("Layer", (), {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()})
    out = mlp.mlp_apply(layer, torch.from_numpy(np.array(h.astype(jnp.float32)))
                        .to(torch.bfloat16)).float().numpy()
    np.testing.assert_allclose(out, ref, rtol=0.05, atol=0.05)


def test_sampling_greedy_and_seeded_temperature():
    """Greedy is argmax with ties to the lowest id (as ``jnp.argmax``); a
    temperature above 0 draws under the given key, reproducibly and as the
    reference's ``sample`` does with that key, and ``top_k`` keeps the draw
    inside the k largest logits."""
    from repro.serving.sampling import sample as ref_sample
    from repro_torch.serving.sampling import sample

    logits = np.random.RandomState(0).randn(6, 50).astype(np.float32)
    logits[2, [7, 30]] = 9.0                                   # tie: lowest id wins
    key = jax.random.PRNGKey(5)
    want = np.asarray(ref_sample(jnp.asarray(logits), key))
    np.testing.assert_array_equal(sample(torch.from_numpy(logits), key).numpy(), want)
    draws = [sample(torch.from_numpy(logits), np.asarray(key), 0.8, 3) for _ in range(2)]
    torch.testing.assert_close(draws[0], draws[1], rtol=0, atol=0)
    np.testing.assert_array_equal(draws[0].numpy(),
                                  np.asarray(ref_sample(jnp.asarray(logits), key, 0.8, 3)))
    top3 = np.argsort(-logits, axis=-1)[:, :3]
    assert all(int(t) in top3[i] for i, t in enumerate(draws[0]))
    assert draws[0].dtype == torch.int32


def test_pair_weights_round_trip(pair):
    """params_from_reference puts each reference leaf (unstacked over the
    repeats) into its port parameter: matrices as bf16, norm scales f32."""
    blocks = pair.ref_params["blocks"][0]
    for i, blk in enumerate(pair.params.blocks):
        ref_wq = np.asarray(jnp.asarray(blocks["attn"]["wq"][i]).astype(jnp.bfloat16)
                            .astype(jnp.float32))
        np.testing.assert_array_equal(blk.wq.float().numpy(), ref_wq)
        assert blk.ln1.dtype == torch.float32 and blk.w_down.dtype == torch.bfloat16
    assert dataclasses.asdict(pair.cfg) == dataclasses.asdict(ref_smoke_config("llama2-7b"))
