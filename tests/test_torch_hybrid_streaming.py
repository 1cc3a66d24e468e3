"""Streaming prefill of the hybrid (hymba-1.5b: GEAR attention ∥ Mamba-2 SSM
heads) in the port against the JAX reference's.

A hybrid's streaming layer runs attention through the streaming pipeline
(closed chunks compressed first, each chunk attending the compressed
history before it) and the SSM heads on the whole normed input beside it,
unbucketed, as in the reference.  The same numpy-seeded prompts and the
reference's parameters go to both packages; the reference runs its CPU
oracles, the port's CPU tensors the plain kernel versions.  What is held:

* the GEAR codes of every closed chunk of layer 0 (packed codes, stats,
  outlier values and indices) bit-equal to the reference's, and to the
  port's own monolithic prefill's; low-rank factors through ``A·Bᵀ``
  within 1e-2 relative (the standing one-ulp difference, ROADMAP §3);
* every layer's SSM state (conv window and recurrent state) within
  ``PREFILL_ATOL`` of the reference's, and the prefill logits too;
* greedy tokens through ``Scheduler.run_continuous`` equal to the
  reference engine's by the margin rule of ``tests/test_torch_hybrid.py``
  (teacher-forced reference logits; a request's comparison stops at its
  first step whose top-1/top-2 margin is below ``2 * PREFILL_ATOL`` for
  the first token or ``DECODE_MARGIN`` after).
"""

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
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

ARCH = "hymba-1.5b"
POLICY = "gear_kcvt4"
CAP = 256
NB = 64
EOS = 3
PREFILL_ATOL = 0.0625
DECODE_MARGIN = 0.3


def np32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


class Pair:
    """Both packages' smoke hymba on the reference's parameters, with the
    reference's jitted batch-1 streaming prefill and decode step."""

    def __init__(self):
        self.ref_model = ref_build_model(ref_smoke_config(ARCH))
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.ref_policy = ref_named_policy(POLICY)
        self.cfg = smoke_config(ARCH)
        self.model = build_model(self.cfg)
        self.params = params_from_reference(jax.tree.map(np.asarray, self.ref_params),
                                            self.cfg, device="cpu")
        self.policy = named_policy(POLICY)
        m, pol = self.ref_model, self.ref_policy
        self.ref_prefill = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP,
                                                          prefill_mode="streaming"))
        self.ref_decode = jax.jit(lambda p, t, c, pos: m.decode_step(
            p, {"tokens": t}, c, pos, pol, CAP))

    def ref_logits_along(self, prompt: np.ndarray, tokens: np.ndarray) -> list:
        logits, caches = self.ref_prefill(self.ref_params, jnp.asarray(prompt[None]))
        out = [np32(logits[0, -1])]
        for i, tok in enumerate(tokens[:-1]):
            logits, caches = self.ref_decode(self.ref_params, jnp.asarray([[tok]], jnp.int32),
                                             caches, jnp.asarray([len(prompt) + i], jnp.int32))
            out.append(np32(logits[0, -1]))
        return out


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.mark.parametrize("n", [150, 128], ids=["unaligned-150", "aligned-128"])
def test_streaming_prefill_matches_reference(pair, n):
    """One prompt through both packages' streaming prefill: logits and every
    layer's SSM state within PREFILL_ATOL; layer 0's closed GEAR chunks
    bit-equal to the reference's and to the port's monolithic prefill's;
    the model took the streaming pipeline (the cache length is the raw
    length, the FP16 buffer holds the unaligned tail)."""
    prompt = np.random.RandomState(n).randint(0, pair.cfg.vocab_size, size=n).astype(np.int32)
    ref_logits, ref_caches = pair.ref_prefill(pair.ref_params, jnp.asarray(prompt[None]))
    logits, caches = pair.model.prefill(pair.params, {"tokens": prompt[None]}, pair.policy, CAP,
                                        prefill_mode="streaming")
    assert np.abs(np32(logits[0, -1]) - np32(ref_logits[0, -1])).max() <= PREFILL_ATOL
    (ref_gear, ref_ssm), = ref_caches
    n_closed = n // NB * NB
    for i, (gear, st) in enumerate(caches):
        assert gear.length.tolist() == [n]
        for name in ("conv", "state"):
            want = np32(getattr(ref_ssm, name)[i])
            np.testing.assert_allclose(np32(getattr(st, name)), want, rtol=0, atol=PREFILL_ATOL,
                                       err_msg=f"layer {i} {name}")
    gear0 = caches[0][0]
    for f in ("k_packed", "v_packed", "v_scale", "v_zero", "v_sp_val", "v_sp_idx"):
        np.testing.assert_array_equal(np32(getattr(gear0, f))[:, :, :n_closed],
                                      np32(getattr(ref_gear, f)[0])[:, :, :n_closed], err_msg=f)
    for f in ("k_scale", "k_zero", "k_sp_val", "k_sp_idx"):
        np.testing.assert_array_equal(np32(getattr(gear0, f))[:, :, :n // NB],
                                      np32(getattr(ref_gear, f)[0])[:, :, :n // NB], err_msg=f)
    for kv in ("k", "v"):
        a = [np32(getattr(g, f"{kv}_a"))[:, :, :n_closed].reshape(1, -1, n // NB, NB, 4)
             for g in (gear0, jax.tree.map(lambda x: x[0], ref_gear))]
        b = [np32(getattr(g, f"{kv}_b"))[:, :, :n // NB]
             for g in (gear0, jax.tree.map(lambda x: x[0], ref_gear))]
        ab = [x @ np.swapaxes(y, -1, -2) for x, y in zip(a, b)]
        assert np.linalg.norm(ab[0] - ab[1]) <= 1e-2 * np.linalg.norm(ab[1]), kv
    _, mono = pair.model.prefill(pair.params, {"tokens": prompt[None]}, pair.policy, CAP)
    for f, t in mono[0][0].tensors().items():
        if f not in ("buf_k", "buf_v"):
            assert torch.equal(t, getattr(gear0, f)), f
    assert torch.equal(mono[0][1].state, caches[0][1].state)


def workload():
    rng = np.random.RandomState(5)
    return [(rid, rng.randint(0, 512, size=n).astype(np.int32), b)
            for rid, (n, b) in enumerate(zip((150, 64, 70, 128), (6, 12, 1, 10)))]


def test_run_continuous_streaming_matches_reference_engine(pair):
    """``EngineConfig(prefill_mode="streaming")`` serves the hybrid on the
    dense layout, unbucketed, as the reference's engine does: per-rid
    greedy tokens equal the reference engine's under the margin rule, every
    request ends OK with its budget or EOS, and a solo engine gives the same
    tokens bit for bit (the pair cache splices and resets per slot)."""
    ref_eng = RefEngine(pair.ref_model, pair.ref_params, RefEngineConfig(
        batch=2, capacity=CAP, policy=pair.ref_policy, eos_id=EOS, prefill_mode="streaming"))
    assert not ref_eng._can_bucket
    ref_sched = RefScheduler(ref_eng)
    for rid, toks, budget in workload():
        ref_sched.submit(RefRequest(rid=rid, tokens=toks, max_new_tokens=budget))
    ref = {r.rid: r for r in ref_sched.run_continuous()}

    def run(batch):
        eng = Engine(pair.model, pair.params, EngineConfig(
            batch=batch, capacity=CAP, policy=pair.policy, eos_id=EOS, prefill_mode="streaming"),
            device="cpu")
        assert not eng._can_bucket
        sched = Scheduler(eng)
        for rid, toks, budget in workload():
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=budget))
        return {r.rid: r for r in sched.run_continuous()}, sched.last_stats

    port, stats = run(2)
    assert stats["statuses"] == {"ok": 4} and stats["attend_path"] == "fused"
    notes, compared = [], 0
    for rid, toks, budget in workload():
        want, got = ref[rid].tokens, port[rid].tokens
        assert len(got) == budget or (len(got) and got[-1] == EOS)
        for i, (w, lg) in enumerate(zip(want, pair.ref_logits_along(toks, want))):
            if margin(lg) <= (2 * PREFILL_ATOL if i == 0 else DECODE_MARGIN):
                notes.append(f"rid {rid}: stopped at token {i} (margin {margin(lg):.4f})")
                break
            assert i < len(got) and got[i] == w, f"rid {rid} token {i}"
            compared += 1
        else:
            np.testing.assert_array_equal(got, want)
    print("; ".join(notes))
    assert compared >= 3, notes
    solo, _ = run(1)
    for rid in port:
        np.testing.assert_array_equal(port[rid].tokens, solo[rid].tokens)
