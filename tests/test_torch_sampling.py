"""Sampled serving of the port against the JAX reference: ``sample`` at
temperature > 0, and the key that ``Engine.generate`` and
``Scheduler.run_continuous`` thread through their samples.

``sample`` on identical logits (text [B, V], audio [B, K, V], a vocabulary
smaller than ``top_k``; ``top_k`` 0 and 40; temperature 0 and 0.8) gives the
reference's ids bit for bit: the port draws the reference's Gumbel noise
(``repro_torch.core.prng``).

Served runs: both packages serve the tiny model of
``tests/test_torch_resilience.py`` (``TINY``, the reference's weights
through ``params_from_reference``) at temperature 0.8, the wave engine
through ``Engine.generate`` under a given key, the paged engine through
``Scheduler.run_continuous`` (five requests on two slots, so requests are
admitted between decode steps, under folded keys).  With no EOS the two
packages make the same sequence of ``sample`` calls whatever they draw;
every call is recorded on both sides, and at every call:

* the key is the reference's, word for word;
* the port's ids are the reference's ``sample`` of the port's logits under
  that key;
* a row whose id differs from the reference's is one where the
  reference's two best perturbed scores ``logits / T + gumbel`` lie within
  twice the row's largest logit gap over T (plus ``MARGIN_EPS``): the
  margin rule of ROADMAP §3 g with the noise added.  (After such a flip a
  request's inputs differ, its logit gap is no longer small, and the rule
  no longer constrains it; a request's tokens up to its first flip are
  counted and printed.)
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as R  # noqa: E402
import repro.serving.engine as ref_engine_mod  # noqa: E402
import repro.serving.scheduler as ref_sched_mod  # noqa: E402
import repro_torch.serving as P  # noqa: E402
import repro_torch.serving.engine as port_engine_mod  # noqa: E402
import repro_torch.serving.scheduler as port_sched_mod  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.serving.sampling import sample as ref_sample  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serving.sampling import sample  # noqa: E402

TEMPERATURE = 0.8
MARGIN_EPS = 1e-5
CAP = 48
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)


@pytest.mark.parametrize("top_k", [0, 40])
@pytest.mark.parametrize("shape", [(4, 1000), (2, 4, 300), (3, 7)], ids=["text", "audio", "V<k"])
def test_sample_matches_reference(shape, top_k):
    logits = (np.random.RandomState(len(shape)).randn(*shape) * 2).astype(np.float32)
    logits[0, ..., 5] = logits[0, ..., 3] = 9.0                # a greedy tie: lowest id
    key = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    for temperature in (0.0, TEMPERATURE):
        want = np.asarray(ref_sample(jnp.asarray(logits), key, temperature, top_k))
        got = sample(torch.from_numpy(logits), np.asarray(key), temperature, top_k)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape[:-1]
        np.testing.assert_array_equal(got.numpy(), want)
    assert (want < logits.shape[-1]).all()


def small(named):
    pol = named("gear_kcvt4")
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8), rank=2,
                               rank_decode=2)


@pytest.fixture(scope="module")
def models():
    ref_model = ref_build_model(RefModelConfig(**TINY))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return (ref_model, ref_params), (build_model(cfg), params)


def engines(models, **over):
    (ref_model, ref_params), (model, params) = models
    kw = dict(batch=2, capacity=CAP, temperature=TEMPERATURE, eos_id=-1, **over)
    ref = R.Engine(ref_model, ref_params,
                   R.EngineConfig(policy=small(ref_named_policy), **kw))
    port = P.Engine(model, params, P.EngineConfig(policy=small(named_policy), **kw),
                    device="cpu")
    return ref, port


def recorder(monkeypatch, mods, calls: list):
    """Patch ``sample`` in ``mods`` with a copy that records (key words,
    f32 logits, ids) of every call."""
    for mod in mods:
        real = mod.sample

        def rec(logits, key, temperature=0.0, top_k=0, real=real):
            out = real(logits, key, temperature, top_k)
            lg = (np.asarray(logits.astype(jnp.float32)) if isinstance(logits, jax.Array)
                  else logits.float().numpy())
            calls.append((np.asarray(key, np.uint32), lg, np.asarray(out)))
            return out
        monkeypatch.setattr(mod, "sample", rec)


def check_calls(ref_calls, port_calls) -> tuple:
    """The rules of the module docstring; returns (rows, rows equal)."""
    assert len(port_calls) == len(ref_calls) > 0
    rows = same = 0
    for (rk, rl, ro), (pk, pl, po) in zip(ref_calls, port_calls):
        np.testing.assert_array_equal(pk, rk)
        assert pl.shape == rl.shape
        np.testing.assert_array_equal(po, np.asarray(ref_sample(jnp.asarray(pl), rk,
                                                                 TEMPERATURE)))
        scores = rl / np.float32(TEMPERATURE) + np.asarray(jax.random.gumbel(rk, rl.shape))
        top2 = np.sort(scores, axis=-1)[..., -2:]
        margin = top2[..., 1] - top2[..., 0]
        gap = np.abs(rl - pl).max(-1) / TEMPERATURE
        flip = po != ro
        assert (margin[flip] <= 2 * gap[flip] + MARGIN_EPS).all(), (margin[flip], gap[flip])
        rows, same = rows + po.size, same + int((~flip).sum())
    return rows, same


def test_generate_sampled_matches_reference(models, monkeypatch):
    ref_eng, port_eng = engines(models)
    prompts = np.random.RandomState(0).randint(4, 64, size=(2, 11)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    ref_calls, port_calls = [], []
    recorder(monkeypatch, [ref_engine_mod], ref_calls)
    recorder(monkeypatch, [port_engine_mod], port_calls)
    ref_toks, _ = ref_eng.generate({"tokens": jnp.asarray(prompts)}, 12, key)
    toks, _ = port_eng.generate({"tokens": prompts}, 12, np.asarray(key))
    assert toks.shape == (2, 12) and len(port_calls) == 12
    rows, same = check_calls(ref_calls, port_calls)
    shared = [int(np.argmax(np.append(toks[b] != np.asarray(ref_toks)[b], True)))
              for b in range(2)]
    print(f"generate: {same} of {rows} sampled ids equal; tokens before the first "
          f"difference {shared}")
    # the draw is the key's: another key moves the stream
    other, _ = port_eng.generate({"tokens": prompts}, 12, np.asarray(jax.random.PRNGKey(12)))
    assert not np.array_equal(other, toks)


def test_run_continuous_sampled_matches_reference(models, monkeypatch):
    ref_eng, port_eng = engines(models, layout="paged")
    rng = np.random.RandomState(1)
    reqs = [(rng.randint(4, 64, size=rng.randint(2, 12)), b) for b in (6, 3, 9, 1, 5)]
    ref_calls, port_calls = [], []
    recorder(monkeypatch, [ref_engine_mod, ref_sched_mod], ref_calls)
    recorder(monkeypatch, [port_engine_mod, port_sched_mod], port_calls)
    results = []
    for mod, eng in ((R, ref_eng), (P, port_eng)):
        sched = mod.Scheduler(eng)
        for rid, (toks, budget) in enumerate(reqs):
            sched.submit(mod.Request(rid=rid, tokens=toks, max_new_tokens=budget))
        results.append({r.rid: r for r in sched.run_continuous()})
    ref, port = results
    assert sorted(port) == sorted(ref) == list(range(5))
    for rid, (_, budget) in enumerate(reqs):
        assert str(port[rid].status) == str(ref[rid].status) == "ok"
        assert len(port[rid].tokens) == len(ref[rid].tokens) == budget
    # admissions sample [1, V] logits, decode steps [2, V]: some of each
    assert {c[1].shape for c in port_calls} == {(1, 64), (2, 64)}
    rows, same = check_calls(ref_calls, port_calls)
    equal = sum(int(np.array_equal(port[r].tokens, ref[r].tokens)) for r in port)
    print(f"run_continuous: {same} of {rows} sampled ids equal; {equal} of 5 requests "
          f"equal to the reference's")
