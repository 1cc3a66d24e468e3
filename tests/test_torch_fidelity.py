"""The port's compression-fidelity probes (``repro_torch.obs.fidelity``)
against the JAX reference's (``repro.obs.fidelity``).

The tiny model of ``tests/test_torch_resilience.py`` (2 layers, d_model 32,
n_b 8, rank 2) on the reference's parameters.  What is held:

* probes on ≡ probes off (with the budget at 1, so that every due probe
  runs), bit for bit, in prefill logits and in every cache tensor, at prompt
  lengths 5 (no closed chunk: no probe), 19 and 27, on
  the dense monolithic engine (the reference's
  ``tests/test_cache.py::test_fidelity_probe_never_perturbs_serving_state``)
  and on the streaming paged engine (the card's path 11);
* the probe reports against the reference's on the same prompts: prompt
  and closed-chunk counts and report keys exactly; each layer's K/V relative
  error, low-rank share and outlier mass within ``REPORT_ATOL``, and the
  logit drift equal (0: a monolithic prefill attends uncompressed K/V).
  The two packages' caches differ by
  their low-rank factors' rounding (ROADMAP §3, standing difference c) and
  their masked sums by f64 against f32 (standing difference f);
* the registry's probe counters equal the reference's; sampling (every Nth
  closed chunk), the budget throttle (on a stubbed ``perf_counter``) and the
  swallowing of a failing probe into ``fidelity_probe_errors_total`` act as
  the reference's.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.obs.fidelity as ref_fidelity  # noqa: E402
import repro.serving as R  # noqa: E402
import repro_torch.obs.fidelity as port_fidelity  # noqa: E402
import repro_torch.serving as P  # noqa: E402
from repro.configs.base import ModelConfig as RefModelConfig  # noqa: E402
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.obs.catalog import build_registry as ref_build_registry  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.obs.catalog import build_registry  # noqa: E402

pytestmark = pytest.mark.obs

CAP = 48
PROMPT_LENS = (5, 19, 27)
# measured over this file: per-layer statistics up to 1.6e-3 apart (layer 1,
# whose K/V inputs differ by bf16 rounding; layer 0 within 1e-7)
REPORT_ATOL = 5e-3
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=32, num_heads=2,
            num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)
COUNTERS = ("fidelity_probes_total", "fidelity_probe_skipped_total",
            "fidelity_probe_errors_total")


def small(named):
    pol = named("gear_kcvt4")
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8), rank=2,
                               rank_decode=2)


def prompts():
    rng = np.random.RandomState(0)
    return [rng.randint(4, 64, size=(1, n)).astype(np.int32) for n in PROMPT_LENS]


@pytest.fixture(scope="module")
def tiny():
    ref_model = ref_build_model(RefModelConfig(**TINY))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**TINY)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    return ref_model, ref_params, build_model(cfg), params


def cache_tensors(caches) -> list:
    return [t for layer in caches for t in layer.tensors().values()]


@pytest.mark.parametrize("over", [{}, {"prefill_mode": "streaming", "layout": "paged"}],
                         ids=["dense-monolithic", "paged-streaming"])
def test_probes_never_perturb_serving_state(tiny, over):
    _, _, model, params = tiny
    base = P.EngineConfig(batch=1, capacity=CAP, policy=small(named_policy), **over)
    eng_off = P.Engine(model, params, base, device="cpu")
    eng_on = P.Engine(model, params, dataclasses.replace(
        base, obs=P.ObsConfig(fidelity_every_n=1, fidelity_budget_frac=1.0)), device="cpu")
    for prompt in prompts():
        log_off, cache_off = eng_off.prefill_slot({"tokens": prompt}, eng_off.init_caches(), 0)
        log_on, cache_on = eng_on.prefill_slot({"tokens": prompt}, eng_on.init_caches(), 0)
        assert torch.equal(log_off, log_on)
        for a, b in zip(cache_tensors(cache_off), cache_tensors(cache_on), strict=True):
            assert torch.equal(a, b)
    reports = eng_on.obs.fidelity.reports
    assert [r["prompt_tokens"] for r in reports] == [19, 27]
    assert eng_on.obs.registry.get("fidelity_probe_errors_total").value() == 0


def test_probe_reports_match_reference(tiny):
    ref_model, ref_params, model, params = tiny
    obs = {"fidelity_every_n": 1, "fidelity_budget_frac": 1.0}     # no throttle
    ref = R.Engine(ref_model, ref_params, R.EngineConfig(
        batch=1, capacity=CAP, policy=small(ref_named_policy), obs=R.ObsConfig(**obs)))
    port = P.Engine(model, params, P.EngineConfig(
        batch=1, capacity=CAP, policy=small(named_policy), obs=P.ObsConfig(**obs)),
        device="cpu")
    for prompt in prompts():
        ref.prefill_slot({"tokens": jnp.asarray(prompt)}, ref.init_caches(), 0)
        port.prefill_slot({"tokens": prompt}, port.init_caches(), 0)
    want, got = list(ref.obs.fidelity.reports), list(port.obs.fidelity.reports)
    assert len(got) == len(want) == 2
    for w, g in zip(want, got):
        assert (g["prompt_tokens"], g["closed_chunks"]) == (w["prompt_tokens"], w["closed_chunks"])
        # a monolithic prefill's logits never see the compression
        assert g["logits_drift"] == w["logits_drift"] == 0.0
        assert [sorted(r) for r in g["layers"]] == [sorted(r) for r in w["layers"]]
        for rw, rg in zip(w["layers"], g["layers"]):
            for key, val in rw.items():
                assert np.isfinite(rg[key]) and abs(rg[key] - val) <= REPORT_ATOL, (key, rg, rw)
    for name in COUNTERS:
        assert port.obs.registry.get(name).value() == ref.obs.registry.get(name).value(), name
    sampled = port.obs.registry.get("fidelity_sampled_chunks_total")
    for layer in ("0", "1"):
        assert sampled.value(layer=layer) == ref.obs.registry.get(
            "fidelity_sampled_chunks_total").value(layer=layer) == 2 + 3


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _probes(monkeypatch, **kw):
    """A reference and a port probe over stubbed prefills and compares, each
    on its own stubbed ``perf_counter``, on which each probe costs 1 s."""
    out = []
    for mod, reg, named in ((ref_fidelity, ref_build_registry(), ref_named_policy),
                            (port_fidelity, build_registry(), named_policy)):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(perf_counter=clock))
        probe = mod.FidelityProbe(ref_prefill=None,
                                  cache_cfgs=[types.SimpleNamespace(kind="gear")],
                                  policy=small(named), registry=reg, **kw)

        def run(batch1, logits, one, n_tok, n_closed, clock=clock):
            clock.t += 1.0
            return {"prompt_tokens": n_tok}

        probe._probe = run
        out.append((probe, reg, clock))
    return out


def test_sampling_and_budget_throttle_match_reference(monkeypatch):
    sides = _probes(monkeypatch, every_n=3, budget_frac=0.3)
    seen = []
    for probe, _, clock in sides:
        seen.append([])
        for n_tok in (8, 9, 30, 17, 40, 5, 24, 64, 16, 33, 50):
            clock.t += 1.0                              # serving time between prefills
            rep = probe.maybe_probe({"tokens": np.zeros((1, n_tok))}, None, None)
            seen[-1].append(None if rep is None else rep["prompt_tokens"])
    assert seen[1] == seen[0]
    assert any(seen[1]) and None in seen[1]
    (_, ref_reg, _), (_, port_reg, _) = sides
    for name in COUNTERS:
        assert port_reg.get(name).value() == ref_reg.get(name).value(), name
    assert port_reg.get("fidelity_probe_skipped_total").value() > 0


def test_failing_probe_is_swallowed_and_counted(monkeypatch):
    for probe, reg, _ in _probes(monkeypatch, every_n=1):
        def boom(*args):
            raise RuntimeError("probe fault")
        probe._probe = boom
        assert probe.maybe_probe({"tokens": np.zeros((1, 16))}, None, None) is None
        assert reg.get("fidelity_probe_errors_total").value() == 1
        assert reg.get("fidelity_probes_total").value() == 0
