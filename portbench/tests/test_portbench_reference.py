"""The plain reference against the port at smoke size on the CPU."""

import numpy as np
import pytest
import torch

from portbench import run, traffic, weights as weights_lib
from portbench.reference import gear, model as ref_model, prng
from portbench.tests.smoke import smoke_cell

CPU = torch.device("cpu")


def test_start_matrix_is_the_programs_draw():
    from repro_torch.core.lowrank import pi_init

    for d, r in ((64, 4), (64, 2), (128, 4), (128, 2)):
        got = prng.pi_start(d, r).numpy()
        assert np.abs(got - pi_init(d, r)).max() <= 2e-6 * max(1.0, np.abs(got).max())


@pytest.mark.parametrize("head_dim", [64, 128])
def test_chunk_reconstruction_is_the_programs(head_dim):
    from repro_torch.core import cache as cache_lib

    cell = smoke_cell()
    pol_file = cell["traffic"]["policy"]
    pol = run.program_policy(pol_file)
    cfg = cache_lib.CacheConfig(batch=1, kv_heads=2, head_dim=head_dim, capacity=128, policy=pol)
    g = torch.Generator().manual_seed(head_dim)
    k = torch.randn(1, 2, 128, head_dim, generator=g).bfloat16()
    v = torch.randn(1, 2, 128, head_dim, generator=g).bfloat16()
    cache = cache_lib.prefill_layer_cache(cfg, cache_lib.init_layer_cache(cfg, torch.bfloat16,
                                                                          CPU), k, v)
    k_hat, v_hat = cache_lib.dense_kv(cfg, cache)
    for x, got, kind in ((k, k_hat, "k"), (v, v_hat, "v")):
        want = gear.reconstruct(x.float().reshape(1, 2, 2, 64, head_dim), kind, pol_file, 4)
        # another orthonormal basis of the same span rounds to other bf16 factors
        assert (got - want.reshape(got.shape)).abs().max() <= 1e-3
        assert (got - x.float()).abs().max() > 0.05            # it is compressed


def _teacher_forced(cell, seed, policy_name=None):
    """The port's logits of a prompt and random continuation, decoded step by
    step through its cache, beside the reference's."""
    from repro_torch.core.policy import named_policy
    from repro_torch.models.model import Model

    m, t = cell["config"]["model"], cell["traffic"]
    w = weights_lib.make(m, seed, CPU)
    params = weights_lib.to_program(w, run.program_config(m))
    pol = named_policy(policy_name or t["policy"]["name"])
    prompt = torch.as_tensor(traffic.prompts(t, m["vocab_size"], seed, 0))
    n = t["new_tokens"]
    served = torch.randint(0, m["vocab_size"], (t["batch"], n),
                           generator=torch.Generator().manual_seed(seed))
    model = Model(params.cfg)
    lg, caches = model.prefill(params, {"tokens": prompt}, pol, t["capacity"])
    out = [lg[:, -1].float()]
    for i in range(n - 1):
        lg, caches = model.decode_step(params, {"tokens": served[:, i:i + 1]}, caches,
                                       t["prompt_len"] + i, pol, t["capacity"])
        out.append(lg[:, -1].float())
    seq = torch.cat([prompt.long(), served[:, :-1]], dim=1)
    return torch.stack(out, 1), w, seq


@pytest.mark.parametrize("mlp", [None, "gelu_mlp"])
def test_reference_logits_follow_the_port(mlp, monkeypatch):
    cell = smoke_cell(mlp=mlp)
    m, t = cell["config"]["model"], cell["traffic"]
    port, w, seq = _teacher_forced(cell, 3)
    ref = ref_model.logits(w, m, t["policy"], seq, t["prompt_len"])
    assert ref.shape == port.shape and 0.8 < float(ref.std()) < 1.3
    diff = (port - ref).abs()
    # the prefill's token: bf16 against f32 only
    assert float(diff[:, 0].max()) < 0.08
    # decode through the compressed cache: rounding moves quantisation codes, outliers and
    # the low-rank span, so the gap grows (PERF.md, "How correct is decided")
    assert float(diff.max()) < 0.5
    # without the compression the reference sits further from the port's decode logits
    monkeypatch.setattr(gear, "reconstruct", lambda x, kind, policy, rank: x.float())
    raw = ref_model.logits(w, m, t["policy"], seq, t["prompt_len"])
    assert float((port - raw).abs()[:, 1:].mean()) > 1.3 * float(diff[:, 1:].mean())


def test_uncompressed_reference_follows_the_fp16_port(monkeypatch):
    cell = smoke_cell()
    m, t = cell["config"]["model"], cell["traffic"]
    port, w, seq = _teacher_forced(cell, 5, policy_name="fp16")
    monkeypatch.setattr(gear, "reconstruct", lambda x, kind, policy, rank: x.float())
    ref = ref_model.logits(w, m, t["policy"], seq, t["prompt_len"])
    assert float((port - ref).abs().max()) < 0.08


def test_draw_widens_the_named_matrix():
    m = smoke_cell()["config"]["model"]
    plain = weights_lib.make(m, 4, CPU)
    wide = weights_lib.make(m, 4, CPU, {"std_factor": {"wq": 3.0}})
    ratio = float(wide["wq"].float().std() / plain["wq"].float().std())
    assert 2.9 < ratio < 3.1
    assert torch.equal(wide["wk"], plain["wk"]) and torch.equal(wide["embed"], plain["embed"])
    with pytest.raises(ValueError):
        weights_lib.make(m, 4, CPU, {"std_factor": {"w_nothing": 2.0}})
