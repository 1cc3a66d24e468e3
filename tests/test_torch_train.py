"""One-device training of the port (ROADMAP queue 1, item 10, its one-device
part) against the JAX reference: the data pipeline, ``Model.loss_fn`` and
its gradients, remat, gradient accumulation, the LR schedules, AdamW, the
train step, checkpoints, restart and preemption, and the launcher.

Both packages start from the reference's f32 master weights
(``params_from_reference(..., dtype=torch.float32)``) and the same batches
(smoke configs: 2 layers, d_model 64; gemma3 at one unit of 5 local + 1
global layers with ``local_window`` 8 and a logit softcap of 30, so the
window and the cap bite at 32 positions).  The reference runs jitted on the CPU; the port's CPU tensors
take the plain scan forward and its plain backward (``ref.linear_scan_bwd_ref``, through the
scan's autograd.Function), and training never reaches a kernel.

Limits, each measured on this file's inputs:

* loss within ``LOSS_ATOL`` (measured 4e-6 to 0.0052), the MoE aux loss
  within 1e-4 (measured 7.8e-6);
* each gradient leaf's relative Frobenius error and cosine within
  ``GRAD_DEFAULT`` 5e-2 / 0.99 (measured at most 0.0308 / at least 0.99954)
  except rwkv6 (``GRAD_LIMITS``), whose gradient at init is ill-conditioned:
  its per-head GroupNorm divides the scan's tiny outputs by sqrt(var +
  64e-5), so one bf16 rounding moves every gradient upstream of it (port
  0.398 / 0.977 measured; the reference against itself, jitted against
  ``jax.disable_jit``, reads 0.405 / 0.948);
* remat ``none`` / ``full`` / ``dots``: bit for bit;
* two microbatches against one: loss within ``MICRO_LOSS_ATOL``, gradients
  within ``MICRO_GRAD_RTOL`` (measured 4.8e-7 and 0.0025);
* AdamW: moments and parameters within ``ADAM_ULPS`` f32 ulps;
* ``lr_at``: within one f32 ulp;
* three train steps against the reference's step body (unsharded: see
  :func:`reference_step`):
  loss within ``LOSS_ATOL`` and, for every leaf of at least 1,000 elements,
  the update's cosine at least ``STEP_COS`` (Adam's first steps are
  sign-like, so entries near zero may flip);
* data tokens and a VLM's image embeddings bit for bit;
* 6 steps straight against 3 + restore + 3 within ``RESTORE_ATOL``, the
  reference's bound.
"""

import dataclasses
import functools
import os
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.data import synthetic as ref_data  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.optim import adamw as ref_adamw  # noqa: E402
from repro.optim import schedule as ref_schedule  # noqa: E402
from repro.train import loop as ref_loop  # noqa: E402
from repro.train import state as ref_state  # noqa: E402
from repro_torch.ckpt import checkpoint as ck  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.convert import opt_state_from_reference, params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim import adamw, schedule  # noqa: E402
from repro_torch.train import loop as train_loop_lib  # noqa: E402
from repro_torch.train.state import RunConfig, init_train_state  # noqa: E402

CPU = torch.device("cpu")
ARCHS = ("minicpm-2b", "qwen3-moe-235b-a22b", "paligemma-3b", "musicgen-medium", "gemma3-12b",
         "rwkv6-3b", "hymba-1.5b")
LOSS_ATOL = 1e-2
GRAD_LIMITS = {"rwkv6-3b": (0.5, 0.95)}   # (rel, cos); every other arch:
GRAD_DEFAULT = (5e-2, 0.99)
MICRO_LOSS_ATOL = 1e-5
MICRO_GRAD_RTOL = 1e-2
ADAM_ULPS = 2
STEP_COS = 0.98
RESTORE_ATOL = 1e-5
SEQ, BATCH = 32, 2


def configs(arch: str):
    """(reference, port) smoke configs; gemma3 at one 5 local + 1 global unit,
    its window and softcap biting at SEQ."""
    over = (dict(num_layers=6, local_window=8, attn_logit_softcap=30.0) if arch == "gemma3-12b"
            else {})
    return (dataclasses.replace(ref_smoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def to_np(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16
                                             else a), tree)


def port_batch(batch: dict) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.array(to_np(v)))
        out[k] = t.to(torch.bfloat16) if k == "img_embeds" else t
    return out


def rel_cos(a: torch.Tensor, b: torch.Tensor):
    a, b = a.double().flatten(), b.double().flatten()
    nb = float(b.norm())
    if nb == 0.0:
        return float(a.norm()), 1.0
    return float((a - b).norm()) / nb, float(a @ b) / max(float(a.norm()) * nb, 1e-300)


@functools.lru_cache(maxsize=None)
def reference_case(arch: str):
    """The reference's f32 params, a batch, and its jitted loss and grads."""
    rcfg, _ = configs(arch)
    m = ref_build_model(rcfg)
    params = m.init(jax.random.PRNGKey(0))
    batch = ref_data.make_batch(ref_data.DataConfig(seed=0, vocab_size=rcfg.vocab_size,
                                                    seq_len=SEQ, global_batch=BATCH), rcfg, 0)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(m.loss_fn, has_aux=True))(params, batch)
    return to_np(params), batch, float(loss), {k: float(v) for k, v in metrics.items()}, to_np(grads)


def port_model(arch: str, np_params):
    _, pcfg = configs(arch)
    model = params_from_reference(np_params, pcfg, CPU, torch.float32)
    return build_model(pcfg), model.requires_grad_(True)


def port_grads(arch: str, remat=False, remat_policy="full"):
    np_params, batch, *_ = reference_case(arch)
    m, model = port_model(arch, np_params)
    loss, metrics = m.loss_fn(model, port_batch(batch), remat=remat, remat_policy=remat_policy)
    loss.backward()
    return loss, metrics, {n: p.grad for n, p in model.named_parameters()}


# ---------------------------------------------------------------------------
# data


@pytest.mark.parametrize("arch", ["minicpm-2b", "musicgen-medium", "paligemma-3b"])
def test_make_batch_matches_reference_bit_for_bit(arch):
    rcfg, pcfg = ref_smoke_config(arch), smoke_config(arch)
    kw = dict(seed=3, vocab_size=rcfg.vocab_size, seq_len=64, global_batch=4)
    for step in (0, 1, 17):
        want = ref_data.make_batch(ref_data.DataConfig(**kw), rcfg, step)
        got = synthetic.make_batch(synthetic.DataConfig(**kw), pcfg, step, CPU)
        assert set(got) == set(want)
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        if "img_embeds" in want:
            assert got["img_embeds"].dtype == torch.bfloat16
            np.testing.assert_array_equal(got["img_embeds"].float().numpy(),
                                          to_np(want["img_embeds"]))


# ---------------------------------------------------------------------------
# loss and gradients


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    np_params, _, ref_loss, ref_metrics, ref_grads = reference_case(arch)
    loss, metrics, grads = port_grads(arch)
    assert abs(float(loss.detach()) - ref_loss) <= LOSS_ATOL
    assert abs(float(metrics["aux"].detach()) - ref_metrics["aux"]) <= 1e-4
    _, pcfg = configs(arch)
    want = dict(params_from_reference(ref_grads, pcfg, CPU, torch.float32).named_parameters())
    # every reference leaf has a port twin: the trees hold the same elements
    assert sum(g.numel() for g in grads.values()) == sum(
        x.size for x in jax.tree.leaves(ref_grads))
    rel_max, cos_min = GRAD_LIMITS.get(arch, GRAD_DEFAULT)
    for name, g in grads.items():
        rel, cos = rel_cos(g, want[name].detach())
        assert rel <= rel_max and cos >= cos_min, (name, rel, cos)


@pytest.mark.parametrize("arch", ["minicpm-2b", "qwen3-moe-235b-a22b", "hymba-1.5b",
                                  "rwkv6-3b"])
def test_remat_variants_are_bit_equal(arch):
    base = port_grads(arch)
    for remat_policy in ("full", "dots"):
        loss, metrics, grads = port_grads(arch, remat=True, remat_policy=remat_policy)
        assert torch.equal(loss, base[0]) and torch.equal(metrics["aux"], base[1]["aux"])
        for name, g in grads.items():
            assert torch.equal(g, base[2][name]), (remat_policy, name)


def test_dots_policy_keeps_only_matrix_products(monkeypatch):
    """The ``dots`` policy saves the outputs of ``aten.mm`` and recomputes
    the rest; the attention's batched products are recomputed."""
    from repro_torch.models import transformer as tfm
    seen = {}

    def spy(ctx, op, *args, **kwargs):
        out = tfm_policy(ctx, op, *args, **kwargs)
        seen.setdefault(str(op), out)
        return out

    tfm_policy = tfm._save_products
    monkeypatch.setattr(tfm, "_save_products", spy)
    port_grads("minicpm-2b", remat=True, remat_policy="dots")
    from torch.utils.checkpoint import CheckpointPolicy
    assert seen["aten.mm.default"] == CheckpointPolicy.MUST_SAVE
    assert seen["aten.bmm.default"] == CheckpointPolicy.PREFER_RECOMPUTE
    assert all(v == CheckpointPolicy.PREFER_RECOMPUTE for k, v in seen.items()
               if k != "aten.mm.default")


def test_training_reaches_no_kernel(monkeypatch):
    """``loss_fn`` never calls ``flash_attention`` (training attends through
    ``attention_train``), and on the CPU no wrapper launches."""
    def refuse(*a, **k):
        raise AssertionError("a kernel entry point was called on the training path")

    monkeypatch.setattr(ops, "flash_attention", refuse)
    port_grads("minicpm-2b", remat=True, remat_policy="dots")


def test_kernel_wrappers_refuse_grad():
    """The serving kernels' guard raises for an operand that requires grad on
    CUDA while grad mode is on (``on_cuda=True`` stands for the card here),
    and is silent under ``inference_mode`` / ``no_grad`` or for operands
    without grad."""
    x = torch.ones(2, requires_grad=True)
    with pytest.raises(RuntimeError, match="serving kernel has no backward") as err:
        _build.refuse_grad("gear_decode", (x,), "hint", on_cuda=True)
    assert "hint" in str(err.value)
    with pytest.raises(RuntimeError, match="attention_train"):
        _build.refuse_grad("flash_prefill", (x,), "use attention_train", on_cuda=True)
    _build.refuse_grad("q", (x,))                       # a CPU tensor: not a kernel call
    _build.refuse_grad("q", (x.detach(), None), on_cuda=True)
    with torch.no_grad():
        _build.refuse_grad("q", (x,), on_cuda=True)
    with torch.inference_mode():
        _build.refuse_grad("q", (x,), on_cuda=True)


def test_every_kernel_wrapper_calls_the_guard():
    """Every serving kernel's wrapper calls the guard before it launches;
    ``linear_scan_chunked`` calls none and sends a call that needs a
    gradient through its autograd.Function, whose backward is a kernel."""
    import inspect

    from repro_torch.kernels import (flash_prefill, gear_compress, gear_decode,
                                     linear_scan_kernel, quant_pack)
    wrappers = (flash_prefill.flash_prefill, flash_prefill.flash_prefill_block,
                gear_compress.gear_compress, gear_decode.gear_decode,
                gear_decode.gear_decode_paged, gear_decode.gear_decode_history,
                quant_pack.quant_pack)
    for fn in wrappers:
        src = inspect.getsource(fn)
        assert "_build.refuse_grad(" in src and src.index("refuse_grad") < src.index(
            "launches += 1"), fn.__name__
    scan = inspect.getsource(linear_scan_kernel)
    assert "refuse_grad" not in scan and "_Scan.apply(" in inspect.getsource(
        linear_scan_kernel.linear_scan_chunked)
    assert "linear_scan_chunked_bwd(" in inspect.getsource(linear_scan_kernel._Scan.backward)


# ---------------------------------------------------------------------------
# accumulation, schedules, AdamW


def test_two_microbatches_match_one():
    np_params, batch, *_ = reference_case("minicpm-2b")
    batch = port_batch(batch)
    results = []
    for m in (1, 2):
        bm, model = port_model("minicpm-2b", np_params)
        run = RunConfig(microbatches=m, remat=False)
        loss, _, grads = train_loop_lib._accum_grads(bm, model, batch, run)
        results.append((loss, {n: g.clone() for n, g in grads.items()}))
    (l1, g1), (l2, g2) = results
    assert abs(float(l1) - float(l2)) <= MICRO_LOSS_ATOL
    for name in g1:
        rel, _ = rel_cos(g2[name], g1[name])
        assert rel <= MICRO_GRAD_RTOL, (name, rel)


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_lr_at_matches_reference(kind):
    total, warmup = 57, 7
    f = jax.jit(lambda s: ref_schedule.lr_at(s, peak=3e-4, total_steps=total, warmup=warmup,
                                             kind=kind))
    for s in range(total + 1):
        want = np.float32(f(jnp.int32(s)))
        got = schedule.lr_at(s, peak=3e-4, total_steps=total, warmup=warmup, kind=kind)
        assert got.dtype == torch.float32
        assert abs(int(np.float32(float(got)).view(np.int32)) - int(want.view(np.int32))) <= 1, s


def ulps(a: np.ndarray, b: np.ndarray) -> int:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


@pytest.mark.parametrize("grad_scale", [0.01, 100.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    rng = np.random.RandomState(5)
    shapes = {"w": (64, 32), "b": (32,), "e": (16, 8)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: (rng.randn(*s) * grad_scale).astype(np.float32) for k, s in shapes.items()}
    mu = {k: (rng.randn(*s) * 0.01).astype(np.float32) for k, s in shapes.items()}
    nu = {k: np.abs(rng.randn(*s) * 1e-4).astype(np.float32) for k, s in shapes.items()}
    cfg = ref_adamw.AdamWConfig()
    lr = np.float32(2.5e-4)
    state = ref_adamw.AdamWState(mu=mu, nu=nu, count=jnp.int32(3))
    new_p, new_s, met = jax.jit(lambda g, s, p: ref_adamw.adamw_update(cfg, g, s, p, lr))(
        grads, state, params)
    t = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    pstate = adamw.AdamWState(mu={k: torch.from_numpy(v.copy()) for k, v in mu.items()},
                              nu={k: torch.from_numpy(v.copy()) for k, v in nu.items()}, count=3)
    _, got_s, got_m = adamw.adamw_update(adamw.AdamWConfig(**dataclasses.asdict(cfg)),
                                         {k: torch.from_numpy(v) for k, v in grads.items()},
                                         pstate, t, torch.tensor(lr))
    assert got_s.count == int(new_s.count) == 4
    assert ulps(float(got_m["grad_norm"]), float(met["grad_norm"])) <= ADAM_ULPS
    for k in shapes:
        assert ulps(got_s.mu[k].numpy(), new_s.mu[k]) <= ADAM_ULPS, k
        assert ulps(got_s.nu[k].numpy(), new_s.nu[k]) <= ADAM_ULPS, k
        assert ulps(t[k].numpy(), new_p[k]) <= ADAM_ULPS, k


def test_adamw_casts_back_to_the_parameter_dtype():
    p = {"w": torch.ones(4, 4, dtype=torch.bfloat16)}
    st = adamw.adamw_init(p)
    assert st.mu["w"].dtype == torch.float32
    adamw.adamw_update(adamw.AdamWConfig(), {"w": torch.ones(4, 4)}, st, p, torch.tensor(0.01))
    assert p["w"].dtype == torch.bfloat16 and float(p["w"][0, 0]) < 1.0


# ---------------------------------------------------------------------------
# the train step against the reference's


def reference_step(m, rcfg, run):
    """The reference's train step without shardings: the body of
    ``make_train_step``'s one-device step (its ``_accum_grads``, ``lr_at``
    and ``adamw_update``), jitted.  Its sharded form does not compile under
    jax 0.9, even on ``make_test_mesh(1, 1)``: a ``ShardingTypeError`` at the
    embedding gather, the error that fails the reference's own mesh tests."""
    def step(state, batch):
        loss, metrics, grads = ref_loop._accum_grads(m, state.params, batch, run)
        lr = ref_schedule.lr_at(state.step, peak=run.optimizer.lr_peak,
                                total_steps=run.total_steps, warmup=run.warmup_steps,
                                kind=rcfg.lr_schedule)
        params, opt, om = ref_adamw.adamw_update(run.optimizer, grads, state.opt,
                                                 state.params, lr)
        return (ref_state.TrainState(params=params, opt=opt, step=state.step + 1, ef=state.ef),
                dict(metrics, loss=loss, lr=lr, **om))
    return jax.jit(step)


def test_three_train_steps_match_reference():
    arch = "minicpm-2b"
    rcfg, pcfg = configs(arch)
    np_params, *_ = reference_case(arch)
    kw = dict(total_steps=8, warmup_steps=0, microbatches=2, remat=True, remat_policy="dots")
    rrun = ref_state.RunConfig(**kw)
    dkw = dict(seed=0, vocab_size=rcfg.vocab_size, seq_len=SEQ, global_batch=4)
    rdc = ref_data.DataConfig(**dkw)
    rstep = reference_step(ref_build_model(rcfg), rcfg, rrun)
    rstate = ref_state.init_train_state(jax.tree.map(jnp.asarray, np_params), rrun)
    bm, model = port_model(arch, np_params)
    pstate = init_train_state(model, RunConfig(**kw))
    pstep = train_loop_lib.make_train_step(bm, RunConfig(**kw))
    for s in range(3):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        ref_before = to_np(rstate.params)
        rstate, rmet = rstep(rstate, ref_data.make_batch(rdc, rcfg, s))
        pstate, pmet = pstep(pstate, synthetic.make_batch(synthetic.DataConfig(**dkw), pcfg,
                                                          s, CPU))
        assert pstate.step == int(rstate.step) == s + 1 and pstate.opt.count == s + 1
        assert abs(float(pmet["loss"]) - float(rmet["loss"])) <= LOSS_ATOL
        assert float(pmet["lr"]) == float(rmet["lr"])
        assert abs(float(pmet["grad_norm"]) / float(rmet["grad_norm"]) - 1) <= 0.05
        ref_delta = dict(params_from_reference(
            jax.tree.map(lambda a, b: np.asarray(a) - b, to_np(rstate.params), ref_before),
            pcfg, CPU, torch.float32).named_parameters())
        for n, p in model.named_parameters():
            if p.numel() >= 1000:
                _, cos = rel_cos(p.detach() - before[n], ref_delta[n].detach())
                assert cos >= STEP_COS, (s, n, cos)


def test_opt_state_from_reference_maps_moments_by_name():
    arch = "qwen3-moe-235b-a22b"
    np_params, *_ = reference_case(arch)
    _, pcfg = configs(arch)
    mu = jax.tree.map(lambda a: a + 1.0, np_params)
    nu = jax.tree.map(lambda a: a * 2.0, np_params)
    st = opt_state_from_reference(mu, nu, 7, pcfg, CPU)
    model = params_from_reference(np_params, pcfg, CPU, torch.float32)
    assert st.count == 7
    for n, p in model.named_parameters():
        assert st.mu[n].dtype == torch.float32
        torch.testing.assert_close(st.mu[n], p.detach() + 1.0, rtol=0, atol=0)
        torch.testing.assert_close(st.nu[n], p.detach() * 2.0, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# checkpoints, restart, preemption


def small_state(grad_compression="none"):
    model = build_model(smoke_config("minicpm-2b")).init(seed=1, device=CPU, dtype=torch.float32)
    return init_train_state(model, RunConfig(grad_compression=grad_compression,
                                             powersgd_min_size=4096))


def test_checkpoint_atomic_and_corruption_detected(tmp_path):
    state = small_state("powersgd")
    assert state.ef and all(e.abs().sum() == 0 for e in state.ef.values())
    state.opt.mu["embed"].fill_(0.5)
    state = dataclasses.replace(state, step=4, opt=dataclasses.replace(state.opt, count=4))
    d = ck.save(str(tmp_path), 4, state)
    assert os.path.exists(os.path.join(d, "_COMMITTED"))
    assert ck.latest_step(str(tmp_path)) == 4
    fresh = small_state("powersgd")
    with torch.no_grad():
        fresh.params.embed.add_(1.0)
    restored = ck.restore(str(tmp_path), 4, fresh)
    assert restored.step == 4 and restored.opt.count == 4
    for (n, p), (_, q) in zip(state.params.named_parameters(), restored.params.named_parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(restored.opt.mu["embed"], state.opt.mu["embed"])
    # corrupt a leaf: restore fails loudly and writes nothing
    np.save(os.path.join(d, "arr_0.npy"), np.load(os.path.join(d, "arr_0.npy")) + 1)
    before = small_state("powersgd")
    with pytest.raises(IOError):
        ck.restore(str(tmp_path), 4, before)
    assert torch.equal(before.params.embed, small_state().params.embed)


def test_checkpoint_keeps_bf16_leaves_and_refuses_another_tree(tmp_path):
    model = build_model(smoke_config("minicpm-2b")).init(seed=2, device=CPU)
    state = init_train_state(model, RunConfig())
    ck.save(str(tmp_path), 1, state)
    other = init_train_state(build_model(smoke_config("minicpm-2b")).init(seed=3, device=CPU),
                             RunConfig())
    ck.restore(str(tmp_path), 1, other)
    assert other.params.blocks[0].wq.dtype == torch.bfloat16
    assert torch.equal(other.params.blocks[0].wq, model.blocks[0].wq)
    with pytest.raises(ValueError):                    # f32 masters: another dtype
        ck.restore(str(tmp_path), 1, small_state())
    moe = build_model(smoke_config("qwen3-moe-235b-a22b")).init(seed=3, device=CPU)
    with pytest.raises(ValueError):                    # another model: other names
        ck.restore(str(tmp_path), 1, init_train_state(moe, RunConfig()))


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = ck.save(str(tmp_path), 3, small_state())
    os.remove(os.path.join(d, "_COMMITTED"))
    assert ck.latest_step(str(tmp_path)) is None
    ck.save_async(str(tmp_path), 5, small_state())
    ck.wait_pending()
    assert ck.latest_step(str(tmp_path)) == 5


RESTORE_DATA = dict(seed=0, seq_len=SEQ, global_batch=4)


def restore_run(tmp_path, name: str, total: int, **kw) -> RunConfig:
    return RunConfig(total_steps=total, warmup_steps=1, microbatches=2, remat=True,
                     ckpt_dir=str(tmp_path / name), ckpt_every=0, log_every=1, **kw)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """The parameters after 6 uninterrupted steps."""
    cfg = smoke_config("minicpm-2b")
    dc = synthetic.DataConfig(vocab_size=cfg.vocab_size, **RESTORE_DATA)
    run = restore_run(tmp_path_factory.mktemp("straight"), "a", 6)
    s = train_loop_lib.train_loop(build_model(cfg), run, dc, log_fn=lambda *_: None, device=CPU)
    return [p.detach().clone() for p in s.params.parameters()]


def max_diff(a: list, b) -> float:
    return max(float((x - y.detach()).abs().max()) for x, y in zip(a, b.parameters()))


def test_restore_equals_straight(tmp_path, straight):
    cfg = smoke_config("minicpm-2b")
    m = build_model(cfg)
    dc = synthetic.DataConfig(vocab_size=cfg.vocab_size, **RESTORE_DATA)
    s2 = train_loop_lib.train_loop(m, restore_run(tmp_path, "b", 3), dc,
                                   log_fn=lambda *_: None, device=CPU)
    ck.save(str(tmp_path / "b"), 3, s2)
    logs = []
    s3 = train_loop_lib.train_loop(m, restore_run(tmp_path, "b", 6), dc, log_fn=logs.append,
                                   device=CPU)
    assert logs[0] == "[restore] resumed from step 3" and s3.step == 6
    assert max_diff(straight, s3.params) < RESTORE_ATOL


def test_sigterm_saves_and_the_resumed_run_equals_the_straight_one(tmp_path, straight):
    cfg = smoke_config("minicpm-2b")
    m = build_model(cfg)
    dc = synthetic.DataConfig(vocab_size=cfg.vocab_size, **RESTORE_DATA)
    before = signal.getsignal(signal.SIGTERM)

    def log(line):
        if line.startswith("[step 1]"):
            handler = signal.getsignal(signal.SIGTERM)
            assert isinstance(handler.__self__, train_loop_lib._Preemption)
            os.kill(os.getpid(), signal.SIGTERM)

    run = restore_run(tmp_path, "c", 6)
    cut = train_loop_lib.train_loop(m, run, dc, log_fn=log, device=CPU)
    assert cut.step == 2 and ck.latest_step(run.ckpt_dir) == 2
    assert signal.getsignal(signal.SIGTERM) == before
    resumed = train_loop_lib.train_loop(m, run, dc, log_fn=lambda *_: None, device=CPU)
    assert resumed.step == 6
    assert max_diff(straight, resumed.params) < RESTORE_ATOL


# ---------------------------------------------------------------------------
# the launcher


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    launch_train.main(["--smoke", "--device", "cpu", "--steps", "4", "--batch", "4",
                       "--seq", "32", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "[step 0]" in out and "grad_norm=" in out and out.strip().endswith("done at step 4")


@pytest.mark.parametrize("flags,exit_match", [
    (["--mesh", "1x1"], None),
    (["--mesh", "2x2"], "world size of 4, and this job has 1.*torchrun --nproc-per-node 4"),
    (["--production-mesh"], "world size of 256, and this job has 1"),
], ids=["mesh-1x1-trains", "mesh-2x2-needs-4", "production-mesh-needs-256"])
def test_launcher_mesh_flags(flags, exit_match, tmp_path, capsys):
    """``--mesh 1x1`` trains on a one-process mesh (gloo on the CPU); a mesh
    larger than the job's world size exits naming the size it needs."""
    argv = flags + ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4", "--seq",
                    "32", "--ckpt-dir", str(tmp_path)]
    if exit_match is not None:
        with pytest.raises(SystemExit, match=exit_match):
            launch_train.main(argv)
    else:
        launch_train.main(argv)
        out = capsys.readouterr().out
        assert "[step 0]" in out and out.strip().endswith("done at step 2")
    assert not torch.distributed.is_initialized()
