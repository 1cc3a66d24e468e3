"""Parity of the port's hybrid path (hymba-1.5b: GEAR attention ∥ Mamba-2
SSM heads) with the JAX reference.

Inputs come from numpy seeds; the reference runs on the CPU as its own
tests do (the ``linear_scan_chunked`` Pallas kernel and the serving path's
``flash_prefill`` / ``gear_decode`` in interpret mode).  The port's CPU
tensors take the plain kernel versions.

Tolerances:

* the scan (``chunked_scan`` / ``linear_scan_ref``): 1e-4 x max(1, max |y_ref|)
  on y and the final state, f32 on both sides in another summation order
  (the clamp lets y grow, so the bound scales with it);
* the SSM branch on bf16 activations: ``PREFILL_ATOL`` absolute (torch and
  XLA round bf16 products after different sums, so a few entries of the
  gated SSM output enter the output projection one bf16 ulp apart; measured
  max 0.03125), the recurrent state within 1e-2 x max(1, max |state|);
* model logits and greedy tokens: ``PREFILL_ATOL`` / ``DECODE_MARGIN`` of
  ``tests/test_torch_serving.py`` (see there).
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
from repro.kernels.linear_scan_kernel import linear_scan_chunked as ref_scan_kernel  # noqa: E402
from repro.models import linear_scan as ref_ls  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.serving.engine import Engine as RefEngine  # noqa: E402
from repro.serving.engine import EngineConfig as RefEngineConfig  # noqa: E402
from repro.serving.scheduler import Request as RefRequest  # noqa: E402
from repro.serving.scheduler import Scheduler as RefScheduler  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import cache as cache_lib  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels.linear_scan_kernel import linear_scan_chunked  # noqa: E402
from repro_torch.models import linear_scan as ls  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402
from torch_fake_device import elsewhere  # noqa: E402

ARCH = "hymba-1.5b"
POLICY = "gear_kcvt4"
CAP = 128
EOS = 3
PREFILL_ATOL = 0.0625
DECODE_MARGIN = 0.3
SCAN_RTOL = 1e-4


def np32(x) -> np.ndarray:
    """jax or torch array -> numpy f32."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def bf16(x: np.ndarray):
    """The same bf16 values for both packages."""
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


def scan_inputs(seed: int, S: int, Dk: int, Dv: int, per_dk: bool, decay=None):
    rng = np.random.RandomState(seed)
    B, H = 1, 2
    r = rng.randn(B, H, S, Dk).astype(np.float32)
    k = rng.randn(B, H, S, Dk).astype(np.float32)
    v = rng.randn(B, H, S, Dv).astype(np.float32)
    shape = (B, H, S, Dk if per_dk else 1)
    if decay is None:
        lw = -np.logaddexp(0.0, rng.randn(*shape)).astype(np.float32)
    else:
        lw = np.full(shape, decay, np.float32)
    u = (rng.randn(H, Dk) * 0.5).astype(np.float32)
    return r, k, v, lw, u


def assert_scan_close(y, state, y_ref, state_ref):
    tol = SCAN_RTOL * max(1.0, float(np.abs(np32(y_ref)).max()))
    np.testing.assert_allclose(np32(y), np32(y_ref), rtol=0, atol=tol)
    np.testing.assert_allclose(np32(state), np32(state_ref), rtol=0,
                               atol=SCAN_RTOL * max(1.0, float(np.abs(np32(state_ref)).max())))


# ---------------------------------------------------------------------------
# the scan


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("S,chunk", [(128, 64), (200, 200)], ids=["aligned-64", "chunk=S-200"])
@pytest.mark.parametrize("per_dk", [False, True], ids=["log_w-1", "log_w-Dk"])
def test_chunked_scan_matches_reference_and_pallas_kernel(mode, S, chunk, per_dk):
    """The port's ``chunked_scan`` ([B, H, S, D]) against the reference's,
    and its plain kernel version (the ``linear_scan_chunked`` wrapper on
    CPU tensors, i.e. ``linear_scan_ref``, [BH, S, D]) against the Pallas
    kernel in interpret mode."""
    r, k, v, lw, u = scan_inputs(S + per_dk, S, 16, 24, per_dk)
    uu = u if mode == "bonus" else None
    y_ref, st_ref = ref_ls.chunked_scan(*map(jnp.asarray, (r, k, v, lw)), chunk=chunk,
                                        u=None if uu is None else jnp.asarray(uu), mode=mode)
    y, st = ls.chunked_scan(*map(torch.from_numpy, (r, k, v, lw)), chunk=chunk,
                            u=None if uu is None else torch.from_numpy(uu), mode=mode)
    assert y.dtype == torch.float32 and st.shape == (1, 2, 16, 24)
    assert_scan_close(y, st, y_ref, st_ref)

    flat = [x.reshape((2,) + x.shape[2:]) for x in (r, k, v, lw)]
    u_bh = np.broadcast_to(u[None], (1, 2, 16)).reshape(2, 16).copy()
    yk, stk = ref_scan_kernel(*map(jnp.asarray, flat), u=jnp.asarray(u_bh), chunk=chunk,
                              mode=mode, interpret=True)
    before = linear_scan_chunked.launches
    yp, stp = linear_scan_chunked(*map(torch.from_numpy, flat), torch.from_numpy(u_bh),
                                  chunk=chunk, mode=mode)
    assert linear_scan_chunked.launches == before           # CPU tensors: the plain version
    assert_scan_close(yp, stp, yk, stk)


def test_chunk_equal_to_S_clamp_is_the_reference_behaviour():
    """Pinned finding: a prompt of 200 tokens (not a multiple of 64) is
    scanned as one chunk of 200, and at the reference's init decay
    (log_w = -softplus(-1) = -0.313 per token: ``dt_bias`` -1, ``a_log`` 0)
    the factored form's clamps at e^-30 break the recurrence past ~100
    tokens.  The port computes what the reference computes; both are far
    from the exact sequential recurrence, which the aligned chunk of 64
    still matches."""
    r, k, v, lw, _ = scan_inputs(0, 200, 16, 64, per_dk=False, decay=-0.313)
    tr = [torch.from_numpy(x) for x in (r, k, v, lw)]
    y_ref, st_ref = ref_ls.chunked_scan(*map(jnp.asarray, (r, k, v, lw)), chunk=200)
    y, st = ls.chunked_scan(*tr, chunk=200)
    assert_scan_close(y, st, y_ref, st_ref)
    y_seq, _ = ls.sequential_scan_ref(*tr)
    y_seq_ref, _ = ref_ls.sequential_scan_ref(*map(jnp.asarray, (r, k, v, lw)))
    np.testing.assert_allclose(np32(y_seq), np32(y_seq_ref), rtol=0, atol=1e-3)
    assert float(np.abs(np32(y) - np32(y_seq)).max()) > 1.0
    assert float(np.abs(np32(y_ref) - np32(y_seq_ref)).max()) > 1.0
    y64, _ = ls.chunked_scan(*[x[:, :, :192] for x in tr], chunk=64)
    np.testing.assert_allclose(np32(y64), np32(y_seq)[:, :, :192], rtol=0, atol=1e-3)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_decode_step_matches_reference(mode):
    rng = np.random.RandomState(5)
    r, k = rng.randn(2, 3, 16).astype(np.float32), rng.randn(2, 3, 16).astype(np.float32)
    v = rng.randn(2, 3, 8).astype(np.float32)
    lw = -np.logaddexp(0.0, rng.randn(2, 3, 1)).astype(np.float32)
    st0 = rng.randn(2, 3, 16, 8).astype(np.float32)
    u = rng.randn(3, 16).astype(np.float32)
    uu = u if mode == "bonus" else None
    y_ref, st_ref = ref_ls.decode_step(*map(jnp.asarray, (r, k, v, lw, st0)),
                                       u=None if uu is None else jnp.asarray(uu), mode=mode)
    y, st = ls.decode_step(*map(torch.from_numpy, (r, k, v, lw, st0)),
                           u=None if uu is None else torch.from_numpy(uu), mode=mode)
    np.testing.assert_allclose(np32(y), np32(y_ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np32(st), np32(st_ref), rtol=0, atol=1e-5)


def test_scan_wrapper_rejects_what_it_does_not_take():
    r = torch.zeros(2, 100, 16)
    with pytest.raises(ValueError, match="does not divide"):
        linear_scan_chunked(r, r, r, r[..., :1], chunk=64)
    with pytest.raises(ValueError, match="needs u"):
        linear_scan_chunked(r, r, r, r[..., :1], chunk=100, mode="bonus")
    with pytest.raises(ValueError, match="mode"):
        linear_scan_chunked(r, r, r, r[..., :1], chunk=100, mode="exclusive")
    # an initial state runs on the CPU (the plain version) ...
    st0 = torch.ones(1, 2, 16, 16)
    y, st = ls.chunked_scan(r[None], r[None], r[None], r[None, ..., :1], chunk=100, state0=st0)
    assert torch.equal(st, st0)                   # zero inputs, zero decay: state kept


# ---------------------------------------------------------------------------
# the model


class Pair:
    """Both packages' smoke hymba on the reference's parameters, plus the
    reference's jitted batch-1 prefill/decode (interpret kernels)."""

    def __init__(self):
        self.ref_cfg = ref_smoke_config(ARCH)
        self.ref_model = ref_build_model(self.ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.ref_policy = ref_named_policy(POLICY)
        self.cfg = smoke_config(ARCH)
        self.model = build_model(self.cfg)
        self.params = params_from_reference(jax.tree.map(np.asarray, self.ref_params),
                                            self.cfg, device="cpu")
        self.policy = named_policy(POLICY)
        m, pol = self.ref_model, self.ref_policy
        self.ref_prefill = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP,
                                                          fused="interpret"))
        self.ref_decode = jax.jit(lambda p, t, c, pos: m.decode_step(
            p, {"tokens": t}, c, pos, pol, CAP, fused="interpret"))

    def ssm_params(self, layer: int):
        return jax.tree.map(lambda a: a[layer], self.ref_params["blocks"][0]["ssm"])

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


def margin(logits: np.ndarray) -> float:
    top2 = np.sort(logits)[-2:]
    return float(top2[1] - top2[0])


def test_config_weights_and_init_constants(pair):
    """The smoke config equals the reference's (2 layers, 4 heads, 2 KV
    heads, head_dim 16, ssm_state 16); the SSM subtree comes across with
    matrices in bf16 and conv_w and the per-head vectors in f32; random
    weights carry the reference's SSM constants."""
    assert dataclasses.asdict(pair.cfg) == dataclasses.asdict(pair.ref_cfg)
    assert (pair.cfg.num_layers, pair.cfg.num_kv_heads, pair.cfg.head_dim) == (2, 2, 16)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.head_dim, full.d_ff, full.vocab_size, full.ssm_state) == (
        32, 1600, 25, 5, 64, 5504, 32001, 16)
    for i, blk in enumerate(pair.params.blocks):
        ref = pair.ssm_params(i)
        for name in ("w_in", "w_bcdt", "w_out"):
            assert getattr(blk, name).dtype == torch.bfloat16
            np.testing.assert_array_equal(np32(getattr(blk, name)),
                                          np32(jnp.asarray(ref[name]).astype(jnp.bfloat16)))
        for name in ("conv_w", "a_log", "dt_bias", "d_skip"):
            assert getattr(blk, name).dtype == torch.float32
            np.testing.assert_array_equal(np32(getattr(blk, name)), np.asarray(ref[name]))
    rnd = Transformer.random(pair.cfg, seed=3, device="cpu")
    blk = rnd.blocks[1]
    assert float(blk.a_log.abs().max()) == 0.0
    assert torch.equal(blk.dt_bias, torch.full((4,), -1.0))
    assert torch.equal(blk.d_skip, torch.ones(4))
    assert 0.3 < float(blk.conv_w.std()) < 0.7                 # fan_in 4: std 0.5


@pytest.mark.parametrize("S", [70, 64, 2], ids=["S70-chunk=S", "S64-aligned", "S2-short-conv"])
def test_ssm_apply_and_decode_match_reference(pair, S):
    """``ssm_apply`` (prefill: y and the final conv window / state) and then
    two ``ssm_decode`` steps from that state, on the reference's layer-0
    SSM weights; S = 2 left-pads the conv tail."""
    rng = np.random.RandomState(S)
    xj, xt = bf16(rng.randn(2, S, 64).astype(np.float32))
    p = pair.ssm_params(0)
    blk = pair.params.blocks[0]
    y_ref, st_ref = jax.jit(lambda p, x: ref_ssm.ssm_apply(pair.ref_cfg, p, x))(p, xj)
    y, st = ssm.ssm_apply(pair.cfg, blk, xt)
    np.testing.assert_allclose(np32(y), np32(y_ref), rtol=0, atol=PREFILL_ATOL)
    np.testing.assert_array_equal(np32(st.conv), np32(st_ref.conv))
    np.testing.assert_allclose(np32(st.state), np32(st_ref.state), rtol=0,
                               atol=1e-2 * max(1.0, float(np.abs(np32(st_ref.state)).max())))
    dec = jax.jit(lambda p, x, s: ref_ssm.ssm_decode(pair.ref_cfg, p, x, s))
    for t in range(2):
        xj1, xt1 = bf16(rng.randn(2, 1, 64).astype(np.float32))
        y_ref, st_ref = dec(p, xj1, st_ref)
        y, st = ssm.ssm_decode(pair.cfg, blk, xt1, st)
        np.testing.assert_allclose(np32(y), np32(y_ref), rtol=0, atol=PREFILL_ATOL)
        np.testing.assert_allclose(np32(st.state), np32(st_ref.state), rtol=0,
                                   atol=1e-2 * max(1.0, float(np.abs(np32(st_ref.state)).max())))
        assert st.conv.shape == (2, 3, 64)


def test_prefill_logits_and_greedy_decode_match_reference(pair):
    """Prefill of an unaligned 50-token prompt (SSM scan chunk = S) within
    PREFILL_ATOL, then 24 teacher-forced greedy decode steps crossing a
    chunk close at length 64, under the margin rule."""
    prompt = np.random.RandomState(7).randint(0, pair.cfg.vocab_size, size=50).astype(np.int32)
    ref_logits, ref_caches = pair.ref_prefill(pair.ref_params, jnp.asarray(prompt[None]))
    logits, caches = pair.model.prefill(pair.params, {"tokens": prompt[None]}, pair.policy, CAP)
    ref_last, last = np32(ref_logits[0, -1]), np32(logits[0, -1])
    assert np.abs(ref_last - last).max() <= PREFILL_ATOL
    gear, st = caches[0]
    assert gear.length.tolist() == [50] and st.state.shape == (1, 4, 16, 16)

    compared = 0
    tok = int(ref_last.argmax())
    if margin(ref_last) > 2 * PREFILL_ATOL:
        assert int(last.argmax()) == tok
        compared += 1
    for i in range(24):
        pos = len(prompt) + i
        ref_logits, ref_caches = pair.ref_decode(pair.ref_params, jnp.asarray([[tok]], jnp.int32),
                                                 ref_caches, jnp.asarray([pos], jnp.int32))
        logits, caches = pair.model.decode_step(pair.params, {"tokens": np.array([[tok]])},
                                                caches, np.array([pos]), pair.policy, CAP)
        ref_last, last = np32(ref_logits[0, -1]), np32(logits[0, -1])
        tok = int(ref_last.argmax())
        if margin(ref_last) > DECODE_MARGIN:
            assert int(last.argmax()) == tok, f"decode step {i}: margin {margin(ref_last)}"
            compared += 1
    assert caches[0][0].length.tolist() == [len(prompt) + 24]
    assert int(caches[0][0].k_scale[0, :, 0].abs().sum() > 0)      # the chunk closed
    ref_state = np32(ref_caches[0][1].state[0])
    np.testing.assert_allclose(np32(caches[0][1].state), ref_state, rtol=0,
                               atol=2e-2 * max(1.0, float(np.abs(ref_state).max())))
    assert compared >= 5, f"only {compared} of 25 tokens cleared the margin"


def workload():
    rng = np.random.RandomState(3)
    lengths = [70, 64, 70, 64]
    budgets = [6, 20, 1, 12]
    return [(rid, rng.randint(0, 512, size=n).astype(np.int32), b)
            for rid, (n, b) in enumerate(zip(lengths, budgets))]


def test_run_continuous_matches_reference_engine(pair):
    """Mixed-length continuous batching (2 slots, 4 requests, aligned and
    unaligned prompts, a chunk close during decode): per-rid greedy tokens
    equal the reference Engine's (fused="interpret") under the margin rule;
    every request ends OK with its budget or EOS; a solo run gives the same
    tokens bit for bit (the pair cache splices and resets per slot)."""
    ref_eng = RefEngine(pair.ref_model, pair.ref_params,
                        RefEngineConfig(batch=2, capacity=CAP, policy=pair.ref_policy,
                                        eos_id=EOS, fused="interpret"))
    ref_sched = RefScheduler(ref_eng)
    for rid, toks, budget in workload():
        ref_sched.submit(RefRequest(rid=rid, tokens=toks, max_new_tokens=budget))
    ref = {r.rid: r for r in ref_sched.run_continuous()}

    def run(batch):
        eng = Engine(pair.model, pair.params,
                     EngineConfig(batch=batch, capacity=CAP, policy=pair.policy, eos_id=EOS),
                     device="cpu")
        sched = Scheduler(eng)
        for rid, toks, budget in workload():
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=budget))
        return {r.rid: r for r in sched.run_continuous()}, sched.last_stats

    port, stats = run(2)
    assert sorted(port) == sorted(ref) == list(range(4))
    assert stats["statuses"] == {"ok": 4}
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


def test_pair_cache_slot_protocol_and_guard(pair):
    """splice_slot / reset_slot / tree_finite cover the SSM state beside its
    GEAR cache: a splice writes one slot's conv window and state, a reset
    zeroes them, and a NaN in the state trips the guard."""
    caches = pair.model.init_caches(pair.policy, 2, CAP, device="cpu")
    prompt = np.arange(1, 41, dtype=np.int32)[None]
    _, one = pair.model.prefill(pair.params, {"tokens": prompt}, pair.policy, CAP)
    for full, o in zip(caches, one):
        cache_lib.splice_slot(full, o, 1)
    gear, st = caches[0]
    assert torch.equal(st.state[1], one[0][1].state[0]) and float(st.state[0].abs().max()) == 0
    assert torch.equal(st.conv[1], one[0][1].conv[0]) and gear.length.tolist() == [0, 40]
    assert bool(cache_lib.tree_finite(caches))
    with torch.inference_mode():
        one[1][1].state[0, 0, 0, 0] = float("nan")
    assert not bool(cache_lib.tree_finite(one))
    cache_lib.reset_slot(caches[0], 1)
    assert float(st.state.abs().max()) == 0 and float(st.conv.float().abs().max()) == 0
    assert gear.length.tolist() == [0, 0]


@pytest.mark.parametrize("options", [dict(layout="paged"), dict(prefill_mode="streaming"),
                                     dict(prefill_mode="streaming", layout="paged")],
                         ids=["paged", "streaming", "streaming-paged"])
def test_hybrid_paged_and_streaming_raise(pair, options):
    """A hybrid serves on the dense layout only (either prefill mode, as in
    the reference): the paged layout raises with either prefill mode.
    Streaming prefill serves, unbucketed; a suffix or a padded tail, and the
    prefix cache, raise the reference's errors (an SSM state does not resume
    from a chunk boundary)."""
    ecfg = EngineConfig(batch=1, capacity=CAP, policy=pair.policy, **options)
    if options.get("layout") == "paged":
        with pytest.raises(NotImplementedError, match="hybrid"):
            Engine(pair.model, pair.params, ecfg, device="cpu")
        with pytest.raises(NotImplementedError, match="layout='dense'"):
            pair.model.init_caches(pair.policy, 1, CAP, device="cpu", layout="paged",
                                   pool_pages=4)
        return
    eng = Engine(pair.model, pair.params, ecfg, device="cpu")
    assert not eng._can_bucket
    logits, caches = pair.model.prefill(pair.params, {"tokens": np.ones((1, 70), np.int32)},
                                        pair.policy, CAP, prefill_mode="streaming")
    assert logits.shape == (1, 1, pair.cfg.vocab_size) and caches[0][0].length.tolist() == [70]
    with pytest.raises(ValueError, match="hybrid SSM state"):
        pair.model.prefill(pair.params, {"tokens": np.ones((1, 128), np.int32)}, pair.policy,
                           CAP, prefill_mode="streaming", padded_tail=True, true_len=70)
    with pytest.raises(ValueError, match="hybrid SSM state"):
        pair.model.prefill_suffix(pair.params, {"tokens": np.ones((1, 6), np.int32)},
                                  [c[0] for c in caches], 64, pair.policy, CAP)
    with pytest.raises(ValueError, match="hybrid SSM state is not chunk-decomposable"):
        Engine(pair.model, pair.params, dataclasses.replace(ecfg, prefix_cache=True),
               device="cpu")


def test_scan_state0_on_a_card_raises():
    """An initial state goes to the kernel like every other operand: off the
    CPU, ``chunked_scan(..., state0=...)`` reaches the ``linear_scan_chunked``
    wrapper, which launches the kernel on a CUDA tensor and raises for a
    device without one; nothing runs the plain version there.  Checked
    without a card through tensors of a device that has neither a kernel
    nor a plain version (``torch_fake_device``); meta tensors, the dry
    run's, take the plain version as CPU ones do."""
    r = torch.zeros(1, 2, 64, 16, device="meta")
    st0 = torch.zeros(1, 2, 16, 16, device="meta")
    y, st = ls.chunked_scan(r, r, r, r[..., :1], state0=st0)
    assert y.device.type == "meta" and y.shape == r.shape and st.shape == st0.shape
    r, lw, st0 = elsewhere(r), elsewhere(torch.zeros(1, 2, 64, 1)), elsewhere(st0)
    with pytest.raises(ValueError, match="no kernel for device"):
        ls.chunked_scan(r, r, r, lw, state0=st0)
    with pytest.raises(ValueError, match="no kernel for device"):
        ls.chunked_scan(r, r, r, r, u=elsewhere(torch.zeros(2, 16)), state0=st0, mode="bonus")
    r0 = elsewhere(torch.zeros(2, 64, 16))
    with pytest.raises(ValueError, match="no kernel for device"):
        linear_scan_chunked(r0, r0, r0, elsewhere(torch.zeros(2, 64, 1)), chunk=64)
