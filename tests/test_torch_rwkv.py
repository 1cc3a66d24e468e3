"""Parity of the port's RWKV6 path (rwkv6-3b: time mix + channel mix over a
data-dependent-decay recurrence, no KV cache) with the JAX reference.

Inputs come from numpy seeds; the reference runs on the CPU as its own tests
do (its RWKV6 blocks call the jnp ``chunked_scan``; the ``linear_scan_chunked``
Pallas kernel runs in interpret mode where its contract covers the case,
i.e. from a zero state).  The port's CPU tensors take the plain kernel
version.

Tolerances:

* the scan with an initial state: ``SCAN_RTOL`` = 1e-4 x max(1, max |ref|)
  on y and the final state, f32 on both sides in another summation order;
* a time-mix / channel-mix layer on bf16 activations: ``LAYER_ATOL`` =
  0.03125 absolute, two bf16 ulps at the outputs' magnitude (|y| < 4):
  torch and XLA round bf16 products after different sums, so a few entries
  reach the output projection one bf16 ulp apart (measured max 0.0156); the
  carried shifts bit-equal (they are the layer's own bf16 input); the
  recurrent state within 1e-3 x max(1, max |state|) (measured 5.6e-5);
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
from repro.models import rwkv as ref_rwkv  # noqa: E402
from repro.models.common import layernorm as ref_layernorm  # noqa: E402
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
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.models.common import layernorm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402
from repro_torch.serving.scheduler import Request, Scheduler  # noqa: E402

ARCH = "rwkv6-3b"
POLICY = "gear_kcvt4"
CAP = 128
EOS = 3
PREFILL_ATOL = 0.0625
DECODE_MARGIN = 0.3
LAYER_ATOL = 0.03125
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


def close(got, want, rtol: float = SCAN_RTOL):
    want = np32(want)
    np.testing.assert_allclose(np32(got), want, rtol=0,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


# ---------------------------------------------------------------------------
# the scan from an initial state


def bonus_inputs(seed: int, S: int, Dk: int = 16, Dv: int = 16):
    """RWKV-like operands: per-Dk log w = -exp(x - 2), bonus u, a non-zero
    initial state."""
    rng = np.random.RandomState(seed)
    B, H = 2, 3
    r, k = (rng.randn(B, H, S, Dk).astype(np.float32) for _ in range(2))
    v = rng.randn(B, H, S, Dv).astype(np.float32)
    lw = -np.exp(rng.randn(B, H, S, Dk) * 0.5 - 2.0).astype(np.float32)
    u = (rng.randn(H, Dk) * 0.5).astype(np.float32)
    st0 = rng.randn(B, H, Dk, Dv).astype(np.float32)
    return r, k, v, lw, u, st0


@pytest.mark.parametrize("S,chunk", [(1, 1), (70, 70), (128, 64)],
                         ids=["decode-S1", "chunk=S-70", "aligned-64"])
def test_chunked_scan_with_state0_matches_reference(S, chunk):
    """``bonus`` mode from a non-zero state: the decode step's S = chunk = 1,
    a prefill-sized chunk = S, and aligned chunks carrying the state; the
    port against the reference's ``chunked_scan`` and, at chunks short
    enough for the clamps not to bite, against the exact recurrence."""
    r, k, v, lw, u, st0 = bonus_inputs(S, S)
    y_ref, st_ref = ref_ls.chunked_scan(*map(jnp.asarray, (r, k, v, lw)), chunk=chunk,
                                        u=jnp.asarray(u), state0=jnp.asarray(st0), mode="bonus")
    tr = [torch.from_numpy(x) for x in (r, k, v, lw, u, st0)]
    before = linear_scan_chunked.launches
    y, st = ls.chunked_scan(*tr[:4], chunk=chunk, u=tr[4], state0=tr[5], mode="bonus")
    assert linear_scan_chunked.launches == before       # CPU tensors: the plain version
    close(y, y_ref)
    close(st, st_ref)
    if chunk <= 64:
        y_seq, st_seq = ls.sequential_scan_ref(*tr[:4], u=tr[4], state0=tr[5], mode="bonus")
        close(y, y_seq, 1e-3)
        close(st, st_seq, 1e-3)


def test_zero_state_scan_matches_pallas_kernel_at_rwkv_shape():
    """From a zero state the Pallas kernel's contract covers the RWKV case:
    per-Dk decay, ``bonus``, chunk = S (an unaligned prompt) and chunks of
    64; the wrapper's plain version equals it in interpret mode."""
    for S, chunk in ((50, 50), (128, 64)):
        r, k, v, lw, u, _ = bonus_inputs(S + 1, S)
        flat = [x.reshape((6,) + x.shape[2:]) for x in (r, k, v, lw)]
        u_bh = np.broadcast_to(u[None], (2, 3, 16)).reshape(6, 16).copy()
        yk, stk = ref_scan_kernel(*map(jnp.asarray, flat), u=jnp.asarray(u_bh), chunk=chunk,
                                  mode="bonus", interpret=True)
        yp, stp = linear_scan_chunked(*map(torch.from_numpy, flat), torch.from_numpy(u_bh),
                                      chunk=chunk, mode="bonus")
        close(yp, yk)
        close(stp, stk)


# ---------------------------------------------------------------------------
# the model


class Pair:
    """Both packages' smoke rwkv6-3b on the reference's parameters, plus the
    reference's jitted batch-1 prefill/decode."""

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
        self.ref_prefill = jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP))
        self.ref_decode = jax.jit(lambda p, t, c, pos: m.decode_step(
            p, {"tokens": t}, c, pos, pol, CAP))

    def layer(self, i: int):
        return jax.tree.map(lambda a: a[i], self.ref_params["blocks"][0])

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
    """The smoke config equals the reference's (2 layers, d 64, 4 heads of
    16, d_ff 128, vocab 512); ``params_from_reference`` brings every ``tm``
    / ``cm`` leaf and the LayerNorms across (matrices in bf16, the rest in
    f32); random weights carry the reference's constants and draw the 3-D
    ``mix_lora_b`` with fan_in 32."""
    assert dataclasses.asdict(pair.cfg) == dataclasses.asdict(pair.ref_cfg)
    assert (pair.cfg.num_layers, pair.cfg.d_model, pair.cfg.num_heads, pair.cfg.head_dim,
            pair.cfg.d_ff, pair.cfg.vocab_size) == (2, 64, 4, 16, 128, 512)
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.head_dim, full.d_ff,
            full.vocab_size, full.rwkv, full.tie_embeddings, full.norm) == (
        32, 2560, 40, 64, 8960, 65_536, True, True, "rmsnorm")
    assert pair.params.lm_head is None
    for i, blk in enumerate(pair.params.blocks):
        ref = pair.layer(i)
        for sub in ("tm", "cm"):
            for name, p in getattr(blk, sub).named_parameters():
                want = np.asarray(ref[sub][name])
                if p.dtype == torch.bfloat16:
                    want = np32(jnp.asarray(want).astype(jnp.bfloat16))
                else:
                    assert p.dtype == torch.float32
                np.testing.assert_array_equal(np32(p), want, err_msg=f"{sub}.{name}")
        for n in (1, 2):
            np.testing.assert_array_equal(np32(getattr(blk, f"ln{n}_scale")),
                                          np.asarray(ref[f"ln{n}"]["scale"]))
            np.testing.assert_array_equal(np32(getattr(blk, f"ln{n}_bias")),
                                          np.asarray(ref[f"ln{n}"]["bias"]))
    rnd = Transformer.random(pair.cfg, seed=3, device="cpu")
    tm, cm = rnd.blocks[1].tm, rnd.blocks[1].cm
    assert torch.equal(tm.mix_base, torch.full((5, 64), 0.5))
    assert torch.equal(tm.w0, torch.full((64,), -2.0))
    assert float(tm.u.abs().max()) == 0.0
    assert torch.equal(tm.ln_scale, torch.ones(64)) and float(tm.ln_bias.abs().max()) == 0.0
    assert torch.equal(cm.mix_k, torch.full((64,), 0.5)) and torch.equal(cm.mix_r, cm.mix_k)
    assert torch.equal(rnd.blocks[0].ln1_scale, torch.ones(64))
    assert float(rnd.blocks[0].ln2_bias.abs().max()) == 0.0
    assert 0.12 < float(tm.mix_lora_b.float().std()) < 0.24        # fan_in 32: std 0.177
    assert 0.09 < float(tm.wr.float().std()) < 0.16                # fan_in 64: std 0.125
    assert 0.06 < float(cm.wv.float().std()) < 0.11                # fan_in 128: std 0.088


def test_layernorm_matches_reference():
    rng = np.random.RandomState(4)
    xj, xt = bf16(rng.randn(2, 5, 64).astype(np.float32) * 3 + 1)
    scale, bias = rng.randn(64).astype(np.float32), rng.randn(64).astype(np.float32)
    want = ref_layernorm(xj, jnp.asarray(scale), jnp.asarray(bias))
    got = layernorm(xt, torch.from_numpy(scale), torch.from_numpy(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(np32(got), np32(want), rtol=0, atol=3e-2)   # one bf16 ulp at |x| < 8


def random_state(seed: int, B: int = 2):
    rng = np.random.RandomState(seed)
    sj, st = bf16(rng.randn(B, 64).astype(np.float32))
    cj, ct = bf16(rng.randn(B, 64).astype(np.float32))
    wkv = (rng.randn(B, 4, 16, 16) * 0.5).astype(np.float32)
    return (ref_rwkv.RWKVState(shift_tm=sj, shift_cm=cj, wkv=jnp.asarray(wkv)),
            rwkv.RWKVState(shift_tm=st, shift_cm=ct, wkv=torch.from_numpy(wkv)))


@pytest.mark.parametrize("S,with_state", [(70, False), (64, False), (64, True), (1, True)],
                         ids=["S70-chunk=S", "S64-aligned", "S64-from-state", "S1-from-state"])
def test_time_mix_and_channel_mix_match_reference(pair, S, with_state):
    """``time_mix_apply`` / ``channel_mix_apply`` on the reference's layer-0
    weights: output, carried shifts and recurrent state, from no state
    (prefill) or from a random one."""
    rng = np.random.RandomState(S + with_state)
    xj, xt = bf16(rng.randn(2, S, 64).astype(np.float32))
    p, blk = pair.layer(0), pair.params.blocks[0]
    ref_state, state = random_state(S) if with_state else (None, None)
    y_ref, (sh_ref, wkv_ref) = jax.jit(
        lambda p, x, s: ref_rwkv.time_mix_apply(pair.ref_cfg, p, x, s))(p, xj, ref_state)
    y, (sh, wkv) = rwkv.time_mix_apply(pair.cfg, blk, xt, state)
    assert y.dtype == torch.bfloat16 and wkv.dtype == torch.float32
    np.testing.assert_allclose(np32(y), np32(y_ref), rtol=0, atol=LAYER_ATOL)
    np.testing.assert_array_equal(np32(sh), np32(sh_ref))
    close(wkv, wkv_ref, 1e-3)
    c_ref, csh_ref = jax.jit(
        lambda p, x, s: ref_rwkv.channel_mix_apply(pair.ref_cfg, p, x, s))(p, xj, ref_state)
    c, csh = rwkv.channel_mix_apply(pair.cfg, blk, xt, state)
    np.testing.assert_allclose(np32(c), np32(c_ref), rtol=0, atol=LAYER_ATOL)
    np.testing.assert_array_equal(np32(csh), np32(csh_ref))


def test_decode_steps_match_reference(pair):
    """Three ``time_mix_decode`` + ``channel_mix_decode`` steps on layer-1
    weights from a random state, each feeding the next; the given state is
    left as it was (the caller writes the new one back)."""
    p, blk = pair.layer(1), pair.params.blocks[1]
    ref_state, state = random_state(9)
    before = {n: t.clone() for n, t in state.tensors().items()}
    tm_dec = jax.jit(lambda p, x, s: ref_rwkv.time_mix_decode(pair.ref_cfg, p, x, s))
    cm_dec = jax.jit(lambda p, x, s: ref_rwkv.channel_mix_decode(pair.ref_cfg, p, x, s))
    rng = np.random.RandomState(11)
    for t in range(3):
        xj, xt = bf16(rng.randn(2, 1, 64).astype(np.float32))
        y_ref, ref_state = tm_dec(p, xj, ref_state)
        c_ref, ref_state = cm_dec(p, xj, ref_state)
        y, new = rwkv.time_mix_decode(pair.cfg, blk, xt, state)
        c, new = rwkv.channel_mix_decode(pair.cfg, blk, xt, new)
        if t == 0:
            for n, v in state.tensors().items():
                assert torch.equal(v, before[n])
        state = new
        np.testing.assert_allclose(np32(y), np32(y_ref), rtol=0, atol=LAYER_ATOL)
        np.testing.assert_allclose(np32(c), np32(c_ref), rtol=0, atol=LAYER_ATOL)
        for n in ("shift_tm", "shift_cm"):
            np.testing.assert_array_equal(np32(getattr(state, n)), np32(getattr(ref_state, n)))
        close(state.wkv, ref_state.wkv, 1e-3)


def test_prefill_logits_and_greedy_decode_match_reference(pair):
    """Prefill of an unaligned 50-token prompt (the scan's chunk = S) within
    PREFILL_ATOL, then 24 teacher-forced greedy decode steps, each scanning
    one token from the layer's state, under the margin rule."""
    prompt = np.random.RandomState(7).randint(0, pair.cfg.vocab_size, size=50).astype(np.int32)
    ref_logits, ref_caches = pair.ref_prefill(pair.ref_params, jnp.asarray(prompt[None]))
    logits, caches = pair.model.prefill(pair.params, {"tokens": prompt[None]}, pair.policy, CAP)
    ref_last, last = np32(ref_logits[0, -1]), np32(logits[0, -1])
    assert np.abs(ref_last - last).max() <= PREFILL_ATOL
    st = caches[0]
    assert isinstance(st, rwkv.RWKVState) and st.wkv.shape == (1, 4, 16, 16)
    assert st.shift_tm.dtype == st.shift_cm.dtype == torch.bfloat16

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
    for layer in range(2):
        close(caches[layer].wkv, ref_caches[0].wkv[layer], 2e-2)
    assert compared >= 5, f"only {compared} of 25 tokens cleared the margin"


def workload():
    rng = np.random.RandomState(3)
    lengths = [70, 64, 70, 33]
    budgets = [6, 20, 1, 12]
    return [(rid, rng.randint(0, 512, size=n).astype(np.int32), b)
            for rid, (n, b) in enumerate(zip(lengths, budgets))]


def test_run_continuous_matches_reference_engine(pair):
    """Mixed-length continuous batching (2 slots, 4 requests, aligned and
    unaligned prompts): per-rid greedy tokens equal the reference Engine's
    under the margin rule; every request ends OK with its budget or EOS;
    both engines report the "xla" attend path; a solo run gives the same
    tokens bit for bit (the RWKV state splices and resets per slot)."""
    ref_eng = RefEngine(pair.ref_model, pair.ref_params,
                        RefEngineConfig(batch=2, capacity=CAP, policy=pair.ref_policy,
                                        eos_id=EOS))
    ref_sched = RefScheduler(ref_eng)
    for rid, toks, budget in workload():
        ref_sched.submit(RefRequest(rid=rid, tokens=toks, max_new_tokens=budget))
    ref = {r.rid: r for r in ref_sched.run_continuous()}
    assert ref_eng.attend_path == "xla"

    def run(batch, **options):
        eng = Engine(pair.model, pair.params,
                     EngineConfig(batch=batch, capacity=CAP, policy=pair.policy, eos_id=EOS,
                                  **options), device="cpu")
        sched = Scheduler(eng)
        for rid, toks, budget in workload():
            sched.submit(Request(rid=rid, tokens=toks, max_new_tokens=budget))
        return {r.rid: r for r in sched.run_continuous()}, sched.last_stats

    port, stats = run(2)
    assert sorted(port) == sorted(ref) == list(range(4))
    assert stats["statuses"] == {"ok": 4} and stats["attend_path"] == "xla"
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
    streaming, _ = run(2, prefill_mode="streaming")       # unbucketed: the same prefill
    for rid in port:
        np.testing.assert_array_equal(port[rid].tokens, solo[rid].tokens)
        np.testing.assert_array_equal(port[rid].tokens, streaming[rid].tokens)


def test_rwkv_state_slot_protocol_and_guard(pair):
    """splice_slot / reset_slot / tree_finite cover an RWKV layer: a splice
    writes one slot's shifts and recurrent state, a reset zeroes them, and a
    NaN in the state trips the guard."""
    caches = pair.model.init_caches(pair.policy, 2, CAP, device="cpu")
    assert all(isinstance(c, rwkv.RWKVState) for c in caches)
    prompt = np.arange(1, 41, dtype=np.int32)[None]
    _, one = pair.model.prefill(pair.params, {"tokens": prompt}, pair.policy, CAP)
    for full, o in zip(caches, one):
        cache_lib.splice_slot(full, o, 1)
    st = caches[0]
    assert torch.equal(st.wkv[1], one[0].wkv[0]) and float(st.wkv[0].abs().max()) == 0
    assert torch.equal(st.shift_tm[1], one[0].shift_tm[0])
    assert torch.equal(st.shift_cm[1], one[0].shift_cm[0])
    assert bool(cache_lib.tree_finite(caches))
    with torch.inference_mode():
        one[1].wkv[0, 0, 0, 0] = float("nan")
    assert not bool(cache_lib.tree_finite(one))
    cache_lib.reset_slot(caches[0], 1)
    for t in st.tensors().values():
        assert float(t.float().abs().max()) == 0


def test_paged_raises_and_attend_path_is_xla(pair):
    """The paged layout raises with the reference's reason, before any device
    work; a dense engine reports "xla" (no GEAR attention layer) for any
    policy, since the policy touches no RWKV layer."""
    for options in (dict(layout="paged"), dict(layout="paged", prefill_mode="streaming")):
        with pytest.raises(ValueError, match="no GEAR-compressible attention layer"):
            Engine(pair.model, pair.params,
                   EngineConfig(batch=1, capacity=CAP, policy=pair.policy, **options),
                   device="cpu")
    with pytest.raises(ValueError, match="no GEAR-compressible attention layer"):
        pair.model.init_caches(pair.policy, 1, CAP, device="cpu", layout="paged", pool_pages=4)
    for polname in ("gear_kcvt4", "gear_kivi2"):
        eng = Engine(pair.model, pair.params,
                     EngineConfig(batch=1, capacity=CAP, policy=named_policy(polname)),
                     device="cpu")
        assert eng.attend_path == "xla"
    with pytest.raises(ValueError, match="RWKV state"):
        pair.model.prefill(pair.params, {"tokens": np.ones((1, 64), np.int32)}, pair.policy,
                           CAP, prefill_mode="streaming", padded_tail=True, true_len=50)
