"""gemma3-12b (ROADMAP queue 1, item 8.4) against the JAX reference: a 5:1
local:global stack with QK-norm, a RoPE base per layer kind (10,000 on
local layers, ``rope_theta`` on global ones) and sliding-window ring caches
on the local layers, in mixed cache trees (window rings beside GEAR caches,
dense, or beside a paged pool of the global layers).

Both packages run gemma3's smoke config (12 layers: two units of 5 local +
1 global, d_model 64, 4 query heads over 2 KV heads of 16, vocab 512) with
``local_window`` cut to 16, below the tests' prompts, the same way on both,
so every ring wraps in prefill and again in decode; the policies' chunk is
8 and their ranks 2.  The port runs on the reference's own random
parameters (``params_from_reference``); the reference runs as its tests do
on the CPU (its jitted programs with ``fused="interpret"``: the Pallas
kernels in interpret mode), the port's CPU tensors take the plain kernel
versions.

Tolerances, each measured on this file's inputs:

* parameters: every one equal to the reference's, QK-norm scales included;
* q / k / v of one layer of each kind (QK-norm, the kind's RoPE) within
  ``QKV_ULPS`` bf16 ulps of the reference's on the same input;
* prefill logits within ``PREFILL_ATOL``; every window ring's ``pos`` and
  ``length`` bit for bit and its K / V within ``STAT_RTOL`` of its largest
  entry; the global layers' GEAR stats and buffers within ``STAT_RTOL`` and
  at least ``CODE_AGREE`` of their codes equal (layer inputs differ by bf16
  rounding from the first layer on: gemma's scaled embedding, ROADMAP
  section 3, standing differences g and i);
* served runs (monolithic + dense, streaming + paged) under the
  teacher-forced rule of ``tests/test_torch_families.py``: statuses equal,
  every port token its own argmax, every logit gap within ``GAP``, a token
  may leave the reference's only where the reference's top-2 margin is
  within twice the gap; along the way every ring's ``pos`` bit for bit and
  every layer's ``length`` equal to the first layer's (the host lengths
  the decode step reads from a window ring);
* paged against dense bit for bit; streaming against monolithic bit for
  bit in every cache up to the first global layer (the layers after it see
  the streaming attention's output, which sums in another order).
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
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import cache as cache_lib  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

QKV_ULPS = 0             # measured 0: bit for bit
PREFILL_ATOL = 0.0625    # measured 0.031
STAT_RTOL = 2 ** -5      # measured 0.023
# least share of equal codes in the first / second global layer (layers 5 and
# 11): inputs one bf16 ulp apart move more codes the deeper the layer
# (measured 0.962 / 0.930)
CODE_AGREE = {5: 0.95, 11: 0.9}
# teacher-forced logit gap of every served token, before and after a decode
# close: the smoke widths' bound of tests/test_torch_wave.py (measured 0.119
# over 12 layers; 0.065 over the 2 of tests/test_torch_families.py)
GAP = 0.25
WINDOW = 16
CAP = 48
EOS = 3
POLICY = "gear_kcvt4"
LOCAL, GLOBAL = 0, 5     # a local and a global layer of the first unit


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def small(named):
    pol = named(POLICY)
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8),
                               rank=min(pol.rank, 2), rank_decode=min(pol.rank_decode, 2))


class Pair:
    """Both packages' gemma3 smoke model on the reference's parameters, and
    the reference's jitted batch-1 programs (made once per prefill mode)."""

    def __init__(self):
        self.ref_cfg = dataclasses.replace(ref_smoke_config("gemma3-12b"), local_window=WINDOW)
        self.cfg = dataclasses.replace(smoke_config("gemma3-12b"), local_window=WINDOW)
        self.ref_model = ref_build_model(self.ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.ref_params)
        self.model = build_model(self.cfg)
        self.params = params_from_reference(self.np_params, self.cfg, device="cpu")
        self._jit: dict = {}

    def ref_fns(self, mode="monolithic"):
        if mode not in self._jit:
            m, pol = self.ref_model, small(jnamed)
            self._jit[mode] = (
                jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP, prefill_mode=mode,
                                               fused="interpret")),
                jax.jit(lambda p, t, c, pos: m.decode_step(p, {"tokens": t}, c, pos, pol, CAP,
                                                           fused="interpret")))
        return self._jit[mode]

    def ref_layers(self, caches) -> list:
        """The reference's per-position caches stacked over repeats, as one
        cache per layer (layer ``r * 6 + p`` is repeat r of position p)."""
        unit = len(self.cfg.layer_pattern)
        return [jax.tree.map(lambda x, i=i: x[i // unit], caches[i % unit])
                for i in range(self.cfg.num_layers)]

    def requests(self, mod, seed=0):
        """Four requests of two prompt lengths past the window; the budgets
        close a chunk during decode and wrap the rings again."""
        rng = np.random.RandomState(seed)
        return [mod.Request(rid=i, tokens=rng.randint(4, 512, size=n), max_new_tokens=b)
                for i, (n, b) in enumerate(zip([21, 29, 21, 29], [12, 6, 9, 11]))]

    def along(self, prompt, tokens, mode):
        """(reference, port) logits [T, V] at each of ``tokens``,
        teacher-forced at batch 1 through both packages.  After every step,
        every ring's ``pos`` must equal the reference's and every layer's
        ``length`` the first layer's."""
        ppol = small(named_policy)
        prefill, decode = self.ref_fns(mode)
        logits, caches = prefill(self.ref_params, jnp.asarray(prompt[None]))
        plogits, pcaches = self.model.prefill(self.params, {"tokens": prompt[None]}, ppol, CAP,
                                              prefill_mode=mode)
        ref, port = [], []
        for i, tok in enumerate(tokens):
            check_rings(self, pcaches, caches, len(prompt) + i)
            ref.append(np.asarray(logits[0, -1].astype(jnp.float32)))
            port.append(plogits[0, -1].float().numpy())
            if i + 1 < len(tokens):
                pos = len(prompt) + i
                logits, caches = decode(self.ref_params, jnp.asarray([[tok]], jnp.int32),
                                        caches, jnp.asarray([pos], jnp.int32))
                plogits, pcaches = self.model.decode_step(
                    self.params, {"tokens": np.array([[tok]])}, pcaches, np.array([pos]), ppol,
                    CAP)
        return np.stack(ref), np.stack(port)


def check_rings(pair, pcaches, ref_caches, n: int, kv_rtol: float | None = None) -> None:
    """Every layer's ``length`` is ``n``; every window ring's ``pos`` equals
    the reference's bit for bit (and, with ``kv_rtol``, its K / V within
    that share of the largest entry)."""
    for i, (pc, jc) in enumerate(zip(pcaches, pair.ref_layers(ref_caches), strict=True)):
        np.testing.assert_array_equal(to_np(pc.length), [n], err_msg=f"layer {i}")
        if not isinstance(pc, cache_lib.WindowLayerCache):
            continue
        np.testing.assert_array_equal(to_np(pc.pos), np.asarray(jc.pos), err_msg=f"layer {i}")
        if kv_rtol is not None:
            for name in ("k", "v"):
                a, b = to_np(getattr(pc, name)), to_np(getattr(jc, name))
                rel = np.abs(a - b).max() / np.abs(b).max()
                print(f"  ring {i} {name}: {rel:.3g} of the largest entry")
                assert rel <= kv_rtol, (i, name)


_PAIR: list = []


@pytest.fixture
def pair():
    if not _PAIR:
        _PAIR.append(Pair())
    return _PAIR[0]


def test_params_from_reference_round_trips_every_parameter(pair):
    """Every reference leaf lands in a port parameter of equal value, the
    QK-norm scales (f32 [Dh]) included, in the 5 local + 1 global order."""
    ref_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(pair.np_params))
    assert sum(p.numel() for p in pair.params.parameters()) == ref_count
    unit = len(pair.cfg.layer_pattern)
    assert tfm.layer_kinds(pair.cfg) == ["local"] * 5 + ["global"] + ["local"] * 5 + ["global"]
    for i, blk in enumerate(pair.params.blocks):
        attn_p = pair.np_params["blocks"][i % unit]["attn"]
        for name in ("q_norm", "k_norm", "wq", "wo"):
            got = getattr(blk, name)
            want = torch.from_numpy(np.array(attn_p[name][i // unit], np.float32))
            np.testing.assert_array_equal(to_np(got), to_np(want.to(got.dtype)))
        assert blk.q_norm.dtype == torch.float32 and blk.q_norm.shape == (pair.cfg.head_dim,)


@pytest.mark.parametrize("layer", [LOCAL, GLOBAL], ids=["local", "global"])
def test_qk_norm_and_rope_per_kind_match_reference(pair, layer):
    """q, k and v of one layer of each kind, with QK-norm scales set away
    from zero, against the reference's ``_project_qkv``: the local layer
    rotates with base 10,000, the global one with ``rope_theta`` 1e6."""
    kind = tfm.layer_kinds(pair.cfg)[layer]
    assert attn.rope_theta_for(pair.cfg, kind) == ref_attn.rope_theta_for(pair.ref_cfg, kind)
    assert attn.rope_theta_for(pair.cfg, kind) == (1e4 if kind == "local" else 1e6)
    rng = np.random.RandomState(2)
    unit = len(pair.cfg.layer_pattern)
    ref_p = jax.tree.map(lambda a: np.array(a[layer // unit]),
                         pair.np_params["blocks"][layer % unit]["attn"])
    ref_p["q_norm"] = rng.randn(pair.cfg.head_dim).astype(np.float32) * 0.3
    ref_p["k_norm"] = rng.randn(pair.cfg.head_dim).astype(np.float32) * 0.3
    blk = pair.params.blocks[layer]
    x = jnp.asarray(rng.randn(2, 37, pair.cfg.d_model).astype(np.float32)).astype(jnp.bfloat16)
    positions = np.arange(100, 137, dtype=np.int32)
    want = ref_attn._project_qkv(pair.ref_cfg, {k: jnp.asarray(v) for k, v in ref_p.items()},
                                 x, jnp.asarray(positions), kind)
    saved = blk.q_norm.clone(), blk.k_norm.clone()
    try:
        with torch.no_grad():
            blk.q_norm.copy_(torch.from_numpy(ref_p["q_norm"]))
            blk.k_norm.copy_(torch.from_numpy(ref_p["k_norm"]))
        rope = tfm._rope_by_kind(pair.cfg, torch.from_numpy(positions))[kind]
        got = attn._project_qkv(pair.cfg, blk, torch.from_numpy(to_np(x)).to(torch.bfloat16),
                                rope)
    finally:
        with torch.no_grad():
            blk.q_norm.copy_(saved[0])
            blk.k_norm.copy_(saved[1])
    for name, g, w in zip("qkv", got, want):
        g, w = to_np(g), to_np(w)
        off = np.abs(g - w) / bf16_ulp(w)
        print(f"{kind} {name}: {np.mean(off > 0):.3%} of entries off, at most {off.max()} ulp")
        assert off.max() <= QKV_ULPS, name
    # the rotation is the kind's: the other kind's base gives other q
    other = tfm._rope_by_kind(dataclasses.replace(pair.cfg, attn_pattern="global"),
                              torch.from_numpy(positions))["global"]
    if kind == "local":
        assert not torch.equal(other[0], rope[0])


def codes(words: np.ndarray, bits: int) -> np.ndarray:
    w = words.astype(np.int64) & 0xFFFFFFFF
    return np.stack([(w >> (bits * j)) & ((1 << bits) - 1) for j in range(32 // bits)], -1)


@pytest.mark.parametrize("mode", ["monolithic", "streaming"])
def test_prefill_matches_reference(pair, mode):
    """A 29-token prompt (the 16-token window wraps; 3 closed chunks and a
    partial buffer on the global layers): logits, every ring bit for bit in
    ``pos`` and ``length``, K / V and the GEAR layers' stats and codes within
    the stated bounds."""
    prompt = np.random.RandomState(6).randint(4, 512, size=29).astype(np.int32)
    prefill, _ = pair.ref_fns(mode)
    logits, caches = prefill(pair.ref_params, jnp.asarray(prompt[None]))
    plogits, pcaches = pair.model.prefill(pair.params, {"tokens": prompt[None]},
                                          small(named_policy), CAP, prefill_mode=mode)
    gap = np.abs(to_np(plogits) - to_np(logits)).max()
    print(f"gemma3 {mode}: prefill logit gap {gap:.4g}")
    assert gap <= PREFILL_ATOL
    check_rings(pair, pcaches, caches, 29, kv_rtol=STAT_RTOL)
    ring = pcaches[LOCAL]
    assert ring.k.shape[2] == WINDOW and sorted(to_np(ring.pos)[0].tolist()) == list(range(13, 29))
    for i, (pc, jc) in enumerate(zip(pcaches, pair.ref_layers(caches))):
        if isinstance(pc, cache_lib.WindowLayerCache):
            continue
        for name in ("k_scale", "k_zero", "v_scale", "v_zero", "buf_k", "buf_v"):
            a, b = to_np(getattr(pc, name)), to_np(getattr(jc, name))
            rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-6)
            print(f"  layer {i} {name}: {rel:.3g} of the largest entry")
            assert rel <= STAT_RTOL, (i, name)
        for name in ("k_packed", "v_packed"):
            a, b = (codes(to_np(x), 4) for x in (getattr(pc, name), getattr(jc, name)))
            agree = np.mean(a == b)
            print(f"  layer {i} {name}: {agree:.4f} of codes equal")
            assert agree >= CODE_AGREE[i], (i, name)


def test_streaming_prefill_falls_back_per_layer(pair, monkeypatch):
    """Under ``prefill_mode="streaming"`` each local layer takes the
    monolithic prefill with its window (``flash_prefill``, window 16) inside
    the same forward, each global layer the streaming pipeline (no
    ``flash_prefill``); the caches up to the first global layer equal the
    monolithic prefill's bit for bit, and a padded tail raises, naming the
    local kind."""
    calls = []
    real = ops.flash_attention

    def spy(*args, **kwargs):
        calls.append(kwargs.get("window", 0))
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "flash_attention", spy)
    prompt = np.random.RandomState(7).randint(4, 512, size=(1, 27)).astype(np.int32)
    pol = small(named_policy)
    out = {}
    for mode in ("monolithic", "streaming"):
        calls.clear()
        out[mode] = pair.model.prefill(pair.params, {"tokens": prompt}, pol, CAP,
                                       prefill_mode=mode)
        out[mode + "_calls"] = list(calls)
    assert out["monolithic_calls"] == ([WINDOW] * 5 + [0]) * 2
    assert out["streaming_calls"] == [WINDOW] * 10
    for a, b in zip(out["streaming"][1], out["monolithic"][1], strict=True):
        assert type(a) is type(b)
    for a, b in zip(out["streaming"][1][:GLOBAL + 1], out["monolithic"][1][:GLOBAL + 1]):
        for name, t in a.tensors().items():
            assert torch.equal(t, getattr(b, name)), name
    with pytest.raises(ValueError, match="kind='local'"):
        pair.model.prefill(pair.params, {"tokens": np.zeros((1, 32), np.int32)}, pol, CAP,
                           prefill_mode="streaming", padded_tail=True, true_len=27)


def test_prefix_cache_reason_matches_reference(pair):
    """The prefix cache (and with it bucketing) is off for gemma3, for the
    reference's reason: a local layer cannot take the streaming pipeline."""
    msgs = []
    for mod, model, params, named, extra in (
            (R, pair.ref_model, pair.ref_params, jnamed, {}),
            (P, pair.model, pair.params, named_policy, {"device": "cpu"})):
        with pytest.raises(ValueError) as e:
            mod.Engine(model, params, mod.EngineConfig(
                batch=2, capacity=CAP, policy=small(named), prefill_mode="streaming",
                prefix_cache=True), **extra)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "layer kind 'local'" in msgs[1]
    eng = P.Engine(pair.model, pair.params, P.EngineConfig(
        batch=2, capacity=CAP, policy=small(named_policy), prefill_mode="streaming"),
        device="cpu")
    assert not eng._can_bucket and eng.attend_path == "fused"


SERVING = {"monolithic-dense": {}, "streaming-paged": dict(prefill_mode="streaming",
                                                            layout="paged")}


@pytest.mark.parametrize("case", list(SERVING))
def test_run_continuous_matches_reference_engine(pair, case):
    """Two slots, four requests, rings that wrap, chunk closes in prefill and
    decode: the port's engine against the reference's under the
    teacher-forced rule.  On the paged layout only the two global layers are
    pooled and the ten rings stay dense, as in the reference."""
    over = SERVING[case]
    got, engines = {}, {}
    for name, mod, model, params, named, extra in (
            ("ref", R, pair.ref_model, pair.ref_params, jnamed, {}),
            ("port", P, pair.model, pair.params, named_policy, {"device": "cpu"})):
        eng = mod.Engine(model, params, mod.EngineConfig(
            batch=2, capacity=CAP, policy=small(named), eos_id=EOS, **over), **extra)
        sched = mod.Scheduler(eng)
        for r in pair.requests(mod):
            sched.submit(r)
        got[name] = sched.run_continuous()
        engines[name] = eng
        assert sched.last_stats["attend_path"] == "fused"
    if "layout" in over:
        eng = engines["port"]
        assert eng._pooled == [False] * 5 + [True] + [False] * 5 + [True]
        assert eng.pool.page_bytes == engines["ref"].pool.page_bytes
        caches = eng.init_caches()
        assert [type(c).__name__ for c in caches[:6]] == (["WindowLayerCache"] * 5
                                                          + ["PagedGEARLayerCache"])
    ref, port = got["ref"], got["port"]
    assert [(r.rid, str(r.status)) for r in port] == [(r.rid, str(r.status)) for r in ref]
    prompts = {r.rid: r.tokens for r in pair.requests(P)}
    want = {r.rid: np.asarray(r.tokens) for r in ref}
    mode = over.get("prefill_mode", "monolithic")
    for r in port:
        toks = np.asarray(r.tokens)
        rlog, plog = pair.along(prompts[r.rid], toks, mode)
        gaps = np.abs(rlog - plog).max(-1)
        print(f"gemma3 {case} rid {r.rid}: largest gap {gaps.max():.4f}")
        assert (gaps <= GAP).all(), (r.rid, gaps)
        np.testing.assert_array_equal(toks, plog.argmax(-1))
        m = min(len(toks), len(want[r.rid]))
        diff = np.flatnonzero(toks[:m] != want[r.rid][:m])
        if diff.size:
            top2 = np.sort(rlog[diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[diff[0]], (r.rid, toks, want[r.rid])
        else:
            np.testing.assert_array_equal(toks, want[r.rid])


def test_paged_equals_dense_bit_for_bit(pair):
    """Streaming prefill on both layouts, the same requests: every token and
    every step's logits equal; the slots' rings splice and reset through the
    slot protocol (``pos`` back to -1), and every layer's ``length`` moves
    with the first layer's."""
    out = {}
    for layout in ("dense", "paged"):
        eng = P.Engine(pair.model, pair.params, P.EngineConfig(
            batch=2, capacity=CAP, policy=small(named_policy), prefill_mode="streaming",
            layout=layout), device="cpu")
        view = eng.new_view()
        reqs = pair.requests(P)
        rows = [view.prefill_slot({"tokens": r.tokens[None]}, s,
                                  reserve_tokens=len(r.tokens) + 12) for s, r in enumerate(reqs[:2])]
        pos = np.array([len(r.tokens) for r in reqs[:2]], np.int32)
        tok = np.array([[int(x[0, -1].argmax())] for x in rows], np.int32)
        for _ in range(10):
            logits = view.decode({"tokens": tok}, pos)
            rows.append(logits)
            lengths = {tuple(to_np(c.length)) for c in view.caches}
            assert lengths == {tuple(pos + 1)}
            pos = pos + 1
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32).numpy()
        view.reset_slot(0)
        ring = view.caches[LOCAL]
        assert (to_np(ring.pos)[0] == -1).all() and (to_np(ring.pos)[1] >= 0).all()
        assert int(ring.length[0]) == 0 and int(view.caches[GLOBAL].length[0]) == 0
        out[layout] = rows
    for a, b in zip(out["dense"], out["paged"], strict=True):
        assert torch.equal(a, b)
