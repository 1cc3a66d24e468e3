"""The MoE pair of ROADMAP queue 1, item 8.7 against the JAX reference:
qwen3-moe-235b-a22b (128 experts, top-8, QK-norm) and llama4-scout-17b-a16e
(16 experts, top-1, a shared expert), and the repairs that came with them
(``smoke_config``'s MoE overrides, the random init's fan-ins).

``moe_apply`` runs on the same bf16 inputs and the reference's f32
parameters in both packages; the models run their smoke configs (2 layers,
d_model 64, 4 query heads over 2 KV heads of 16, 4 experts of width 64,
top-min(k, 2), vocab 512) on the reference's parameters
(``params_from_reference``).  The reference runs its jitted programs with
``fused="interpret"`` (the Pallas kernels in interpret mode), the port's CPU
tensors the plain kernel versions.  Policy gear_kcvt4, chunk 8, rank 2.

Tolerances, each measured on this file's inputs:

* routing (expert ids, slots, the kept mask) bit for bit, on inputs whose
  gap between each token's k-th and (k+1)-th router logit exceeds
  ``ROUTE_MARGIN`` (checked): the router's f32 products sum in another
  order in XLA, so a closer pair may pick another expert;
* ``y`` within ``MLP_ATOL`` (outputs ~1; the expert products and the k-way
  combine are bf16 sums in another order, as ``tests/test_torch_families.py``'s
  MLPs) and the aux loss within ``AUX_ATOL``;
* prefill logits within ``PREFILL_ATOL`` and the caches within
  ``STAT_RTOL`` / ``CODE_AGREE``, the bounds of
  ``tests/test_torch_families.py``;
* served runs under its teacher-forced rule with the bound ``GAP``, but at
  a position where one of the port's routing decisions lies within
  ``FLIP_MARGIN`` of a tie (a top-k to (k+1) router-logit gap): the two
  packages' layer-1 inputs differ by bf16 rounding, which moves a router
  logit by ~0.01, so such a token may take another expert in the reference
  and its logits may then differ by more (measured: 3.43 at a top-1 gap of
  0.0087, llama4, layer 1); there the token must still be the port's
  argmax, and the reference's tokens may leave the port's;
* each drawn parameter's std within ``STD_RTOL`` of the reference's draw
  (truncated at 3 sigma there, so 1.3% lower; a wrong fan-in is off by 2x
  or more at these widths).
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
from repro.configs import ALL_ARCHS  # noqa: E402
from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

MLP_ATOL = 2 ** -5       # measured 0.0156 (qwen3), 0.0156 (llama4)
AUX_ATOL = 1e-6          # measured 0 to 1.2e-7
ROUTE_MARGIN = 1e-4      # least k-th to (k+1)-th router logit gap of the routing inputs
PREFILL_ATOL = 0.0625    # measured 0.0312 (qwen3), 0.0430 (llama4)
STAT_RTOL = 2 ** -5      # measured 0.0156
CODE_AGREE = 0.95        # measured 0.97
GAP = 0.1                # measured 0.0645
FLIP_MARGIN = 0.05       # router-logit gap under which a routing choice may flip
STD_RTOL = 0.15          # measured 0.066 at worst (a [64, 4] router)
CAP = 48
EOS = 3
MOE_ARCHS = ("qwen3-moe-235b-a22b", "llama4-scout-17b-a16e")


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def small(named):
    pol = named("gear_kcvt4")
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8), rank=2,
                               rank_decode=2)


# ---------------------------------------------------------------------------
# the repairs: smoke_config and the init's fan-ins


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_smoke_config_equals_reference(arch):
    """``smoke_config`` applies the reference's overrides, the MoE ones
    (4 experts, top-min(k, 2), expert width 64) included: field for field
    the reference's, for every one of its 11 archs."""
    want = dataclasses.asdict(ref_smoke_config(arch))
    assert dataclasses.asdict(smoke_config(arch)) == want
    tfm.check_supported(ModelConfig(**want))


def ref_leaf(np_tree, cfg, name: str):
    """The reference leaf behind the port parameter ``name`` (pattern unit 1)."""
    parts = name.split(".")
    if parts[0] in ("embed", "lm_head"):
        return np_tree[parts[0]]
    if parts[0].startswith("final_norm"):
        return np_tree["final_norm"]["bias" if name.endswith("_bias") else "scale"]
    _, i, *path = parts
    stacked = np_tree["blocks"][0]
    if path[0].startswith("ln"):
        node = stacked[path[0][:3]]["bias" if path[0].endswith("_bias") else "scale"]
    elif path[0] in ("wq", "wk", "wv", "wo", "q_norm", "k_norm"):
        node = stacked["attn"][path[0]]
    elif path[0] == "moe":
        node = stacked["moe"]
        for p in path[1:]:
            node = node[p]
    else:
        node = stacked["mlp"][path[0]]
    return node[int(i)]


@pytest.mark.parametrize("arch", MOE_ARCHS + ("musicgen-medium", "rwkv6-3b"))
def test_random_init_scales_match_reference(arch):
    """``Transformer.random`` draws each matrix with the reference's fan-in:
    an MoE's ``w_up`` / ``w_gate`` [E, d, ffe] with fan_in E (the
    reference's ``dense_init`` default ``shape[0]``), its ``w_down`` with ffe,
    the router [d, E] with d, an audio model's ``embed`` [K, V, d] with d;
    every drawn parameter's std within ``STD_RTOL`` of the reference's draw
    of the same leaf, and the MoE router and audio tables in f32."""
    if arch == "rwkv6-3b":
        cfg = smoke_config(arch)
        ref_params = ref_build_model(ref_smoke_config(arch)).init(jax.random.PRNGKey(0))
        model = tfm.Transformer.random(cfg, seed=1, device="cpu")
        got = model.blocks[0].tm.mix_lora_b
        want = ref_params["blocks"][0]["tm"]["mix_lora_b"][0]
        ratio = float(got.float().std()) / float(np.std(np.asarray(want)))
        print(f"mix_lora_b std ratio {ratio:.3f}")
        assert abs(ratio - 1) <= STD_RTOL
        return
    cfg = smoke_config(arch)
    np_tree = jax.tree.map(np.asarray, ref_build_model(ref_smoke_config(arch)).init(
        jax.random.PRNGKey(0)))
    model = tfm.Transformer.random(cfg, seed=1, device="cpu")
    checked = 0
    for name, p in model.named_parameters():
        want = np.asarray(ref_leaf(np_tree, cfg, name), np.float32)
        assert tuple(p.shape) == want.shape, name
        if p.dim() < 2 or not want.std():
            continue
        ratio = float(p.float().std()) / float(want.std())
        print(f"{name}: std {float(p.float().std()):.4f}, reference {want.std():.4f}")
        assert abs(ratio - 1) <= STD_RTOL, (name, ratio)
        checked += 1
    assert checked >= 6
    if cfg.moe:
        assert model.blocks[0].moe.router.dtype == torch.float32
        assert model.blocks[0].moe.w_up.dtype == torch.bfloat16
    else:
        assert model.embed.dtype == torch.float32 and model.embed.dim() == 3


# ---------------------------------------------------------------------------
# moe_apply against the reference's


def capacity_cases():
    base = ref_smoke_config("qwen3-moe-235b-a22b")
    for E, k, cf in ((4, 2, 1.25), (128, 8, 1.25), (16, 1, 1.25), (4, 1, 8.0), (8, 3, 0.5)):
        yield dataclasses.replace(base, num_experts=E, moe_top_k=k, capacity_factor=cf)


def test_capacity_for_matches_reference_on_a_grid():
    for rcfg in capacity_cases():
        cfg = ModelConfig(**dataclasses.asdict(rcfg))
        for T in list(range(1, 70)) + [128, 859, 900, 3436, 4096]:
            assert moe.capacity_for(cfg, T) == ref_moe.capacity_for(rcfg, T), (cfg, T)
    assert moe.capacity_for(cfg, 4) == 8                     # the least capacity
    qwen = ModelConfig(**dataclasses.asdict(capacity_cases().__next__()))
    assert moe.capacity_for(dataclasses.replace(qwen, num_experts=128, moe_top_k=8), 859) == 72


def ref_routing(cfg, router, x):
    """The reference's routing of ``x``, step for step as
    ``repro.models.moe.moe_apply`` computes it (which returns only y and the
    aux loss): (logits, gates, top-k gates, expert ids, positions, kept mask,
    slots)."""
    T = x.shape[0] * x.shape[1]
    E, k = cfg.num_experts, cfg.moe_top_k
    xt = x.reshape(T, -1)
    logits = xt.astype(jnp.float32) @ router.astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    w, eidx = jax.lax.top_k(gates, k)
    w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    flat_e = eidx.reshape(T * k)
    oh = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(oh, axis=0) - 1, flat_e[:, None], axis=1)[:, 0]
    C = ref_moe.capacity_for(cfg, T)
    keep = pos < C
    slot = jnp.where(keep, flat_e * C + pos, E * C)
    return [np.asarray(a) for a in (logits, gates, w, eidx, pos, keep, slot)]


def moe_inputs(arch, case, seed=0):
    """(reference cfg, reference params, bf16 x [2, 32, d]) of one case:
    "drop" scales the router so expert 0 is every token's top-1 past its
    capacity, "nodrop" sets ``capacity_factor`` 8, "ties" zeroes the router
    but for two equal columns (1 and 3) that every token prefers."""
    rcfg = ref_smoke_config(arch)
    if case == "nodrop":
        rcfg = dataclasses.replace(rcfg, capacity_factor=8.0)
    d = rcfg.d_model
    params = jax.tree.map(np.asarray, ref_moe.moe_params(rcfg, ref_common_keygen(seed)))
    # the experts at 0.3x their init scale: outputs of magnitude ~1, as in
    # test_torch_families' MLP test (at 1x they reach ~50, where one bf16 ulp is 0.25)
    params = {k: (v if k == "router" else jax.tree.map(lambda a: a * 0.3, v))
              for k, v in params.items()}
    rng = np.random.RandomState(seed + 1)
    x = rng.randn(2, 32, d).astype(np.float32)
    if case == "drop":
        x[..., 0] = 1.0
        params["router"] = params["router"].copy()
        params["router"][0, 0] = 20.0
    elif case == "ties":
        params["router"] = np.zeros_like(params["router"])
        x[..., 0] = 1.0
        params["router"][0, 1] = params["router"][0, 3] = 5.0
    return rcfg, params, jnp.asarray(x).astype(jnp.bfloat16)


def ref_common_keygen(seed):
    from repro.models.common import KeyGen

    return KeyGen(jax.random.PRNGKey(seed))


def port_layer(rcfg, params):
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    layer = moe.MoE(cfg, "cpu", torch.bfloat16)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            node = params
            for part in name.split("."):
                node = node[part]
            p.copy_(torch.from_numpy(np.array(node, np.float32)).to(p.dtype))
    return cfg, layer


@pytest.mark.parametrize("case", ["drop", "nodrop", "ties"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_matches_reference(arch, case):
    """Routing bit for bit (expert ids, positions, slots, the kept mask),
    then ``y`` within ``MLP_ATOL`` and the aux loss within ``AUX_ATOL``.  In
    "drop" expert 0 overflows and its pairs past the capacity are dropped,
    token-major; "nodrop" keeps every pair; in "ties" two equal gates go to
    the lower expert id, as ``jax.lax.top_k``."""
    rcfg, params, x = moe_inputs(arch, case)
    cfg, layer = port_layer(rcfg, params)
    xp = torch.from_numpy(to_np(x)).to(torch.bfloat16)
    logits, _, w, eidx, pos, keep, slot = ref_routing(rcfg, jnp.asarray(params["router"]), x)
    r = moe.route(cfg, layer.router, xp.reshape(-1, cfg.d_model))
    top = np.sort(logits, axis=-1)[:, ::-1]
    k = cfg.moe_top_k
    margin = (top[:, k - 1] - top[:, k]).min() if case != "ties" else np.inf
    print(f"{arch} {case}: least top-k margin {margin:.3g}, capacity {r.capacity}, "
          f"dropped {int((~r.keep).sum())} of {r.keep.numel()} pairs")
    assert margin > ROUTE_MARGIN
    np.testing.assert_array_equal(r.experts.numpy(), eidx)
    np.testing.assert_array_equal(r.pos.numpy(), pos)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_allclose(r.weights.numpy(), w, rtol=0, atol=1e-6)
    if case == "drop":
        assert (eidx[:, 0] == 0).all() and (~keep).sum() > 0
        # token-major: expert 0's first `capacity` tokens keep their slot
        first = np.flatnonzero(eidx.reshape(-1) == 0)
        assert keep[first[:r.capacity]].all() and not keep[first[r.capacity:]].any()
    elif case == "nodrop":
        assert keep.all()
    else:
        assert (eidx[:, 0] == 1).all() and (k == 1 or (eidx[:, 1] == 3).all())
    y_ref, aux_ref = ref_moe.moe_apply(rcfg, params, x)
    y, aux = moe.moe_apply(cfg, layer, xp)
    err = np.abs(to_np(y) - to_np(y_ref)).max()
    print(f"  |y - y_ref| {err:.4g}, |aux - aux_ref| {abs(float(aux) - float(aux_ref)):.3g}")
    assert y.dtype == torch.bfloat16 and y.shape == tuple(x.shape)
    assert err <= MLP_ATOL
    assert abs(float(aux) - float(aux_ref)) <= AUX_ATOL


def test_routing_ties_need_the_stable_sort():
    """Where every gate ties (a zero router), the top-k are experts 0..k-1 in
    that order in both packages: ``torch.topk`` promises no order for equal
    values, the stable descending sort does."""
    rcfg = dataclasses.replace(ref_smoke_config("qwen3-moe-235b-a22b"), num_experts=16,
                               moe_top_k=5)
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    x = jnp.asarray(np.random.RandomState(2).randn(1, 40, cfg.d_model).astype(np.float32))
    router = np.zeros((cfg.d_model, 16), np.float32)
    eidx = ref_routing(rcfg, jnp.asarray(router), x)[3]
    r = moe.route(cfg, torch.from_numpy(router), torch.from_numpy(np.array(x)).reshape(40, -1))
    np.testing.assert_array_equal(eidx, np.tile(np.arange(5), (40, 1)))
    np.testing.assert_array_equal(r.experts.numpy(), eidx)


# ---------------------------------------------------------------------------
# the models: parameters, prefill, served runs


class Pair:
    """Both packages' smoke model of one MoE arch on the reference's
    parameters, and the reference's jitted batch-1 programs per mode."""

    def __init__(self, arch):
        self.ref_cfg = ref_smoke_config(arch)
        self.cfg = smoke_config(arch)
        self.ref_model = ref_build_model(self.ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.ref_params)
        self.model = build_model(self.cfg)
        self.params = params_from_reference(self.np_params, self.cfg, device="cpu")
        self._jit: dict = {}

    def ref_fns(self, mode="monolithic"):
        """(prefill, decode), jitted."""
        if mode not in self._jit:
            m, pol = self.ref_model, small(jnamed)
            self._jit[mode] = (
                jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP, prefill_mode=mode,
                                               fused="interpret")),
                jax.jit(lambda p, t, c, pos: m.decode_step(p, {"tokens": t}, c, pos, pol, CAP,
                                                           fused="interpret")))
        return self._jit[mode]

    def requests(self, mod):
        rng = np.random.RandomState(0)
        return [mod.Request(rid=i, tokens=rng.randint(4, 512, size=n), max_new_tokens=b)
                for i, (n, b) in enumerate(zip([13, 21, 13], [8, 5, 6]))]

    def along(self, prompt, tokens):
        """(reference, port) logits [T, V] along ``tokens`` at batch 1
        (monolithic prefill), and per position the least top-k to (k+1)
        router-logit gap of the port's routing there (over every layer, and
        every prompt row for the prefill)."""
        ppol = small(named_policy)
        k = self.cfg.moe_top_k
        least = [np.inf]                       # per position, filled as the port routes
        real = moe.route

        def spy(cfg, router, xt):
            top = torch.sort(xt.float() @ router.float(), dim=-1, descending=True).values
            least[-1] = min(least[-1], float((top[:, k - 1] - top[:, k]).min()))
            return real(cfg, router, xt)

        prefill, decode = self.ref_fns()
        moe.route = spy
        try:
            logits, caches = prefill(self.ref_params, jnp.asarray(prompt[None]))
            plogits, pcaches = self.model.prefill(self.params, {"tokens": prompt[None]}, ppol,
                                                  CAP)
            ref, port = [], []
            for i, tok in enumerate(tokens):
                ref.append(np.asarray(logits[0, -1].astype(jnp.float32)))
                port.append(plogits[0, -1].float().numpy())
                if i + 1 < len(tokens):
                    pos = len(prompt) + i
                    least.append(np.inf)
                    logits, caches = decode(self.ref_params, jnp.asarray([[tok]], jnp.int32),
                                            caches, jnp.asarray([pos], jnp.int32))
                    plogits, pcaches = self.model.decode_step(
                        self.params, {"tokens": np.array([[tok]])}, pcaches, np.array([pos]),
                        ppol, CAP)
        finally:
            moe.route = real
        return np.stack(ref), np.stack(port), np.array(least)


_PAIRS: dict = {}


def get_pair(arch) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


@pytest.fixture(params=MOE_ARCHS)
def pair(request):
    return get_pair(request.param)


def test_params_from_reference_round_trips_every_parameter(pair):
    """Every port parameter equals its reference leaf: the router in f32,
    the experts' and the shared expert's matrices in bf16; every reference
    leaf lands in a port parameter, and an MoE block holds no MLP."""
    names = dict(pair.params.named_parameters())
    for name, p in names.items():
        want = np.array(ref_leaf(pair.np_params, pair.cfg, name), np.float32)
        np.testing.assert_array_equal(
            p.detach().float().numpy(), torch.from_numpy(want).to(p.dtype).float().numpy(),
            err_msg=name)
    ref_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(pair.np_params))
    assert sum(p.numel() for p in names.values()) == ref_count
    blk = pair.params.blocks[0]
    assert blk.w_up is None and blk.moe.router.dtype == torch.float32
    assert (blk.moe.shared is not None) == pair.cfg.shared_expert
    assert (blk.q_norm is not None) == pair.cfg.qk_norm


def codes(words: np.ndarray, bits: int) -> np.ndarray:
    w = words.astype(np.int64) & 0xFFFFFFFF
    return np.stack([(w >> (bits * j)) & ((1 << bits) - 1) for j in range(32 // bits)], -1)


@pytest.mark.parametrize("arch, mode", [("qwen3-moe-235b-a22b", "monolithic"),
                                        ("qwen3-moe-235b-a22b", "streaming"),
                                        ("llama4-scout-17b-a16e", "monolithic")])
def test_prefill_matches_reference(arch, mode):
    """Last-position logits and every layer cache of a 29-token prompt (3
    closed chunks and a partial buffer) against the reference's jitted
    prefill in interpret mode (llama4's streaming prefill: against the
    dense engine in the last test)."""
    pair = get_pair(arch)
    prompt = np.random.RandomState(6).randint(4, 512, size=29).astype(np.int32)
    prefill = pair.ref_fns(mode)[0]
    logits, caches = prefill(pair.ref_params, jnp.asarray(prompt[None]))
    plogits, pcaches = pair.model.prefill(pair.params, {"tokens": prompt[None]},
                                          small(named_policy), CAP, prefill_mode=mode)
    gap = np.abs(to_np(plogits) - to_np(logits)).max()
    print(f"{pair.cfg.name} {mode}: prefill logit gap {gap:.4g}")
    assert gap <= PREFILL_ATOL
    (stacked,) = caches
    for r, pc in enumerate(pcaches):
        jc = jax.tree.map(lambda x, r=r: x[r], stacked)
        np.testing.assert_array_equal(to_np(pc.length), np.asarray(jc.length).reshape(-1))
        for name in ("k_scale", "k_zero", "v_scale", "v_zero", "buf_k", "buf_v"):
            a, b = to_np(getattr(pc, name)), to_np(getattr(jc, name))
            rel = np.abs(a - b.reshape(a.shape)).max() / max(np.abs(b).max(), 1e-6)
            assert rel <= STAT_RTOL, (r, name, rel)
        for name in ("k_packed", "v_packed"):
            a, b = (codes(to_np(x), 4) for x in (getattr(pc, name), getattr(jc, name)))
            agree = np.mean(a == b.reshape(a.shape))
            print(f"  layer {r} {name}: {agree:.4f} of codes equal")
            assert agree >= CODE_AGREE, (r, name)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_run_continuous_matches_reference_engine(arch):
    """Two slots, three requests, monolithic prefill, dense layout, chunk
    closes in prefill and decode: the port's engine against the reference's
    under the teacher-forced rule.  Every decode step routes at T = 2 (the
    idle slot's row counts, as in the reference), each prefill at the
    prompt's length.  (Streaming prefill against the reference: the prefill
    test; streaming + paged against dense: the next test.)"""
    pair = get_pair(arch)
    got = {}
    for name, mod, model, params, named, extra in (
            ("ref", R, pair.ref_model, pair.ref_params, jnamed, {}),
            ("port", P, pair.model, pair.params, named_policy, {"device": "cpu"})):
        eng = mod.Engine(model, params, mod.EngineConfig(
            batch=2, capacity=CAP, policy=small(named), eos_id=EOS), **extra)
        sched = mod.Scheduler(eng)
        for r in pair.requests(mod):
            sched.submit(r)
        got[name] = sched.run_continuous()
    ref, port = got["ref"], got["port"]
    assert [(r.rid, str(r.status)) for r in port] == [(r.rid, str(r.status)) for r in ref]
    prompts = {r.rid: r.tokens for r in pair.requests(P)}
    want = {r.rid: np.asarray(r.tokens) for r in ref}
    for r in port:
        toks = np.asarray(r.tokens)
        rlog, plog, least = pair.along(prompts[r.rid].astype(np.int32), toks)
        gaps = np.abs(rlog - plog).max(-1)
        near = least <= FLIP_MARGIN            # a routing choice within rounding of a tie
        print(f"{pair.cfg.name} rid {r.rid}: largest gap {gaps[~near].max():.4f}; "
              f"near-tie positions {np.flatnonzero(near).tolist()} (gaps {gaps[near]})")
        assert (gaps[~near] <= GAP).all(), (r.rid, gaps, least)
        np.testing.assert_array_equal(toks, plog.argmax(-1))
        m = min(len(toks), len(want[r.rid]))
        diff = np.flatnonzero(toks[:m] != want[r.rid][:m])
        if diff.size and not near[diff[0]]:    # only where rounding can explain it
            top2 = np.sort(rlog[diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[diff[0]], (r.rid, toks, want[r.rid])
        elif not diff.size:
            np.testing.assert_array_equal(toks, want[r.rid])


def test_streaming_paged_equals_dense_tokens_bit_for_bit():
    """llama4-scout with streaming prefill: the paged engine's greedy tokens
    and statuses equal a dense engine's, bit for bit (chip_smoke's path 22
    on the card), with a pool small enough that a request waits for pages."""
    pair = get_pair("llama4-scout-17b-a16e")
    out, stats = {}, {}
    for layout, extra in (("dense", {}), ("paged", {"pool_pages": 8})):
        eng = P.Engine(pair.model, pair.params, P.EngineConfig(
            batch=2, capacity=CAP, policy=small(named_policy), prefill_mode="streaming",
            layout=layout, **extra), device="cpu")
        sched = P.Scheduler(eng)
        for r in pair.requests(P):
            sched.submit(r)
        out[layout] = {r.rid: (str(r.status), np.asarray(r.tokens))
                       for r in sched.run_continuous()}
        stats[layout] = sched.last_stats
    assert stats["paged"]["waited_for_pages"] >= 1
    assert out["paged"].keys() == out["dense"].keys()
    for rid, (status, toks) in out["dense"].items():
        assert out["paged"][rid][0] == status == "ok"
        np.testing.assert_array_equal(out["paged"][rid][1], toks)
