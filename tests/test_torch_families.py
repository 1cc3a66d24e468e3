"""The dense families of ROADMAP queue 1, items 8.1-8.3 against the JAX
reference: minicpm-2b (RMSNorm + SwiGLU, head_dim 64 at full width),
starcoder2-3b (LayerNorm with bias + the non-gated GELU MLP, GQA) and
gemma-2b (RMSNorm + GeGLU, MQA, a sqrt(d_model)-scaled tied embedding).

Each runs at a tiny width (2 layers, d_model 32, head_dim 16, vocab 64)
with its family's head layout, on the reference's own random parameters
moved across with ``params_from_reference``; starcoder2 also at its
published 24 query heads over 2 KV heads (G = 12, the decode regime's
16-row build on the card).  The reference runs as its tests do on the CPU
(its jitted prefill with ``fused="interpret"``: the Pallas kernels in
interpret mode); the port's CPU tensors take the plain kernel versions.

Tolerances, each measured on this file's inputs:

* parameters: every one equal to the reference's (bf16 matrices, f32 norms);
* the embedding: equal, except gemma's scaled one within ``EMBED_ULPS`` (1)
  bf16 ulp: the reference scales its f32 table and rounds once, the port
  scales its bf16 copy of that table (ROADMAP section 3, standing
  difference i);
* ``gelu_tanh`` within ``GELU_ULPS`` (1) bf16 ulp of ``jax.nn.gelu(approximate
  =True)``, and each MLP kind within ``MLP_ATOL`` (outputs of magnitude
  ~1): XLA may keep a fused chain's intermediates in f32 where the port
  rounds each bf16 step (standing difference j);
* prefill logits within ``PREFILL_ATOL`` and the caches' lengths equal,
  their stats and buffers within ``STAT_RTOL`` of their largest entry and at
  least ``CODE_AGREE`` of their codes equal: layer 0's agree exactly but for
  gemma's (its scaled embedding), layer 1's inputs differ by bf16 rounding
  (ROADMAP section 3, standing difference g), which moves a few codes;
* a served run (monolithic + dense, and streaming + paged) under the
  teacher-forced rule of ``tests/test_torch_attend.py``: statuses equal,
  every port token its own argmax, every logit gap within ``GAP`` (before
  and after a decode close), and a token may leave the reference's only
  where the reference's top-2 margin is within twice the gap.
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
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import mlp as ref_mlp  # noqa: E402
from repro.models import transformer as ref_tfm  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models import common, mlp  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

EMBED_ULPS = 1
GELU_ULPS = 1
MLP_ATOL = 2 ** -5       # measured 0.0078 (swiglu), 0.0039 (geglu), 0 (gelu_mlp)
PREFILL_ATOL = 0.0625   # measured 0.043
STAT_RTOL = 2 ** -5      # measured 0.025 (buf_k, layer 1)
CODE_AGREE = 0.95       # measured 0.9635 (k_packed, layer 1)
GAP = 0.1                # measured 0.0645, before and after a decode close
EOS = 3
CAP = 48
SMALL = dict(num_layers=2, d_model=32, head_dim=16, d_ff=64, vocab_size=64, max_seq_len=512)
FAMILIES = {                         # id: (arch, query heads, KV heads)
    "minicpm-2b": ("minicpm-2b", 2, 2),
    "starcoder2-3b": ("starcoder2-3b", 4, 2),
    "starcoder2-3b-g12": ("starcoder2-3b", 24, 2),
    "gemma-2b": ("gemma-2b", 2, 1),
}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 ulp at each |x| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def small(named, polname):
    pol = named(polname)
    return dataclasses.replace(pol, buffer_size=8, group=min(pol.group, 8),
                               rank=min(pol.rank, 2), rank_decode=min(pol.rank_decode, 2))


class Family:
    """Both packages' tiny model of one family on the reference's parameters,
    and the reference's jitted batch-1 programs, made once per policy."""

    def __init__(self, fid):
        arch, hq, hkv = FAMILIES[fid]
        over = dict(SMALL, num_heads=hq, num_kv_heads=hkv)
        self.ref_cfg = dataclasses.replace(ref_get_config(arch), **over)
        self.cfg = dataclasses.replace(get_config(arch), **over)
        self.ref_model = ref_build_model(self.ref_cfg)
        self.ref_params = self.ref_model.init(jax.random.PRNGKey(0))
        self.np_params = jax.tree.map(np.asarray, self.ref_params)
        self.model = build_model(self.cfg)
        self.params = params_from_reference(self.np_params, self.cfg, device="cpu")
        self._jit: dict = {}

    def ref_fns(self, polname, mode="monolithic"):
        if (polname, mode) not in self._jit:
            m, pol = self.ref_model, small(jnamed, polname)
            self._jit[polname, mode] = (
                jax.jit(lambda p, t: m.prefill(p, {"tokens": t}, pol, CAP, prefill_mode=mode,
                                               fused="interpret")),
                jax.jit(lambda p, t, c, pos: m.decode_step(p, {"tokens": t}, c, pos, pol, CAP,
                                                           fused="interpret")))
        return self._jit[polname, mode]

    def requests(self, mod, seed=0):
        """Four requests of two prompt lengths (fewer reference compiles); the
        budgets close a chunk during decode."""
        rng = np.random.RandomState(seed)
        return [mod.Request(rid=i, tokens=rng.randint(4, 64, size=n), max_new_tokens=b)
                for i, (n, b) in enumerate(zip([13, 21, 13, 21], [12, 6, 9, 11]))]

    def along(self, polname, prompt, tokens, mode):
        """(reference, port) logits [T, V] at each of ``tokens``,
        teacher-forced at batch 1 through both packages."""
        ppol = small(named_policy, polname)
        prefill, decode = self.ref_fns(polname, mode)
        logits, caches = prefill(self.ref_params, jnp.asarray(prompt[None]))
        plogits, pcaches = self.model.prefill(self.params, {"tokens": prompt[None]}, ppol, CAP,
                                              prefill_mode=mode)
        ref, port = [], []
        for i, tok in enumerate(tokens):
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


_FAMILIES: dict = {}


@pytest.fixture(params=list(FAMILIES))
def fam(request):
    if request.param not in _FAMILIES:
        _FAMILIES[request.param] = Family(request.param)
    return _FAMILIES[request.param]


def ref_leaf(fam, name: str):
    """The reference leaf behind the port parameter ``name``."""
    t = fam.np_params
    if name in ("embed", "lm_head"):
        return t[name]
    if name.startswith("final_norm"):
        return t["final_norm"]["bias" if name.endswith("_bias") else "scale"]
    _, i, field = name.split(".")
    unit = len(fam.cfg.layer_pattern)
    stacked, r = t["blocks"][int(i) % unit], int(i) // unit
    if field.startswith("ln"):
        return stacked[field[:3]]["bias" if field.endswith("_bias") else "scale"][r]
    sub = "attn" if field in ("wq", "wk", "wv", "wo") else "mlp"
    return stacked[sub][field][r]


def test_params_from_reference_round_trips_every_parameter(fam):
    """Every port parameter equals its reference leaf (matrices in bf16, norm
    scales and LayerNorm biases in f32), and every reference leaf lands in
    a port parameter: the LayerNorm biases and the two-matrix MLP come
    across, and a ``gelu_mlp`` block holds no ``w_gate``."""
    names = dict(fam.params.named_parameters())
    for name, p in names.items():
        want = np.asarray(ref_leaf(fam, name), np.float32)
        got = p.detach().float().numpy()
        np.testing.assert_array_equal(
            got, torch.from_numpy(want).to(p.dtype).float().numpy(), err_msg=name)
    ref_count = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(fam.np_params))
    assert sum(p.numel() for p in names.values()) == ref_count
    gated = fam.cfg.mlp_kind in mlp.GATED_KINDS
    assert all((blk.w_gate is not None) == gated for blk in fam.params.blocks)
    assert (fam.params.blocks[0].ln1_bias is not None) == (fam.cfg.norm == "layernorm")


def test_embed_tokens_matches_reference(fam):
    """Equal, except gemma's sqrt(d_model)-scaled embedding: within one bf16
    ulp (the reference scales the f32 table, the port its bf16 copy)."""
    toks = np.random.RandomState(1).randint(0, fam.cfg.vocab_size, size=(2, 9)).astype(np.int32)
    want = to_np(ref_tfm.embed_tokens(fam.ref_cfg, fam.ref_params, {"tokens": jnp.asarray(toks)}))
    got = to_np(tfm.embed_tokens(fam.params, torch.from_numpy(toks)))
    if fam.cfg.mlp_kind != "geglu":
        np.testing.assert_array_equal(got, want)
        return
    off = np.abs(got - want) / bf16_ulp(want)
    print(f"gemma scaled embedding: {np.mean(off > 0):.3%} of entries one ulp apart")
    assert off.max() <= EMBED_ULPS


def test_random_init_norm_constants_match_reference(fam):
    """``Transformer.random`` gives every norm the reference's
    ``norm_params``: RMSNorm scale 0 (its (1 + scale) gain), LayerNorm scale 1
    and bias 0 (all-zero LayerNorm scales would zero every block's input)."""
    model = tfm.Transformer.random(fam.cfg, seed=3, device="cpu")
    want = ref_common.norm_params(fam.cfg.d_model, fam.cfg.norm)
    for scale, bias in [(blk.ln1, blk.ln1_bias) for blk in model.blocks] + [
            (blk.ln2, blk.ln2_bias) for blk in model.blocks] + [
            (model.final_norm, model.final_norm_bias)]:
        np.testing.assert_array_equal(scale.numpy(), np.asarray(want["scale"]))
        if "bias" in want:
            np.testing.assert_array_equal(bias.numpy(), np.asarray(want["bias"]))
        else:
            assert bias is None


def test_gelu_tanh_matches_jax_within_one_ulp():
    x = np.random.RandomState(4).randn(4096).astype(np.float32) * 3
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = to_np(jax.nn.gelu(xb, approximate=True))
    got = to_np(common.gelu_tanh(torch.from_numpy(to_np(xb)).to(torch.bfloat16)))
    off = np.abs(got - want) / bf16_ulp(want)
    print(f"gelu_tanh: {np.mean(off > 0):.3%} of bf16 outputs off by <= {off.max()} ulp")
    assert off.max() <= GELU_ULPS
    f32 = to_np(common.gelu_tanh(torch.from_numpy(x)))
    np.testing.assert_allclose(f32, np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu_mlp"])
def test_mlp_apply_matches_reference(kind):
    rng = np.random.RandomState(5)
    cfg = dataclasses.replace(ref_get_config("gemma-2b"), d_model=64, d_ff=128, mlp_kind=kind)
    names = (("w_gate", (64, 128)),) if kind in mlp.GATED_KINDS else ()
    w = {n: rng.randn(*s).astype(np.float32) * 0.1
         for n, s in names + (("w_up", (64, 128)), ("w_down", (128, 64)))}
    h = jnp.asarray(rng.randn(2, 12, 64).astype(np.float32)).astype(jnp.bfloat16)
    want = to_np(ref_mlp.mlp_apply(cfg, {k: jnp.asarray(v) for k, v in w.items()}, h))
    layer = type("Layer", (), {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()})
    got = to_np(mlp.mlp_apply(layer, torch.from_numpy(to_np(h)).to(torch.bfloat16), kind))
    print(f"{kind}: max |port - reference| {np.abs(got - want).max():.4g}")
    np.testing.assert_allclose(got, want, rtol=0, atol=MLP_ATOL)


def codes(words: np.ndarray, bits: int) -> np.ndarray:
    """The ``bits``-bit codes packed in int32 words (lowest first)."""
    w = words.astype(np.int64) & 0xFFFFFFFF
    return np.stack([(w >> (bits * j)) & ((1 << bits) - 1) for j in range(32 // bits)], -1)


def assert_caches_close(port, ref, bits):
    """Lengths equal, stats within ``STAT_RTOL`` of the largest, codes
    mostly equal."""
    for pc, jc in zip(port, jax.tree.leaves(ref, is_leaf=lambda x: hasattr(x, "k_packed")),
                      strict=True):
        np.testing.assert_array_equal(to_np(pc.length), np.asarray(jc.length).reshape(-1))
        for name in ("k_scale", "k_zero", "v_scale", "v_zero", "buf_k", "buf_v"):
            a, b = to_np(getattr(pc, name)), to_np(getattr(jc, name))
            rel = np.abs(a - b.reshape(a.shape)).max() / max(np.abs(b).max(), 1e-6)
            print(f"  {name}: {rel:.3g} of the largest entry")
            assert rel <= STAT_RTOL, name
        for name in ("k_packed", "v_packed"):
            a, b = (codes(to_np(x), bits) for x in (getattr(pc, name), getattr(jc, name)))
            agree = np.mean(a == b.reshape(a.shape))
            print(f"  {name}: {agree:.4f} of codes equal")
            assert agree >= CODE_AGREE, name


def ref_layer_caches(ref_caches, n_layers):
    """The reference's per-pattern-position caches, stacked over repeats, as
    one cache per layer (pattern unit 1: repeat r is layer r)."""
    (stacked,) = ref_caches
    return [jax.tree.map(lambda x, r=r: x[r], stacked) for r in range(n_layers)]


@pytest.mark.parametrize("mode", ["monolithic", "streaming"])
def test_prefill_matches_reference(fam, mode):
    """Last-position logits and every layer cache of a 29-token prompt (3
    closed chunks and a partial buffer) against the reference's jitted
    prefill in interpret mode."""
    polname = "gear_kcvt4"
    prompt = np.random.RandomState(6).randint(4, 64, size=29).astype(np.int32)
    prefill, _ = fam.ref_fns(polname, mode)
    logits, caches = prefill(fam.ref_params, jnp.asarray(prompt[None]))
    plogits, pcaches = fam.model.prefill(fam.params, {"tokens": prompt[None]},
                                         small(named_policy, polname), CAP, prefill_mode=mode)
    gap = np.abs(to_np(plogits) - to_np(logits)).max()
    print(f"{fam.cfg.name} G={fam.cfg.num_heads // fam.cfg.num_kv_heads} {mode}: "
          f"prefill logit gap {gap:.4g}")
    assert gap <= PREFILL_ATOL
    assert_caches_close(pcaches, ref_layer_caches(caches, fam.cfg.num_layers),
                        small(named_policy, polname).bits)


SERVING = {"monolithic-dense": {}, "streaming-paged": dict(prefill_mode="streaming",
                                                            layout="paged")}


@pytest.mark.parametrize("case", list(SERVING))
def test_run_continuous_matches_reference_engine(fam, case):
    """Two slots, four requests, chunk closes in prefill and decode, gear_kcvt4:
    the port's engine against the reference's under the teacher-forced rule."""
    polname, over = "gear_kcvt4", SERVING[case]
    got = {}
    for name, mod, model, params, named, extra in (
            ("ref", R, fam.ref_model, fam.ref_params, jnamed, {}),
            ("port", P, fam.model, fam.params, named_policy, {"device": "cpu"})):
        eng = mod.Engine(model, params, mod.EngineConfig(
            batch=2, capacity=CAP, policy=small(named, polname), eos_id=EOS, **over), **extra)
        sched = mod.Scheduler(eng)
        for r in fam.requests(mod):
            sched.submit(r)
        got[name] = sched.run_continuous()
    ref, port = got["ref"], got["port"]
    assert [(r.rid, str(r.status)) for r in port] == [(r.rid, str(r.status)) for r in ref]
    prompts = {r.rid: r.tokens for r in fam.requests(P)}
    want = {r.rid: np.asarray(r.tokens) for r in ref}
    mode = over.get("prefill_mode", "monolithic")
    for r in port:
        toks = np.asarray(r.tokens)
        rlog, plog = fam.along(polname, prompts[r.rid], toks, mode)
        gaps = np.abs(rlog - plog).max(-1)
        print(f"{fam.cfg.name} {case} rid {r.rid}: largest gap {gaps.max():.4f}")
        assert (gaps <= GAP).all(), (r.rid, gaps)
        np.testing.assert_array_equal(toks, plog.argmax(-1))
        m = min(len(toks), len(want[r.rid]))
        diff = np.flatnonzero(toks[:m] != want[r.rid][:m])
        if diff.size:                  # only where rounding can explain it
            top2 = np.sort(rlog[diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[diff[0]], (r.rid, toks, want[r.rid])
        else:
            np.testing.assert_array_equal(toks, want[r.rid])


PORTED = ("llama2-7b", "hymba-1.5b", "rwkv6-3b", "minicpm-2b", "starcoder2-3b", "gemma-2b",
          "gemma3-12b", "paligemma-3b", "musicgen-medium", "qwen3-moe-235b-a22b",
          "llama4-scout-17b-a16e")


@pytest.mark.parametrize("arch", ["gemma3-12b", "minicpm-2b", "gemma-2b", "starcoder2-3b",
                                  "paligemma-3b", "qwen3-moe-235b-a22b",
                                  "llama4-scout-17b-a16e", "musicgen-medium", "hymba-1.5b",
                                  "rwkv6-3b", "llama2-7b"])
def test_registry_and_check_supported_cover_the_ported_families(arch):
    """Every reference config: the port registers it, field for field, and
    builds it (every one of the 11 is a ported family); a combination no
    family has (an MoE audio model) still raises."""
    from repro_torch.configs.base import ModelConfig

    assert arch in PORTED
    cfg = ModelConfig(**dataclasses.asdict(ref_get_config(arch)))
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(cfg)
    tfm.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="none of them"):
        tfm.check_supported(dataclasses.replace(cfg, family="audio", modality="audio",
                                                num_codebooks=4, moe=True, num_experts=4))
