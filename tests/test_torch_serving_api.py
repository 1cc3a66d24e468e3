"""The reference's last serving names in the port, against the JAX reference:
the ``str`` enums ``AttendPath`` / ``PrefillMode`` / ``CacheLayout`` of
``EngineConfig``, the ``CacheView`` protocol, ``core.cache``'s
``fresh_batch1_cache`` and ``prefill_into_slot``, the packages' public names
(``repro_torch.core``, ``repro_torch.serving``, ``repro_torch.kernels``), and
the name map: every public top-level name of a reference module has a twin
in the port's module or a counterpart of another shape listed in
:data:`NAME_MAP` (ROADMAP §1 keeps the same list).

What is held, and how:

* the enums' members and values equal the reference's; an engine built from
  members serves the same greedy tokens as one built from their strings, bit
  for bit (smoke llama2-7b, streaming prefill, paged pool, 3 requests);
  ``"interpret"`` is refused in either spelling;
* both views satisfy ``CacheView`` and the protocol has the reference's
  members;
* ``prefill_into_slot`` on the reference's inputs (gear_kcvt4 and
  gear_kivi2, 100 tokens, slot 1 of 2): codes, stats, outliers, buffer and
  lengths bit for bit against the reference's jitted ``prefill_into_slot``,
  the bf16 low-rank factors through ``A·Bᵀ`` within 1e-2 relative (ROADMAP
  §3, standing difference c); the other slot untouched;
* ``fresh_batch1_cache`` returns one object per (geometry, dtype, device),
  and no call writes into it.
"""

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.serving as R  # noqa: E402
import repro_torch.serving as P  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.serving import views as rviews  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_SRC, PORT_SRC = REPO / "src" / "repro", REPO / "src" / "repro_torch"
CAP = 192
AB_RTOL = 1e-2

# module twins under another file name (the dry run's, PR 29)
FILE_TWINS = {"perf/jaxpr_cost.py": "perf/op_cost.py", "perf/hlo_stats.py": "perf/comm_stats.py"}

# reference name (module path: name) -> the port's counterparts of another
# shape, each a dotted name that must resolve
NAME_MAP = {
    "models/transformer.py:forward": ["models.transformer.forward_prefill",
                                      "models.transformer.forward_train"],
    "models/transformer.py:init_params": ["models.transformer.Transformer.random",
                                          "models.model.Model.init"],
    "models/transformer.py:block_params": ["models.transformer.Block",
                                           "models.transformer.RWKVBlock"],
    "models/attention.py:attn_params": ["models.transformer.Block"],
    "models/mlp.py:mlp_params": ["models.transformer.Block"],
    "models/moe.py:moe_params": ["models.moe.MoE", "models.moe.Expert"],
    "models/rwkv.py:rwkv_params": ["models.rwkv.TimeMix", "models.rwkv.ChannelMix"],
    "models/ssm.py:ssm_params": ["models.transformer.Block"],
    "models/common.py:norm_params": ["models.transformer.Block", "models.transformer.RWKVBlock"],
    "models/common.py:KeyGen": ["models.transformer.Transformer.random"],
    "models/common.py:dense_init": ["models.transformer.Transformer.random"],
    "models/model.py:input_specs": ["launch.dryrun.input_batch"],
    "models/model.py:decode_state_specs": ["launch.dryrun.build_cell"],
    "dist/compat.py:manual_shard_map": ["dist.compat.axis_group", "dist.compat.all_reduce_mean_",
                                        "dist.compat.all_gather_cat"],
    "kernels/ops.py:gear_compress_chunks": ["kernels.gear_compress.gear_compress"],
    "kernels/ops.py:on_tpu": ["kernels._build.runs_plain"],
    "kernels/__init__.py:on_tpu": ["kernels._build.runs_plain"],
    "kernels/flash_prefill.py:NEG_INF": ["kernels.ref.NEG_INF"],
    "kernels/gear_decode.py:NEG_INF": ["kernels.ref.NEG_INF"],
    "kernels/linear_scan_kernel.py:CLAMP": ["kernels.ref.SCAN_CLAMP"],
    "models/linear_scan.py:CLAMP": ["kernels.ref.SCAN_CLAMP"],
    "perf/hlo_stats.py:op_histogram": ["perf.op_cost.op_histogram"],
    "perf/jaxpr_cost.py:jaxpr_cost": ["perf.op_cost.trace_cost"],
}


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def bf16_np(shape, seed) -> np.ndarray:
    """Random values exactly representable in bf16, as f32 numpy."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return to_np(jnp.asarray(x).astype(jnp.bfloat16))


def rel_err(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12))


# ---------------------------------------------------------------------------
# the enums


@pytest.mark.parametrize("name", ["AttendPath", "PrefillMode", "CacheLayout"])
def test_enums_equal_the_reference(name):
    ref, port = getattr(R, name), getattr(P, name)
    assert [(m.name, m.value) for m in port] == [(m.name, m.value) for m in ref]
    for m in port:
        assert isinstance(m, str) and m == m.value and str(m) == f"{m}" == m.value
        assert port(getattr(ref, m.name)) is m            # the reference's member coerces


def test_engine_config_stores_members_for_strings_and_members():
    pol = named_policy("gear_kcvt4")
    for fused, mode, layout in (("auto", "streaming", "paged"),
                                (P.AttendPath.OFF, P.PrefillMode.MONOLITHIC, P.CacheLayout.DENSE)):
        ecfg = P.EngineConfig(batch=2, capacity=CAP, policy=pol, fused=fused,
                              prefill_mode=mode, layout=layout)
        assert ecfg.fused is P.AttendPath(fused)
        assert ecfg.prefill_mode is P.PrefillMode(mode)
        assert ecfg.layout is P.CacheLayout(layout)
    default = P.EngineConfig(batch=2, capacity=CAP, policy=pol)
    assert (default.fused, default.prefill_mode, default.layout) == ("auto", "monolithic", "dense")
    with pytest.raises(ValueError, match="layout must be dense/paged, got 'pooled'"):
        P.EngineConfig(batch=2, capacity=CAP, policy=pol, layout="pooled")
    with pytest.raises(ValueError, match="prefill_mode must be monolithic/streaming"):
        P.EngineConfig(batch=2, capacity=CAP, policy=pol, prefill_mode="chunked")


@pytest.mark.parametrize("fused", ["interpret", "AttendPath.INTERPRET"])
def test_interpret_is_refused_in_either_spelling(fused):
    value = P.AttendPath.INTERPRET if fused == "AttendPath.INTERPRET" else fused
    with pytest.raises(NotImplementedError, match="CUDA has no interpret mode"):
        P.EngineConfig(batch=2, capacity=CAP, policy=named_policy("gear_kcvt4"), fused=value)


def test_engine_from_members_serves_the_tokens_of_one_from_strings():
    cfg = smoke_config("llama2-7b")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    rng = np.random.RandomState(3)
    prompts = [rng.randint(4, cfg.vocab_size, size=n) for n in (70, 130, 9)]
    out = {}
    for name, knobs in (("strings", ("auto", "streaming", "paged")),
                        ("members", (P.AttendPath.AUTO, P.PrefillMode.STREAMING,
                                     P.CacheLayout.PAGED))):
        fused, mode, layout = knobs
        eng = P.Engine(model, params, P.EngineConfig(
            batch=2, capacity=CAP, policy=named_policy("gear_kcvt4"), fused=fused,
            prefill_mode=mode, layout=layout), device="cpu")
        sched = P.Scheduler(eng)
        for rid, p in enumerate(prompts):
            sched.submit(P.Request(rid=rid, tokens=p, max_new_tokens=5))
        out[name] = {r.rid: (str(r.status), np.asarray(r.tokens)) for r in sched.run_continuous()}
        assert isinstance(eng.new_view(), P.PagedCacheView)
        assert sched.last_stats["layout"] == "paged"
    assert out["members"].keys() == out["strings"].keys() == {0, 1, 2}
    for rid, (status, toks) in out["strings"].items():
        assert status == out["members"][rid][0] == "ok"
        assert len(toks) == 5
        np.testing.assert_array_equal(out["members"][rid][1], toks)


# ---------------------------------------------------------------------------
# the CacheView protocol


def protocol_members(cls) -> set:
    return {n for n in vars(cls) if not n.startswith("_")} | set(cls.__annotations__)


def test_cache_view_protocol_has_the_reference_members_and_both_views_satisfy_it():
    assert protocol_members(P.CacheView) == protocol_members(rviews.CacheView)
    cfg = smoke_config("llama2-7b")
    model = build_model(cfg)
    params = model.init(seed=0, device="cpu")
    pol = named_policy("gear_kcvt4")
    for layout, cls in (("dense", P.DenseCacheView), ("paged", P.PagedCacheView)):
        eng = P.Engine(model, params, P.EngineConfig(batch=2, capacity=CAP, policy=pol,
                                                     prefill_mode="streaming", layout=layout),
                       device="cpu")
        view = eng.new_view()
        assert type(view) is cls and isinstance(view, P.CacheView)
        for member in protocol_members(P.CacheView) - {"caches"}:
            assert callable(getattr(view, member)), (layout, member)
        assert view.can_admit(CAP) and view.audit()["ok"]
    assert not isinstance(object(), P.CacheView)


# ---------------------------------------------------------------------------
# fresh_batch1_cache and prefill_into_slot


def cache_cfgs(polname, B=2, H=2, Dh=64, S=128):
    j = jcache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S, policy=jnamed(polname))
    p = cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                          policy=named_policy(polname))
    return j, p


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_prefill_into_slot_matches_reference(polname):
    jcfg, pcfg = cache_cfgs(polname)
    k, v = bf16_np((1, 2, 100, 64), 0), bf16_np((1, 2, 100, 64), 1)
    k[0, 0, :64, 9] = 2.5                                  # constant channel in chunk 0
    jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (k, v))
    ref = jax.jit(lambda a, b: jcache.prefill_into_slot(
        jcfg, jcache.init_layer_cache(jcfg), a, b, 1))(jk, jv)
    full = cache.init_layer_cache(pcfg, device="cpu")
    port = cache.prefill_into_slot(pcfg, full, torch.from_numpy(k).to(torch.bfloat16),
                                   torch.from_numpy(v).to(torch.bfloat16), 1)
    assert port is full
    pol = pcfg.policy
    for f in cache.FIELDS:
        r, p = getattr(ref, f), getattr(port, f)
        assert (r is None) == (p is None), f
        if r is None:
            continue
        assert tuple(p.shape) == tuple(r.shape), f
        assert str(p.dtype).split(".")[-1] == str(r.dtype), f
        assert not p[0].any(), f                           # the other slot untouched
        if not f.endswith(("_a", "_b")):
            np.testing.assert_array_equal(to_np(p), to_np(r), err_msg=f)
    assert port.length.tolist() == [0, 100]
    if pol.use_lowrank:
        nb, C = pcfg.chunk, pcfg.n_chunks
        for kv in ("k", "v"):
            def ab(c, kv=kv):
                a = to_np(getattr(c, f"{kv}_a"))[1].reshape(2, C, nb, pol.rank)
                return a @ np.swapaxes(to_np(getattr(c, f"{kv}_b"))[1], -1, -2)
            assert rel_err(ab(ref), ab(port)) <= AB_RTOL, kv


def test_fresh_batch1_cache_is_one_object_per_geometry_and_never_written():
    _, pcfg = cache_cfgs("gear_kcvt4")
    pcfg1 = dataclasses.replace(pcfg, batch=1)
    empty = cache.fresh_batch1_cache(pcfg, device="cpu")
    assert cache.fresh_batch1_cache(pcfg1, device="cpu") is empty
    assert cache.fresh_batch1_cache(pcfg, torch.bfloat16, "cpu") is empty
    assert cache.fresh_batch1_cache(pcfg, "float32", "cpu") is not empty
    assert cache.fresh_batch1_cache(dataclasses.replace(pcfg, capacity=192),
                                    device="cpu") is not empty
    assert empty.length.shape == (1,) and empty.k_packed.shape[0] == 1
    window = cache.CacheConfig(batch=3, kv_heads=2, head_dim=64, capacity=40,
                               policy=pcfg.policy, kind="window", window=16)
    ring = cache.fresh_batch1_cache(window, device="cpu")
    k = torch.from_numpy(bf16_np((1, 2, 100, 64), 2)).to(torch.bfloat16)
    for slot in (0, 1):
        cache.prefill_into_slot(pcfg, cache.init_layer_cache(pcfg, device="cpu"), k, k, slot)
        wfull = cache.init_layer_cache(window, device="cpu")
        cache.prefill_into_slot(window, wfull, k[:, :, :30], k[:, :, :30], slot)
        assert wfull.length.tolist()[slot] == 30 and (wfull.pos[slot] >= 0).sum() == 16
        cache.prefill_into_slot(pcfg, cache.init_layer_cache(pcfg, device="cpu"), k, k, slot,
                                key=np.asarray(jax.random.PRNGKey(1)))
    assert all(not t.any() for t in empty.tensors().values())
    assert (ring.pos == -1).all() and not ring.k.any() and not ring.length.any()


# ---------------------------------------------------------------------------
# the packages' public names and the name map


@pytest.mark.parametrize("pkg", ["core", "serving", "kernels"])
def test_package_exports_cover_the_reference(pkg):
    """Each package exports the reference package's names (but those of the
    name map) in ``__all__``, and each of them resolves (``core`` and
    ``kernels`` load some lazily)."""
    port = importlib.import_module(f"repro_torch.{pkg}")
    want = public_names(REF_SRC / pkg / "__init__.py", port=False)
    mapped = {n.split(":")[1] for n in NAME_MAP if n.startswith(f"{pkg}/__init__.py:")}
    assert want - set(port.__all__) == mapped
    for name in port.__all__:
        assert getattr(port, name) is not None, name


def public_names(path: pathlib.Path, port: bool) -> set:
    """A module's public top-level names: what it defines or assigns, its
    ``__all__``, and a package's re-exports; on the port's side every
    binding counts (a twin may import the name from a sibling)."""
    tree = ast.parse(path.read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__" and isinstance(node.value, (ast.List, ast.Tuple)):
                        names |= {e.value for e in node.value.elts
                                  if isinstance(e, ast.Constant)}
        elif isinstance(node, (ast.Import, ast.ImportFrom)) and (port or
                                                                  path.name == "__init__.py"):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


def resolve(dotted: str):
    parts = ("repro_torch." + dotted).split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def test_every_reference_name_has_a_twin_or_a_mapped_counterpart():
    """The AST diff of public top-level names, module by module: what the
    port's twin lacks must be in :data:`NAME_MAP`, and every entry of the
    map must be such a name whose counterparts resolve."""
    missing = set()
    for ref_path in sorted(REF_SRC.rglob("*.py")):
        rel = str(ref_path.relative_to(REF_SRC))
        port_path = PORT_SRC / FILE_TWINS.get(rel, rel)
        assert port_path.exists(), rel
        # a star-free re-export through a lazy ``__getattr__`` shows in ``__all__``
        gone = public_names(ref_path, port=False) - public_names(port_path, port=True)
        missing |= {f"{rel}:{n}" for n in gone}
    assert missing == set(NAME_MAP)
    for counterparts in NAME_MAP.values():
        for dotted in counterparts:
            assert resolve(dotted) is not None, dotted
