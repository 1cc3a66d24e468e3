"""The port's distribution layer against the JAX reference, in one process:
``fit_spec`` on the reference's own cases, the parameter / ZeRO-1 / batch /
cache spec trees of every architecture on stand-in meshes, the roofline's
``model_flops`` and the analytic parameter counts, the Gram-Schmidt
orthonormalizer, and PowerSGD's ``compressed_psum`` on two pods.

Stand-in meshes carry only axis names and sizes (the rules read nothing
else): 16×16, 2×16×16, 2×2, 4×1 and 1×1.  The port's parameters are one
tensor a layer where the reference stacks each pattern position's layers
on a leading dim R, so a port leaf's spec is held against the reference's
with the R entry dropped.  The standing differences are the leaves where
the reference's legalization puts an axis on R (``PINNED_R``): hymba-1.5b's
full ``w_bcdt`` [1600, 825], whose 825 no model axis of 2 or 16 divides
(the reference moves ``model`` onto R = 32, the port onto 1600), and, on
the 1×1 mesh, hymba-1.5b's per-head vectors [25] under ZeRO-1 (the
reference puts the size-1 ``data`` axis on R = 32, the larger dim).  Both
layouts are legal for the same values.

``compressed_psum`` runs as two pods, threads of this process each with its
own gloo process group, against the reference's under
``jax.vmap(axis_name="pod")`` with the reference's start matrices: means
and error feedback within ``PSGD_ATOL`` 1e-5, byte metrics exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import configs as rcfgs  # noqa: E402
from repro.core import lowrank as rlowrank  # noqa: E402
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro.data import synthetic as rdata  # noqa: E402
from repro.dist import sharding as rshd  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro.optim import grad_compress as rgc  # noqa: E402
from repro.perf import roofline as rroof  # noqa: E402

from repro_torch import configs as pcfgs  # noqa: E402
from repro_torch.core import lowrank  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.dist import sharding as shd  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.optim import grad_compress as gc_lib  # noqa: E402
from repro_torch.perf import roofline  # noqa: E402
from repro_torch.train.state import global_shapes  # noqa: E402
from test_torch_mesh_train import thread_pods  # noqa: E402

PSGD_ATOL = 1e-5
MGS_ATOL = 1e-6


class Mesh:
    """A stand-in mesh: axis names and sizes, read by both packages' rules."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"16x16": Mesh(data=16, model=16), "2x16x16": Mesh(pod=2, data=16, model=16),
          "2x2": Mesh(data=2, model=2), "4x1": Mesh(data=4, model=1),
          "1x1": Mesh(data=1, model=1)}


# ---------------------------------------------------------------------------
# fit_spec: the reference's TestFitSpec cases (tests/test_distributed.py)


class FakeMesh:
    shape = {"data": 4, "model": 4}


class PodMesh:
    shape = {"pod": 2, "data": 4, "model": 4}


FIT_CASES = {
    "migrates_axis": (("model", None), (122753, 2304), {}, (None, "model")),
    "drops_axis": (("model",), (7,), {}, (None,)),
    "keeps_legal": ((None, "model"), (8, 16), {}, (None, "model")),
    "multi_axis_group_kept_when_divisible": ((("data", "model"), None), (16, 4), {},
                                             (("data", "model"), None)),
    "multi_axis_group_splits_and_migrates": ((("data", "model"), None), (8, 64), {},
                                             ("data", "model")),
    "multi_axis_group_drops_when_nothing_fits": ((("data", "model"),), (7,), {}, (None,)),
    "partially_migrated_group_rehomes_its_remainder": ((("data", "model"), None, None),
                                                       (2, 4, 4), {}, (None, "data", "model")),
    "zero_size_dim_accepts_any_sharding": (("model", None), (0, 5), {}, ("model", None)),
    "mesh_axes_absent_from_spec_are_fine": ((None, "model"), (8, 16), {"mesh": PodMesh()},
                                            (None, "model")),
    "spec_axis_unknown_to_mesh_is_dropped": (("tensor", None), (8, 8), {}, (None, None)),
    "short_spec_padded_to_rank": (("model",), (8, 6), {}, ("model", None)),
    "no_migration_when_disabled": (("model", None), (7, 16), {"migrate": False}, (None, None)),
    "overlong_spec_rejected": (("model", None), (16,), {}, ValueError),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_spec_matches_the_reference_cases(case):
    spec, shape, kw, want = FIT_CASES[case]
    mesh = kw.pop("mesh", FakeMesh()) if kw else FakeMesh()
    if want is ValueError:
        with pytest.raises(ValueError):
            shd.fit_spec(shd.P(*spec), shape, mesh, **kw)
        with pytest.raises(ValueError):
            rshd.fit_spec(JP(*spec), shape, mesh, **kw)
        return
    got = shd.fit_spec(shd.P(*spec), shape, mesh, **kw)
    assert tuple(got) == want
    assert tuple(got) == tuple(rshd.fit_spec(JP(*spec), shape, mesh, **kw))


# ---------------------------------------------------------------------------
# spec trees of every architecture


_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_MLP = ("w_gate", "w_up", "w_down")
_SSM = ("w_in", "conv_w", "w_bcdt", "w_out", "a_log", "dt_bias", "d_skip")


def ref_path(cfg, name: str):
    """(path into the reference's parameter tree, stacked over R?) of a
    port parameter name (the inverse of ``models.convert``)."""
    parts = name.split(".")
    if parts[0] != "blocks":
        return {"embed": ("embed",), "lm_head": ("lm_head",),
                "final_norm": ("final_norm", "scale"),
                "final_norm_bias": ("final_norm", "bias")}[name], False
    i, rest = int(parts[1]), parts[2:]
    pre = ("blocks", i % len(cfg.layer_pattern))
    n = rest[0]
    if n in ("ln1", "ln2", "ln1_scale", "ln2_scale"):
        return pre + (n[:3], "scale"), True
    if n in ("ln1_bias", "ln2_bias"):
        return pre + (n[:3], "bias"), True
    if n in ("tm", "cm", "moe"):
        return pre + tuple(rest), True
    for group, names in (("attn", _ATTN), ("mlp", _MLP), ("ssm", _SSM)):
        if n in names:
            return pre + (group, n), True
    raise KeyError(name)


def get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# (arch, smoke, mesh, spec fn, leaf name) where the reference puts an axis on R
PINNED_R = {("hymba-1.5b", False, m, fn, "w_bcdt")
            for m in ("16x16", "2x16x16", "2x2") for fn in ("param_pspecs", "zero1_pspecs")}
PINNED_R |= {("hymba-1.5b", False, "1x1", "zero1_pspecs", n) for n in ("a_log", "dt_bias", "d_skip")}


def ref_leaf_paths(tree) -> set:
    out = set()
    for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.add(tuple(k.key if hasattr(k, "key") else k.idx for k in path))
    return out


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", pcfgs.ALL_ARCHS)
def test_spec_trees_match_the_reference(arch, smoke):
    rcfg = rcfgs.smoke_config(arch) if smoke else rcfgs.get_config(arch)
    pcfg = pcfgs.smoke_config(arch) if smoke else pcfgs.get_config(arch)
    abstract = jax.eval_shape(lambda: ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    shapes = global_shapes(pcfg)
    assert {ref_path(pcfg, n)[0] for n in shapes} == ref_leaf_paths(abstract)
    for mname, mesh in MESHES.items():
        for fn in ("param_pspecs", "zero1_pspecs"):
            ref, port = getattr(rshd, fn)(rcfg, abstract, mesh), getattr(shd, fn)(pcfg, shapes,
                                                                                 mesh)
            assert list(port) == list(shapes)
            for name, spec in port.items():
                path, stacked = ref_path(pcfg, name)
                leaf, rspec = get(abstract, path), tuple(get(ref, path))
                if not stacked:
                    assert tuple(leaf.shape) == shapes[name] and tuple(spec) == rspec, name
                    continue
                assert tuple(leaf.shape[1:]) == shapes[name], name
                if tuple(spec) != rspec[1:]:  # only where the reference put an axis on R
                    assert rspec[0] is not None, (name, mname, fn, spec, rspec)
                    assert (arch, smoke, mname, fn, name.split(".")[-1]) in PINNED_R, name
        for batch, seq in ((256, 16), (6, 8)):
            dc = rdata.DataConfig(seed=0, vocab_size=rcfg.vocab_size,
                                  seq_len=seq + rcfg.num_prefix_tokens, global_batch=batch)
            rbatch = jax.eval_shape(lambda: rdata.make_batch(dc, rcfg, 0))
            pbatch = {k: torch.empty(v.shape, device="meta") for k, v in rbatch.items()}
            got = shd.batch_pspecs(pcfg, pbatch, mesh)
            want = rshd.batch_pspecs(rcfg, rbatch, mesh)
            assert {k: tuple(v) for k, v in got.items()} == {k: tuple(v) for k, v in want.items()}


def test_pinned_r_differences_are_the_only_ones():
    """Every pinned case still differs (hymba-1.5b's full config is where all
    of them live), and the port's w_bcdt puts ``model`` on its dim 0."""
    rcfg, pcfg = rcfgs.get_config("hymba-1.5b"), pcfgs.get_config("hymba-1.5b")
    abstract = jax.eval_shape(lambda: ref_build_model(rcfg).init(jax.random.PRNGKey(0)))
    shapes = global_shapes(pcfg)
    found = set()
    for mname, mesh in MESHES.items():
        for fn in ("param_pspecs", "zero1_pspecs"):
            ref = getattr(rshd, fn)(rcfg, abstract, mesh)
            port = getattr(shd, fn)(pcfg, shapes, mesh)
            for name, spec in port.items():
                path, stacked = ref_path(pcfg, name)
                rspec = tuple(get(ref, path))
                if stacked and tuple(spec) != rspec[1:]:
                    found.add(("hymba-1.5b", False, mname, fn, name.split(".")[-1]))
    assert found == PINNED_R
    port = shd.param_pspecs(pcfg, shapes, MESHES["16x16"])
    assert shapes["blocks.0.w_bcdt"] == (1600, 825)
    assert tuple(port["blocks.0.w_bcdt"]) == ("model", None)


CACHE_ARCHS = ("minicpm-2b", "hymba-1.5b", "rwkv6-3b", "gemma3-12b")


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_the_reference(arch):
    rcfg, pcfg = rcfgs.smoke_config(arch), pcfgs.smoke_config(arch)
    batch, capacity = 4, 128
    ref_caches = jax.eval_shape(lambda: ref_build_model(rcfg).init_caches(
        ref_named_policy("gear_kcvt4"), batch, capacity))
    port_caches = tfm.init_caches(pcfg, named_policy("gear_kcvt4"), batch, capacity,
                                  torch.device("cpu"))
    unit = len(pcfg.layer_pattern)
    for mname, mesh in MESHES.items():
        ref = rshd.cache_pspecs(rcfg, ref_caches, mesh, batch)
        port = shd.cache_pspecs(pcfg, port_caches, mesh, batch)
        assert len(port) == pcfg.num_layers
        for i, layer in enumerate(port):
            parts = layer if isinstance(layer, tuple) else (layer,)
            rparts = ref[i % unit] if isinstance(ref[i % unit], tuple) else (ref[i % unit],)
            rleaves = (ref_caches[i % unit] if isinstance(ref_caches[i % unit], tuple)
                       else (ref_caches[i % unit],))
            cache_parts = (port_caches[i] if isinstance(port_caches[i], tuple)
                           else (port_caches[i],))
            assert len(parts) == len(rparts)
            for part, rpart, rleaf, cpart in zip(parts, rparts, rleaves, cache_parts):
                assert part, (arch, i)
                for field, spec in part.items():
                    rspec = tuple(getattr(rpart, field))
                    assert rspec[0] is None           # R stays replicated
                    assert tuple(getattr(rleaf, field).shape[1:]) == \
                        tuple(cpart.tensors()[field].shape), (arch, field)
                    assert tuple(spec) == rspec[1:], (arch, mname, i, field, spec, rspec)


# ---------------------------------------------------------------------------
# roofline and parameter counts


@pytest.mark.parametrize("arch", pcfgs.ALL_ARCHS)
def test_model_flops_and_param_counts_match_the_reference(arch):
    pcfg, rcfg = pcfgs.get_config(arch), rcfgs.get_config(arch)
    assert pcfg.param_count() == rcfg.param_count()
    assert pcfg.active_param_count() == rcfg.active_param_count()
    assert [s.name for s in pcfgs.shapes_for(arch)] == [s.name for s in rcfgs.shapes_for(arch)]
    for name, shape in pcfgs.SHAPES.items():
        rshape = rcfgs.SHAPES[name]
        assert (shape.seq_len, shape.global_batch, shape.mode) == \
            (rshape.seq_len, rshape.global_batch, rshape.mode)
        assert roofline.model_flops(pcfg, shape) == rroof.model_flops(rcfg, rshape)


def test_roofline_terms_follow_the_reference_formulas():
    """The port's terms are the reference's formulas over the H100's
    constants: scaling each constant back to the v5e's gives the
    reference's row."""
    args = (3.2e15, 4.1e12, 7.5e10, 4, 2.4e15)
    got, want = roofline.roofline(*args), rroof.roofline(*args)
    for key, hw in (("compute_s", "peak_flops"), ("memory_s", "hbm_bw"),
                    ("collective_s", "ici_bw")):
        assert getattr(got, key) * roofline.HW[hw] == pytest.approx(
            getattr(want, key) * rroof.HW[hw], rel=1e-12)
    assert got.flops_efficiency == want.flops_efficiency
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9}
    row = got.row()
    assert row["bottleneck"] == max(("compute", got.compute_s), ("memory", got.memory_s),
                                    ("collective", got.collective_s), key=lambda kv: kv[1])[0]
    assert row["roofline_frac"] == pytest.approx(
        args[4] / (4 * roofline.HW["peak_flops"]) / got.step_time_s)


# ---------------------------------------------------------------------------
# the Gram-Schmidt orthonormalizer and PowerSGD


@pytest.mark.parametrize("shape", [(64, 8), (3, 40, 4), (256, 16), (9, 3)])
def test_mgs_q_matches_the_reference(shape):
    """Tall matrices, as the compressor passes them ([m, rank], m >> rank);
    a square 16 x 16 one reads 1.3e-6 (its last columns are ill-conditioned,
    and the two packages sum in different orders)."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    if shape == (9, 3):
        x[:, 1] = 0.0                     # a zero column: the norm's 1e-12 floor
    got = lowrank._mgs_q(torch.from_numpy(x)).numpy()
    want = np.asarray(rlowrank._mgs_q(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=MGS_ATOL)


def test_power_iteration_mgs_matches_the_reference():
    x = np.random.default_rng(3).standard_normal((96, 40)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    init = np.asarray(jax.random.normal(key, (40, 4), jnp.float32))
    ra, rb = rlowrank.power_iteration(jnp.asarray(x), 4, 2, key, orthonormalizer="mgs")
    init = init.copy()
    a, b = lowrank.power_iteration(torch.from_numpy(x), 4, 2, init=torch.from_numpy(init),
                                   orthonormalizer="mgs")
    np.testing.assert_allclose(a.numpy(), np.asarray(ra), rtol=0, atol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=0, atol=1e-4)
    with pytest.raises(ValueError, match="orthonormalizer"):
        lowrank.power_iteration(torch.from_numpy(x), 4, 2, orthonormalizer="svd")


# leaves in the reference's flattening order (sorted keys): two compressible
# matrices (one 3-D, collapsed to [64, 48]), a small matrix and a vector
PSGD_SHAPES = {"a_mat": (64, 96), "b_stack": (2, 32, 48), "c_small": (8, 8), "d_vec": (100,)}
PSGD_CFG = dict(rank=4, power_iters=2, min_size=1024, axis="pod")


@pytest.mark.parametrize("step", [0, 7])
def test_compressed_psum_on_two_pods_matches_the_reference(step):
    rng = np.random.default_rng(step)
    pods = 2
    grads = [{n: rng.standard_normal(s).astype(np.float32) for n, s in PSGD_SHAPES.items()}
             for _ in range(pods)]
    rcfg = rgc.CompressorConfig(**PSGD_CFG)
    pcfg = gc_lib.CompressorConfig(**PSGD_CFG)
    efs = [{n: (0.1 * rng.standard_normal(s)).astype(np.float32) if rcfg.compressible(
        np.empty(s)) else None for n, s in PSGD_SHAPES.items()} for _ in range(pods)]
    key = jax.random.fold_in(jax.random.PRNGKey(17), step)

    def ref(g, e):
        return rgc.compressed_psum(g, e, rcfg, key)

    stack = {n: jnp.stack([g[n] for g in grads]) for n in PSGD_SHAPES}
    ef_stack = {n: None if efs[0][n] is None else jnp.stack([e[n] for e in efs])
                for n in PSGD_SHAPES}
    rmean, ref_ef, rmet = jax.vmap(ref, axis_name="pod")(stack, ef_stack)

    inits = {}
    for i, (n, s) in enumerate(PSGD_SHAPES.items()):
        if pcfg.compressible(s):
            inits[n] = torch.from_numpy(np.array(jax.random.normal(
                jax.random.fold_in(key, i), (s[-1], pcfg.rank), jnp.float32)))
    per_pod = [({n: torch.from_numpy(g[n]) for n in PSGD_SHAPES},
                {n: torch.from_numpy(e[n]) for n in PSGD_SHAPES if e[n] is not None}, inits)
               for g, e in zip(grads, efs)]
    out = thread_pods(lambda grp, g, e, i: gc_lib.compressed_psum(g, e, pcfg, grp, i), per_pod)
    for pod, (mean, ef, met) in enumerate(out):
        assert list(mean) == list(PSGD_SHAPES) and set(ef) == set(inits)
        for n in PSGD_SHAPES:
            np.testing.assert_allclose(mean[n].numpy(), np.asarray(rmean[n][pod]), rtol=0,
                                       atol=PSGD_ATOL, err_msg=n)
            if n in inits:
                np.testing.assert_allclose(ef[n].numpy(), np.asarray(ref_ef[n][pod]), rtol=0,
                                           atol=PSGD_ATOL, err_msg=n)
            else:
                assert ref_ef[n] is None
        for k in ("exact_bytes", "compressed_bytes", "n_dev"):
            assert float(met[k]) == float(rmet[k][pod]), k
    assert float(out[0][2]["compressed_bytes"]) > 0


def test_draw_inits_are_seeded_by_step_and_leaf():
    cfg = gc_lib.CompressorConfig(rank=4, min_size=1024)
    a = gc_lib.draw_inits(PSGD_SHAPES, cfg, 3)
    b = gc_lib.draw_inits(PSGD_SHAPES, cfg, 3)
    c = gc_lib.draw_inits(PSGD_SHAPES, cfg, 4)
    assert list(a) == ["a_mat", "b_stack"] and a["b_stack"].shape == (48, 4)
    assert all(torch.equal(a[n], b[n]) for n in a)
    assert not any(torch.equal(a[n], c[n]) for n in a)
    assert not torch.equal(a["a_mat"][:4, :], a["b_stack"][:4, :])


# ---------------------------------------------------------------------------
# shardings


def test_shardings_spell_specs_as_dtensor_placements():
    from torch.distributed.tensor import Replicate, Shard
    mesh = Mesh(pod=2, data=2, model=2)
    sh = shd.shardings_for(mesh, {"w": shd.P(("pod", "data"), "model"), "b": shd.P(None)})
    assert sh["w"].placements == (Shard(0), Shard(0), Shard(1))
    assert sh["b"].placements == (Replicate(), Replicate(), Replicate())
    assert sh["b"].trivial and not sh["w"].trivial
    with pytest.raises(ValueError, match="axis order"):
        shd.Sharding(mesh, shd.P(("data", "pod")))
    one = Mesh(data=1, model=1)
    assert shd.Sharding(one, shd.P("data", "model")).trivial
