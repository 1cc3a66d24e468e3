"""The paper's approximation-error API of the port against the JAX reference:
``gear.{decompress_matrix, approx_error}``, the ``size_bytes`` of
``CompressedMatrix`` / ``QuantizedTensor`` / ``SparseOutliers``,
``quant.quant_error`` and ``lowrank.{lowrank_approx, svd_topr}``, also at
head dims and ranks outside the shipped configs' (the start matrix is drawn
for any shape).

Inputs are KV-like tensors made with numpy from fixed seeds (heavy-tailed,
token-correlated, a few large channels and sparse outliers: the recipe of
``benchmarks/common.kv_like``), fed to both packages: at
``benchmarks/bench_error.py``'s shape ``[1, 4, 1024, 128]`` its policies
``METHODS_2BIT + METHODS_4BIT`` on K and on V, ``bench_ablation.py``'s Fig. 4a
asserts, ``quant_error`` and the low-rank pair; at ``[2, 256, 64]`` the Fig.
4a variants against the reference, the ``rank=`` override, the fp16 policy
and the byte count of a quantized tensor.  The reference runs jitted, one
program for every case (its compile time would otherwise dominate this
file's).  Tolerances:

* ``approx_error`` within ``ERR_ATOL`` of the reference's: the two sum the
  norms of ~0.5 M entries in another order (observed: 7.7e-7 at most);
* ``decompress_matrix`` against the reference's ``compress_matrix``, jitted
  as its serving path runs it (its codes then equal the port's bit for bit;
  eager, its division by ``2**bits - 1`` may move a code by one): bit for
  bit without low rank;
  with low rank within ``LOWRANK_FRAC`` of the largest entry of the
  reference's ``A·Bᵀ`` (ROADMAP §3, standing difference c: the bf16 factors
  sit one ulp apart; observed: 1.6e-3 of it at most);
* every ``size_bytes`` equal;
* ``quant_error`` within ``QUANT_ATOL`` (observed: 3.6e-7);
* ``lowrank_approx`` within ``LOWRANK_RTOL`` relative (the factors' f32 sums
  run in another order; observed: 2.2e-5) and ``svd_topr`` within
  ``SVD_RTOL`` relative (two LAPACK-class SVDs; observed: 3.1e-6);
* ``benchmarks/bench_ablation.py``'s Fig. 4a asserts hold on the port's
  numbers, and the port ranks the ten policies in the reference's order.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import gear as jgear  # noqa: E402
from repro.core import lowrank as jlr  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.policy import FP16 as JFP16  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro_torch.core import gear, lowrank, quant  # noqa: E402
from repro_torch.core.policy import FP16, named_policy  # noqa: E402

ERR_ATOL = 1e-5
LOWRANK_FRAC = 1e-2
QUANT_ATOL = 1e-6
LOWRANK_RTOL = 1e-2
SVD_RTOL = 1e-4

METHODS_2BIT = ["per_token_q2", "kivi2", "outlier_kivi2", "gear_l_kivi2", "gear_kivi2"]
METHODS_4BIT = ["per_token_q4", "kcvt4", "kivi4", "gear_l_kcvt4", "gear_kcvt4"]
POLICIES = METHODS_2BIT + METHODS_4BIT
SHAPES = {"bench": (1, 4, 1024, 128), "small": (2, 256, 64)}
RANKS = (1, 2, 8)
HEAD_DIMS = (80, 96, 512)     # approx_error of gear_kcvt4's K on [2, 128, d]
WIDE_RANKS = (3, 64)          # lowrank_approx of the bench residual (d 128)
RANK_POLICY = "gear_kivi2"
# (policy, kind) pairs whose reference error is also taken from approx_error itself
CHECKED = (("kivi2", "v"), ("outlier_kivi2", "k"), ("gear_kcvt4", "k"))
QUANT_CASES = ((2, "per_channel", 64), (2, "per_token", 64), (2, "per_token_group", 64),
               (4, "per_channel", None), (4, "per_token", None), (4, "per_token_group", 128))


def kv_like(shape, seed, outlier_p=0.005, outlier_scale=8.0, corr_rank=16) -> np.ndarray:
    """``benchmarks/common.kv_like``'s recipe on a numpy generator: a normal
    base plus a shared rank-``corr_rank`` token structure, 3% of channels
    scaled 5x, and a fraction ``outlier_p`` of entries scaled by
    ``1 + outlier_scale``; f32."""
    rng = np.random.RandomState(seed)
    *lead, n, d = shape
    base = rng.standard_normal(shape)
    u = rng.standard_normal(tuple(lead) + (n, corr_rank))
    v = rng.standard_normal(tuple(lead) + (corr_rank, d))
    chan = 1.0 + 4.0 * (rng.random_sample(tuple(lead) + (1, d)) < 0.03)
    x = (base + 1.2 * u @ v / corr_rank ** 0.5) * chan
    x = x * (1 + outlier_scale * (rng.random_sample(shape) < outlier_p))
    return x.astype(np.float32)


@functools.lru_cache(maxsize=None)
def x_np(shape_name: str) -> np.ndarray:
    return kv_like(SHAPES[shape_name], seed=0)


@functools.lru_cache(maxsize=None)
def fig4a_input(shape_name: str) -> np.ndarray:
    """``bench_ablation.fig4a_sensitivity``'s input recipe: a strong shared
    low-rank structure with mild outliers, plus twice a second one of rank 4."""
    shape = SHAPES[shape_name]
    return (kv_like(shape, 1, outlier_p=0.003, outlier_scale=5.0, corr_rank=8)
            + 2.0 * kv_like(shape, 2, outlier_p=0.0, corr_rank=4))


def rel_err(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12))


def port_error(x: np.ndarray, pol, kind: str = "k", rank=None) -> float:
    err = gear.approx_error(torch.from_numpy(x), pol, kind, rank)
    assert err.dim() == 0 and err.dtype == torch.float32 and err.device == torch.device("cpu")
    return float(err)


@functools.lru_cache(maxsize=None)
def reference() -> dict:
    """Every reference result this file compares with, from one jitted
    program (one compile in place of one a case: the reference's compile
    time would otherwise dominate this file's):

    * ``policies[name][kind]``: ``compress_matrix`` of the bench input
      (``cm``), its ``decompress_matrix`` (``xh``) and ``A·Bᵀ`` (``low``),
      and the error (``err``): ``approx_error``'s body on that ``cm``, so
      the compression is traced once (``approx_error`` itself, for
      :data:`CHECKED`: ``approx``);
    * ``ranks[r]``: gear_kivi2's (``compress_matrix``, error) of the small
      input's K at ``rank=r``;
    * ``fig4a[variant]``: the error of each Fig. 4a variant on the small
      input of its recipe (at the bench shape its 2-5% sparsities keep 11-26
      entries a channel, whose unrolled selection sweeps took half this
      program's compile time);
    * ``quant[str(case)]``: ``quant_error`` of each case on the bench input;
    * ``lowrank``: kivi2's K residual of the bench input (Fig. 2b) and per
      rank its ``lowrank_approx`` and ``svd_topr``;
    * ``head_dims[d]``: gear_kcvt4's ``approx_error`` of K on
      :func:`head_dim_input` ``(d)``;
    * ``wide_ranks[r]``: ``lowrank_approx`` of that residual at rank r."""
    kivi2 = jnamed("kivi2")

    def error(x, cm):
        """``repro.core.gear.approx_error``'s body on a compressed ``x``."""
        return (jnp.linalg.norm(x - jgear.decompress_matrix(cm))
                / jnp.maximum(jnp.linalg.norm(x), 1e-8))

    def run(bench, small, x4a, *heads):
        out = {"policies": {}}
        for name in POLICIES:
            jpol = jnamed(name)
            out["policies"][name] = {}
            for kind in ("k", "v"):
                cm = jgear.compress_matrix(bench, jpol, kind)
                out["policies"][name][kind] = dict(
                    cm=cm, xh=jgear.decompress_matrix(cm),
                    low=None if cm.a is None else jlr.apply_lowrank(cm.a, cm.b),
                    err=error(bench, cm))
        for name, kind in CHECKED:
            out["policies"][name][kind]["approx"] = jgear.approx_error(bench, jnamed(name), kind)
        rank_pol = jnamed(RANK_POLICY)
        out["ranks"] = {}
        for r in RANKS:
            cm = jgear.compress_matrix(small, rank_pol, "k", r)
            out["ranks"][r] = (cm, error(small, cm))
        out["fig4a"] = {name: jgear.approx_error(x4a, jpol, "k")
                        for name, (jpol, _) in fig4a_variants().items()}
        out["quant"] = {str(case): jquant.quant_error(bench, *case) for case in QUANT_CASES}
        resid = bench - jquant.dequantize(jquant.quantize(bench, kivi2.bits,
                                                          *kivi2.scheme_for("k")))
        out["lowrank"] = (resid, {r: (jlr.lowrank_approx(resid, r), jlr.svd_topr(resid, r))
                                  for r in RANKS})
        out["head_dims"] = {d: jgear.approx_error(x, jnamed("gear_kcvt4"), "k")
                            for d, x in zip(HEAD_DIMS, heads)}
        out["wide_ranks"] = {r: jlr.lowrank_approx(resid, r) for r in WIDE_RANKS}
        return out
    return jax.jit(run)(*(jnp.asarray(a) for a in (x_np("bench"), x_np("small"),
                                                   fig4a_input("small"))),
                        *(jnp.asarray(head_dim_input(d)) for d in HEAD_DIMS))


@functools.lru_cache(maxsize=None)
def head_dim_input(d: int) -> np.ndarray:
    return kv_like((2, 128, d), seed=0)


@pytest.mark.parametrize("kind", ["k", "v"])
@pytest.mark.parametrize("polname", POLICIES)
def test_approx_error_matches_reference(polname, kind):
    """On the bench input."""
    ref = float(reference()["policies"][polname][kind]["err"])
    port = port_error(x_np("bench"), named_policy(polname), kind)
    assert 0 < port < 1
    assert abs(port - ref) <= ERR_ATOL, (ref, port)


@pytest.mark.parametrize("polname, kind", CHECKED)
def test_reference_error_is_its_approx_error(polname, kind):
    """The reference errors above are ``approx_error``'s body on the
    reference's own compressed matrix: equal to ``approx_error`` itself."""
    out = reference()["policies"][polname][kind]
    assert float(out["err"]) == float(out["approx"])


@pytest.mark.parametrize("kind", ["k", "v"])
@pytest.mark.parametrize("polname", POLICIES)
def test_decompress_matrix_and_size_bytes_match_reference(polname, kind):
    """On the bench input."""
    x, pol = x_np("bench"), named_policy(polname)
    out = reference()["policies"][polname][kind]
    ref = out["cm"]
    port = gear.compress_matrix(torch.from_numpy(x), pol, kind)
    assert port.size_bytes() == ref.size_bytes()
    assert port.qt.size_bytes() == ref.qt.size_bytes()
    assert port.qt.nbytes_packed == ref.qt.nbytes_packed
    assert (port.sparse is None) == (ref.sparse is None)
    if ref.sparse is not None:
        assert port.sparse.size_bytes() == ref.sparse.size_bytes()
    want = np.asarray(out["xh"])
    got = gear.decompress_matrix(port)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    if not pol.use_lowrank:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        low = np.asarray(out["low"])
        gap = np.abs(got.numpy() - want).max()
        assert gap <= LOWRANK_FRAC * np.abs(low).max(), (gap, np.abs(low).max())
    assert gear.decompress_matrix(port, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("rank", RANKS)
def test_rank_override_matches_reference(rank):
    """``rank=`` overrides the policy's rank (the engine's ``rank_decode``):
    the error and the compressed size follow the reference's."""
    x = x_np("small")
    jcm, ref = reference()["ranks"][rank]
    port = port_error(x, named_policy(RANK_POLICY), "k", rank)
    assert abs(port - float(ref)) <= ERR_ATOL, (float(ref), port)
    cm = gear.compress_matrix(torch.from_numpy(x), named_policy(RANK_POLICY), "k", rank)
    assert cm.a.shape[-1] == rank and cm.size_bytes() == jcm.size_bytes()


def test_fp16_policy_gives_zero():
    x = x_np("small")
    for kind in ("k", "v"):
        assert float(jgear.approx_error(jnp.asarray(x), JFP16, kind)) == 0.0
        assert port_error(x, FP16, kind) == 0.0


def test_port_ranks_the_policies_as_the_reference():
    """bench_error.py's Fig. 1a table (K, the bench shape): the port orders
    the ten policies as the reference does, and at this input the orderings
    that bench_error.py asserts hold on the port's numbers."""
    ref = {p: float(reference()["policies"][p]["k"]["err"]) for p in POLICIES}
    port = {p: port_error(x_np("bench"), named_policy(p)) for p in POLICIES}
    assert sorted(POLICIES, key=port.get) == sorted(POLICIES, key=ref.get)
    assert port["gear_kivi2"] < port["gear_l_kivi2"] < port["kivi2"] < port["per_token_q2"]
    assert port["outlier_kivi2"] < port["kivi2"]


# ---------------------------------------------------------------------------
# bench_ablation.py's Fig. 4a variants


def fig4a_variants() -> dict:
    """The policies of ``fig4a_sensitivity``, by name, as (reference, port)."""
    out = {}
    for named, side in ((jnamed, 0), (named_policy, 1)):
        base = named("gear_kivi2")
        for s in (0.0, 0.01, 0.02, 0.05):
            out.setdefault(f"s={s}", [None, None])[side] = dataclasses.replace(
                base, sparsity=max(s, 1e-9), method="gear" if s > 0 else "gear_l")
        for r in (0, 2, 4, 8):
            out.setdefault(f"r={r}", [None, None])[side] = dataclasses.replace(
                base, rank=max(r, 1), method="gear" if r > 0 else "outlier_quant")
        out.setdefault("no_sparse", [None, None])[side] = dataclasses.replace(base, method="gear_l")
    return out


@pytest.mark.parametrize("variant", list(fig4a_variants()))
def test_fig4a_variant_matches_reference(variant):
    ref = float(reference()["fig4a"][variant])
    port = port_error(fig4a_input("small"), fig4a_variants()[variant][1])
    assert abs(port - ref) <= ERR_ATOL, (ref, port)


def test_fig4a_asserts_hold_on_the_port():
    """``fig4a_sensitivity``'s asserts on the port's numbers: both components
    help and together they are best, and neither single ablation is 1.5x the
    other."""
    x = torch.from_numpy(fig4a_input("bench"))
    variants = fig4a_variants()
    err = {name: float(gear.approx_error(x, variants[name][1], "k"))
           for name in ("r=4", "r=0", "no_sparse")}
    e_full, e_norank, e_nosparse = err["r=4"], err["r=0"], err["no_sparse"]
    assert e_full < min(e_norank, e_nosparse)
    assert max(e_norank, e_nosparse) < 1.5 * min(e_norank, e_nosparse)


# ---------------------------------------------------------------------------
# quant_error, lowrank_approx and svd_topr


@pytest.mark.parametrize("bits,scheme,group", QUANT_CASES)
def test_quant_error_matches_reference(bits, scheme, group):
    ref = float(reference()["quant"][str((bits, scheme, group))])
    port = quant.quant_error(torch.from_numpy(x_np("bench")), bits, scheme, group)
    assert port.dim() == 0
    assert abs(float(port) - ref) <= QUANT_ATOL, (ref, float(port))


def test_quantized_tensor_size_bytes_counts_two_bytes_a_stat():
    """The reference's count whatever dtype the stats are held in: 4 bytes a
    packed int32 word, 2 a scale and 2 a zero ([2, 256, 64] at 2 bits in
    groups of 64 tokens: 2 x 256 x 4 words, 2 x 4 x 64 scales)."""
    x = torch.from_numpy(x_np("small"))
    for sd in ("float32", "bfloat16"):
        qt = quant.quantize(x, 2, "per_channel", 64, stat_dtype=sd)
        assert qt.size_bytes() == 2 * 256 * 4 * 4 + 2 * (2 * 4 * 64) * 2


def lowrank_reference() -> tuple:
    """(kivi2's K residual, {rank: (lowrank_approx, svd_topr)}) as numpy."""
    r, out = reference()["lowrank"]
    return np.array(r), {rank: tuple(np.asarray(a) for a in pair) for rank, pair in out.items()}


@pytest.mark.parametrize("rank", RANKS)
def test_lowrank_approx_matches_reference(rank):
    r, out = lowrank_reference()
    got = lowrank.lowrank_approx(torch.from_numpy(r), rank)
    assert got.dtype == torch.float32
    assert rel_err(out[rank][0], got.numpy()) <= LOWRANK_RTOL


@pytest.mark.parametrize("rank", RANKS)
def test_svd_topr_matches_reference(rank):
    r, out = lowrank_reference()
    got = lowrank.svd_topr(torch.from_numpy(r), rank)
    assert rel_err(out[rank][1], got.numpy()) <= SVD_RTOL
    # the power iteration's approximation is no better than the exact one
    pi = lowrank.lowrank_approx(torch.from_numpy(r), rank)
    assert rel_err(r, got.numpy()) <= rel_err(r, pi.numpy())


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_approx_error_at_any_head_dim(d):
    """Head dims no shipped config has (the port once raised ``KeyError``
    for want of a start matrix)."""
    ref = float(reference()["head_dims"][d])
    port = port_error(head_dim_input(d), named_policy("gear_kcvt4"), "k")
    assert abs(port - ref) <= ERR_ATOL, (ref, port)


@pytest.mark.parametrize("rank", WIDE_RANKS)
def test_lowrank_approx_at_any_rank(rank):
    """Ranks no shipped policy has: the approximation's error within
    ``ERR_ATOL`` of the reference's (observed: 0 at rank 3, 3.9e-6 at rank
    64, whose trailing columns 4 sweeps leave unconverged), the
    approximation within ``LOWRANK_RTOL`` (observed: 2.8e-6 / 2.0e-3)."""
    r, _ = lowrank_reference()
    want = np.asarray(reference()["wide_ranks"][rank])
    got = lowrank.lowrank_approx(torch.from_numpy(r), rank).numpy()
    assert abs(rel_err(r, got) - rel_err(r, want)) <= ERR_ATOL
    assert rel_err(want, got) <= LOWRANK_RTOL
