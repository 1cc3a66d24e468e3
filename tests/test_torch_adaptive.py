"""Adaptive rank allocation (ROADMAP queue 1, item 9) against the JAX
reference ``repro.core.adaptive``.

Both packages factor from the same start matrices: the reference draws
``jax.random.normal(key, (d, r))`` and the port draws it from the same
``key`` (``repro_torch.core.prng``).  Singular values come from each package's LAPACK call
(``jnp.linalg.svd`` / ``torch.linalg.svdvals``), the QR of the power
iteration from LAPACK and from the port's Householder steps.  Limits: ranks
equal; relative errors within ``ERR_ATOL`` (measured at most 4.5e-5, at
``tests/test_adaptive.py``'s rank 4, the others under 1e-6).  The
factors themselves are not compared: 6 sweeps leave the trailing columns of
a rank-32 subspace unconverged, so the two packages' bases differ (A·Bᵀ by
up to 2% of the residual's norm) at the same error.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive as ref  # noqa: E402
from repro.core import quant as ref_quant  # noqa: E402
from repro.core.policy import named_policy as ref_named_policy  # noqa: E402
from repro_torch.core import adaptive, lowrank  # noqa: E402

ERR_ATOL = 1e-4
KEY = jax.random.PRNGKey(0)


@functools.lru_cache(maxsize=None)
def planted_resid(key=KEY, H=6, n=128, d=32) -> np.ndarray:
    """``tests/test_adaptive.py``'s residual: per-head scales and a planted
    rank-4 structure."""
    scale = jnp.logspace(0, 1, H)[:, None, None]
    resid = jax.random.normal(key, (H, n, d)) * scale
    u = jax.random.normal(jax.random.fold_in(key, 1), (H, n, 4))
    v = jax.random.normal(jax.random.fold_in(key, 2), (H, 4, d))
    return np.asarray(resid + 3.0 * scale * (u @ v))


@functools.lru_cache(maxsize=None)
def bench_resid() -> np.ndarray:
    """``benchmarks/bench_adaptive.py``'s residual: heavy-tailed, token-
    correlated KV-like heads on a steep energy profile, minus their kivi2
    quantization."""
    return np.asarray(jax.jit(_bench_resid)(KEY))


def _bench_resid(key, H=8, n=512, d=128):
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = jax.random.normal(k2, (H, n, 16))
    v = jax.random.normal(k3, (H, 16, d))
    chan = 1.0 + 4.0 * jax.random.bernoulli(k4, 0.03, (H, 1, d))
    x = (jax.random.normal(k1, (H, n, d)) + 1.2 * u @ v / 4.0) * chan
    x = x * (1 + 8.0 * jax.random.bernoulli(k5, 0.005, (H, n, d)))
    x = x * jnp.logspace(0, 1.2, H)[:, None, None]
    pol = ref_named_policy("kivi2")
    qt = ref_quant.quantize(x, pol.bits, *pol.scheme_for("k"))
    return x - ref_quant.dequantize(qt)


@pytest.mark.parametrize("case", ["uniform", "energetic", "ties"])
def test_allocate_ranks_matches_reference(case):
    if case == "uniform":        # tests/test_adaptive.py::test_allocation_respects_budget
        spectra = jnp.sort(jax.random.uniform(KEY, (6, 8)), axis=-1)[:, ::-1]
        budget = 24
    elif case == "energetic":
        spectra = jnp.stack([jnp.full((4,), 10.0), jnp.full((4,), 0.1)])
        budget = 4
    else:                        # equal gains: ties go to the lower head-major index
        spectra = jnp.ones((5, 4))
        budget = 7
    want = np.asarray(ref.allocate_ranks(spectra, budget))
    got = adaptive.allocate_ranks(torch.from_numpy(np.asarray(spectra)), budget)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == budget


# ``bench_adaptive.py``'s shape at r 2 only: its reference calls run eagerly (the
# reference's entry point converts to float), ~20 s a case under the suite's
# parallel load; chip_smoke.py holds r 2, 4 and 8 there, card against CPU
CASES = [("test", 2), ("test", 4), ("bench", 2)]


@pytest.mark.parametrize("which,rank", CASES, ids=[f"{w}-r{r}" for w, r in CASES])
def test_adaptive_matches_reference(which, rank):
    resid = planted_resid() if which == "test" else bench_resid()
    want = ref.adaptive_error_vs_uniform(jnp.asarray(resid), rank, key=KEY)
    got = adaptive.adaptive_error_vs_uniform(torch.from_numpy(resid), rank, key=KEY)
    assert got["ranks"] == want["ranks"]
    for k in ("uniform", "adaptive"):
        assert abs(got[k] - want[k]) <= ERR_ATOL, (k, got[k], want[k])
    a, b, ranks = adaptive.adaptive_lowrank(torch.from_numpy(resid), rank, key=KEY)
    assert ranks.tolist() == want["ranks"]
    max_rank = a.shape[-1]
    assert max_rank == min(4 * rank, *resid.shape[1:])
    dead = torch.arange(max_rank)[None, :] >= ranks[:, None]          # columns past rank_h
    assert torch.all(a.permute(0, 2, 1)[dead] == 0) and torch.all(b.permute(0, 2, 1)[dead] == 0)


def test_default_init_is_the_reference_key0_draw():
    resid = torch.from_numpy(planted_resid())
    assert adaptive.adaptive_error_vs_uniform(resid, 2) == \
        adaptive.adaptive_error_vs_uniform(resid, 2, key=KEY)
    with pytest.raises(ValueError):
        lowrank.power_iteration(resid, 4, init=np.zeros((32, 3), np.float32))


# the reference's properties (tests/test_adaptive.py) on the port, table init


def test_allocation_respects_budget():
    spectra = torch.sort(torch.rand(6, 8, generator=torch.Generator().manual_seed(0)),
                         dim=-1, descending=True).values
    ranks = adaptive.allocate_ranks(spectra, budget=24)
    assert int(ranks.sum()) == 24 and int(ranks.max()) <= 8


def test_allocation_prefers_energetic_heads():
    spectra = torch.stack([torch.full((4,), 10.0), torch.full((4,), 0.1)])
    ranks = adaptive.allocate_ranks(spectra, budget=4)
    assert int(ranks[0]) == 4 and int(ranks[1]) == 0


def test_adaptive_never_worse_than_uniform():
    resid = torch.from_numpy(planted_resid())
    res2 = adaptive.adaptive_error_vs_uniform(resid, rank=2)
    assert res2["adaptive"] < 0.8 * res2["uniform"]
    res4 = adaptive.adaptive_error_vs_uniform(resid, rank=4)
    assert res4["adaptive"] <= res4["uniform"] * 1.02 + 1e-6
    bench = torch.from_numpy(bench_resid())
    for r in (2, 4, 8):
        res = adaptive.adaptive_error_vs_uniform(bench, rank=r)
        assert res["adaptive"] <= res["uniform"] + 1e-6
