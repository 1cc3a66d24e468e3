"""The port's counter-based PRNG (``repro_torch.core.prng``) against
``jax.random``, and the reference's ``key`` parameters of the port.

The stream: keys (``PRNGKey``, ``fold_in``, ``split`` chains), ``bits`` and
``uniform`` at odd shapes, ``normal`` (f32: XLA's ``erf_inv`` / ``log1p`` /
``log`` emulated), ``gumbel`` and ``categorical``, at keys 0, 1 and
``fold_in(PRNGKey(3), 2**31 + 5)``, all bit for bit (``normal``: 3.2 M
draws exact when this file was written, against jax 0.9's XLA on the CPU).
``categorical`` rows whose two best perturbed scores lie within
``CATEGORICAL_MARGIN`` would be exempt and are counted; none occur here.

The ``key`` parameters: every function of the port that takes the
reference's ``key`` (the power iteration's start matrix) is run under a
non-zero key against the reference under the same key, within the
tolerance its existing test holds it to, and its result must move with the
key by more than that tolerance (else the comparison could not tell a key
that is ignored).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import adaptive as jadaptive  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core import gear as jgear  # noqa: E402
from repro.core import lowrank as jlr  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro_torch.core import adaptive, cache, gear, lowrank, prng  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402

CATEGORICAL_MARGIN = 1e-5
# A·Bᵀ of the compressed chunks (tests/test_torch_core.py, test_torch_paged.py,
# test_torch_streaming.py, test_torch_serving_api.py)
AB_RTOL = 1e-2
PI_RTOL = 1e-4          # power_iteration's A·Bᵀ (tests/test_torch_core.py)
ADAPTIVE_ATOL = 1e-4    # adaptive errors (tests/test_torch_adaptive.py)
KEY = jax.random.PRNGKey(7)


def ref_keys() -> dict:
    return {"key0": jax.random.PRNGKey(0), "key1": jax.random.PRNGKey(1),
            "folded": jax.random.fold_in(jax.random.PRNGKey(3), 2 ** 31 + 5)}


def port_keys() -> dict:
    return {"key0": prng.PRNGKey(0), "key1": prng.PRNGKey(1),
            "folded": prng.fold_in(prng.PRNGKey(3), 2 ** 31 + 5)}


KEY_NAMES = list(ref_keys())
ODD_SHAPES = [(), (1,), (7,), (3, 5, 11), (2, 1, 129), (1, 32000)]


def as_f32_bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", KEY_NAMES)
def test_keys_match_reference(name):
    """``PRNGKey``, ``fold_in`` and ``split`` chains, word for word."""
    rk, pk = ref_keys()[name], port_keys()[name]
    np.testing.assert_array_equal(pk, np.asarray(rk))
    assert pk.dtype == np.uint32 and pk.shape == (2,)
    for n in (0, 7, 2 ** 32 - 1):
        rk, pk = jax.random.fold_in(rk, n), prng.fold_in(pk, n)
        np.testing.assert_array_equal(pk, np.asarray(rk))
    rs, ps = jax.random.split(rk, 5), prng.split(pk, 5)
    np.testing.assert_array_equal(ps, np.asarray(rs))
    np.testing.assert_array_equal(prng.split(ps[3]), np.asarray(jax.random.split(rs[3])))
    for seed in (-1, 2 ** 31 + 5, 2 ** 32 + 7):
        np.testing.assert_array_equal(prng.PRNGKey(seed), np.asarray(jax.random.PRNGKey(seed)))
    with pytest.raises(OverflowError):
        prng.fold_in(pk, 2 ** 32)


@pytest.mark.parametrize("shape", ODD_SHAPES, ids=str)
@pytest.mark.parametrize("name", KEY_NAMES)
def test_bits_and_uniform_match_reference(name, shape):
    rk, pk = ref_keys()[name], port_keys()[name]
    want = np.asarray(jax.random.bits(rk, shape)).astype(np.int64)
    got = prng.bits(pk, shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)
    for lo, hi in ((0.0, 1.0), (-0.5, 2.0), (1e-6, 1.0)):
        want = np.asarray(jax.random.uniform(rk, shape, jnp.float32, lo, hi))
        got = prng.uniform(pk, shape, lo, hi)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(as_f32_bits(got.numpy()), as_f32_bits(want))


def test_host_path_is_the_cpu_torch_path():
    """``device=None`` draws on the host's CPU: the same tensors as an
    explicit CPU device (the card's draw is held to it in chip_smoke.py)."""
    pk = port_keys()["folded"]
    for fn in (prng.bits, prng.normal, prng.gumbel):
        a, b = fn(pk, (3, 77)), fn(pk, (3, 77), torch.device("cpu"))
        assert a.device == b.device == torch.device("cpu")
        assert torch.equal(a, b)
    a, b = prng.uniform(pk, (5, 9), -2.0, 3.0), prng.uniform(pk, (5, 9), -2.0, 3.0, "cpu")
    assert torch.equal(a, b)


NORMAL_SHAPES = [(128, 4), (80, 3), (96, 4), (48, 4), (512, 64), (1 << 18,)]


@pytest.mark.parametrize("name", KEY_NAMES)
def test_normal_matches_reference_bit_for_bit(name):
    """f32 ``normal``: exact share 1.0 (no element within 2 ulps but off)."""
    rk, pk = ref_keys()[name], port_keys()[name]
    total = exact = 0
    for shape in NORMAL_SHAPES:
        want = as_f32_bits(jax.random.normal(rk, shape, jnp.float32))
        got = as_f32_bits(prng.normal(pk, shape).numpy())
        ulps = np.abs(want.astype(np.int64) - got.astype(np.int64))
        assert ulps.max() <= 2, (shape, int(ulps.max()))
        total, exact = total + want.size, exact + int((ulps == 0).sum())
    assert exact == total, f"exact share {exact / total}"


def test_normal_bf16_matches_reference():
    """The VLM batches' ``img_embeds`` draw."""
    for name in KEY_NAMES:
        want = np.asarray(jax.random.normal(ref_keys()[name], (3, 17, 40), jnp.bfloat16)
                          .astype(jnp.float32))
        got = prng.normal_bf16(port_keys()[name], (3, 17, 40))
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("name", KEY_NAMES)
def test_gumbel_matches_reference_bit_for_bit(name):
    rk, pk = ref_keys()[name], port_keys()[name]
    for shape in ((4, 32000), (3, 2, 50), (1 << 18,)):
        want = as_f32_bits(jax.random.gumbel(rk, shape, jnp.float32))
        np.testing.assert_array_equal(as_f32_bits(prng.gumbel(pk, shape).numpy()), want)


def test_log_emulation_edge_values():
    """0, denormals (XLA flushes them: -inf), 1, inf, negatives and NaN as
    XLA's ``log`` / ``log1p`` (NaN compared as NaN: XLA's has its sign bit
    set)."""
    x = np.array([0.0, 1e-45, 1e-40, 1.1754944e-38, 0.5, 1.0, 3.0, 1e30, np.inf, -1.0,
                  np.nan], np.float32)
    np.testing.assert_array_equal(prng._log(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(x)))
    y = np.array([-1.0, -0.9999999, -0.5, -0.4142, -1e-8, 0.0, 1e-8, 0.4142, 3.0, np.inf],
                 np.float32)
    np.testing.assert_array_equal(as_f32_bits(prng._log1p(torch.from_numpy(y)).numpy()),
                                  as_f32_bits(jax.jit(jnp.log1p)(y)))


@pytest.mark.parametrize("name", KEY_NAMES)
def test_categorical_matches_reference(name):
    """Equal ids on identical logits except rows whose two best perturbed
    scores lie within ``CATEGORICAL_MARGIN`` (counted: 0 here); a row of
    -1e30 masks, a batch of audio-like [B, K, V] logits."""
    rk, pk = ref_keys()[name], port_keys()[name]
    rng = np.random.RandomState(3)
    for shape in ((64, 1000), (2, 4, 257)):
        logits = (rng.randn(*shape) * 3).astype(np.float32)
        logits[0, ..., 5:] = -1e30
        want = np.asarray(jax.random.categorical(rk, jnp.asarray(logits)))
        got = prng.categorical(pk, torch.from_numpy(logits)).numpy()
        scores = np.asarray(jax.random.gumbel(rk, shape, jnp.float32)) + logits
        top2 = np.sort(scores, axis=-1)[..., -2:]
        near = top2[..., 1] - top2[..., 0] <= CATEGORICAL_MARGIN
        assert (got[~near] == want[~near]).all()
        assert int(near.sum()) == 0


# ---------------------------------------------------------------------------
# the reference's key parameters


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def bf16(shape, seed):
    return jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32)
                       ).astype(jnp.bfloat16)


def t(x) -> torch.Tensor:
    return torch.from_numpy(to_np(x)).to(torch.bfloat16)


def rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def products(c, paged=False) -> np.ndarray:
    """A·Bᵀ of every closed chunk's K and V factors, [2, ..., nb, Dh]."""
    out = []
    for kv in ("k", "v"):
        a, b = to_np(getattr(c, f"{kv}_a")), to_np(getattr(c, f"{kv}_b"))
        if paged:
            b = b[:, :, 0]
        else:
            B, H, S, r = a.shape
            a = a.reshape(B, H, b.shape[2], S // b.shape[2], r)
        out.append(a @ np.swapaxes(b, -1, -2))
    return np.stack(out)


CCFG = dict(kv_heads=2, head_dim=64, capacity=128)


def cfgs(B=2, polname="gear_kcvt4"):
    return (jcache.CacheConfig(batch=B, policy=jnamed(polname), **CCFG),
            cache.CacheConfig(batch=B, policy=named_policy(polname), **CCFG))


def case_compress_matrix():
    x = np.array(bf16((2, 2, 64, 64), 0).astype(jnp.float32))

    def ab(cm):
        return to_np(cm.a) @ np.swapaxes(to_np(cm.b), -1, -2)
    ref = jax.jit(lambda a: jgear.compress_matrix(a, jnamed("gear_kcvt4"), "k", key=KEY))(x)
    return ab(ref), lambda key: ab(gear.compress_matrix(
        torch.from_numpy(x), named_policy("gear_kcvt4"), "k", key=key)), AB_RTOL


def case_power_iteration():
    x = np.random.RandomState(1).randn(3, 2, 64, 32).astype(np.float32)
    a, b = jax.jit(lambda v: jlr.power_iteration(v, 4, 2, KEY))(x)
    return (to_np(a) @ np.swapaxes(to_np(b), -1, -2),
            lambda key: lowrank.apply_lowrank(
                *lowrank.power_iteration(torch.from_numpy(x), 4, 2, key)).numpy(), PI_RTOL)


def case_lowrank_approx():
    x = np.random.RandomState(2).randn(2, 128, 48).astype(np.float32)
    ref = jax.jit(lambda v: jlr.lowrank_approx(v, 3, 2, KEY))(x)
    return (np.asarray(ref),
            lambda key: lowrank.lowrank_approx(torch.from_numpy(x), 3, 2, key).numpy(), AB_RTOL)


def _resid():
    rng = np.random.RandomState(4)
    return (rng.randn(4, 64, 32) * np.logspace(0, 1, 4)[:, None, None]).astype(np.float32)


def case_adaptive_lowrank():
    x = _resid()
    a, b, ranks = jadaptive.adaptive_lowrank(jnp.asarray(x), 2, iters=2, key=KEY)

    def port(key):
        pa, pb, pranks = adaptive.adaptive_lowrank(torch.from_numpy(x), 2, iters=2, key=key)
        np.testing.assert_array_equal(pranks.numpy(), np.asarray(ranks))
        return lowrank.apply_lowrank(pa, pb).numpy()
    return to_np(a) @ np.swapaxes(to_np(b), -1, -2), port, PI_RTOL


def case_adaptive_error_vs_uniform():
    x = _resid()
    want = jadaptive.adaptive_error_vs_uniform(jnp.asarray(x), 1, key=KEY)
    w = np.array([want["uniform"], want["adaptive"]])

    def port(key):
        got = adaptive.adaptive_error_vs_uniform(torch.from_numpy(x), 1, key=key)
        assert got["ranks"] == want["ranks"]
        return np.array([got["uniform"], got["adaptive"]])
    # the errors' gap within the adaptive tests' atol: a relative limit of that
    # atol over the errors' norm
    return w, port, ADAPTIVE_ATOL / np.linalg.norm(w)


def case_prefill_layer_cache():
    jcfg, pcfg = cfgs()
    k, v = bf16((2, 2, 100, 64), 0), bf16((2, 2, 100, 64), 1)
    ref = jax.jit(lambda a, b: jcache.prefill_layer_cache(
        jcfg, jcache.init_layer_cache(jcfg), a, b, KEY))(k, v)
    return products(ref), lambda key: products(cache.prefill_layer_cache(
        pcfg, cache.init_layer_cache(pcfg, device="cpu"), t(k), t(v), key)), AB_RTOL


def case_streaming_prefill_layer_cache():
    jcfg, pcfg = cfgs(B=1)
    q, k, v = bf16((1, 4, 100, 64), 2), bf16((1, 2, 100, 64), 3), bf16((1, 2, 100, 64), 4)
    ref, _ = jax.jit(lambda a, b, c: jcache.streaming_prefill_layer_cache(
        jcfg, jcache.init_layer_cache(jcfg), a, b, c, 0.125, KEY))(q, k, v)
    return products(ref), lambda key: products(cache.streaming_prefill_layer_cache(
        pcfg, cache.init_layer_cache(pcfg, device="cpu"), t(q), t(k), t(v), 0.125,
        key=key)[0]), AB_RTOL


def _port_leaves(tree, kind):
    """The port's twin of a reference cache tree, leaf by leaf."""
    def leaf(x):
        return t(x) if x.dtype == jnp.bfloat16 else torch.from_numpy(np.array(x))
    return kind(**{f: None if getattr(tree, f) is None else leaf(getattr(tree, f))
                   for f in cache.FIELDS})


def case_append_token():
    jcfg, pcfg = cfgs()
    lengths = np.array([63, 127])
    full = dataclasses.replace(jcache.init_layer_cache(jcfg),
                               length=jnp.asarray(lengths, jnp.int32),
                               buf_k=bf16((2, 2, 64, 64), 5), buf_v=bf16((2, 2, 64, 64), 6))
    kt, vt = bf16((2, 2, 64), 7), bf16((2, 2, 64), 8)
    ref = jax.jit(lambda c, a, b: jcache.append_token(jcfg, c, a, b, KEY))(full, kt, vt)

    def port(key):
        c = _port_leaves(full, cache.GEARLayerCache)
        return products(cache.append_token(pcfg, c, t(kt), t(vt), lengths, key))
    return products(ref), port, AB_RTOL


def case_append_token_paged():
    jcfg, pcfg = cfgs()
    bt = np.array([[3, 1], [0, 2]], np.int32)
    lengths = np.array([127, 63])
    jp = dataclasses.replace(jcache.init_paged_layer_cache(jcfg, 4),
                             length=jnp.asarray(lengths, jnp.int32),
                             buf_k=bf16((2, 2, 64, 64), 9), buf_v=bf16((2, 2, 64, 64), 10))
    kt, vt = bf16((2, 2, 64), 11), bf16((2, 2, 64), 12)
    ref = jax.jit(lambda c, a, b: jcache.append_token_paged(jcfg, c, jnp.asarray(bt), a, b,
                                                            KEY))(jp, kt, vt)

    def port(key):
        pp = _port_leaves(jp, cache.PagedGEARLayerCache)
        cache.append_token_paged(pcfg, pp, bt, t(kt), t(vt), lengths, key)
        return products(pp, paged=True)
    return products(ref, paged=True), port, AB_RTOL


def case_prefill_into_slot():
    jcfg, pcfg = cfgs()
    k, v = bf16((1, 2, 100, 64), 13), bf16((1, 2, 100, 64), 14)
    ref = jax.jit(lambda a, b: jcache.prefill_into_slot(
        jcfg, jcache.init_layer_cache(jcfg), a, b, 1, KEY))(k, v)
    return products(ref)[:, 1], lambda key: products(cache.prefill_into_slot(
        pcfg, cache.init_layer_cache(pcfg, device="cpu"), t(k), t(v), 1, key))[:, 1], AB_RTOL


KEY_CASES = {name[len("case_"):]: fn for name, fn in list(globals().items())
             if name.startswith("case_")}


@pytest.mark.parametrize("fn", list(KEY_CASES))
def test_key_picks_the_reference_start_matrix(fn):
    """Under ``PRNGKey(7)`` the port's result is the reference's under the
    same key, within the function's tolerance; under ``key=None`` (key 0)
    it is further from it than that, so the key is not ignored."""
    want, port, rtol = KEY_CASES[fn]()
    got, got0 = port(np.asarray(KEY)), port(None)
    assert rel(got, want) <= rtol, (fn, rel(got, want))
    assert rel(got0, want) > rtol, (fn, rel(got0, want))
