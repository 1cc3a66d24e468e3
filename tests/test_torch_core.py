"""Parity of the PyTorch port's compression core with the JAX reference.

Inputs come from numpy seeds and go through both packages; the JAX side
runs jitted, as its serving path does.  Tolerances:

* packing: bit-equal words;
* quantization: scale and zero exact; codes within ±1 on at most 0.1% of
  entries (the budget of ``test_kernels.py::test_quant_pack_sweep``);
* outliers: indices and values exact, in ``lax.top_k`` order;
* power iteration: ``A·Bᵀ`` within 1e-4 relative (QR column signs may
  differ between LAPACK builds, so never A and B alone);
* layer caches from identical K/V: every leaf under the rules above, and
  bf16 low-rank factors through ``A·Bᵀ`` within 1e-2 relative.

Also the package guards: the port imports with JAX blocked, and no file of
it (nor ``chip_smoke.py``) imports JAX or the reference package.
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as jcache  # noqa: E402
from repro.core import gear as jgear  # noqa: E402
from repro.core import lowrank as jlr  # noqa: E402
from repro.core import outlier as jol  # noqa: E402
from repro.core import packing as jpack  # noqa: E402
from repro.core import quant as jquant  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro_torch.core import cache, gear, lowrank, outlier, packing, quant  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def to_np(x) -> np.ndarray:
    """jax or torch array -> numpy (bf16 widened to f32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def bf16_np(shape, seed, scale=1.0) -> np.ndarray:
    """Random values exactly representable in bf16, as f32 numpy."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32) * scale
    return to_np(jnp.asarray(x).astype(jnp.bfloat16))


def assert_codes_close(pk_ref, pk_port, bits, d):
    a = np.asarray(jpack.unpack(jnp.asarray(to_np(pk_ref)), bits, d))
    b = packing.unpack(to_t(to_np(pk_port)), bits, d).numpy()
    diff = np.abs(a.astype(np.int64) - b)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


def rel_err(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-12))


# ---------------------------------------------------------------------------
# packing / quant / outliers / power iteration


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_packing_bit_equal(bits):
    codes = np.random.RandomState(bits).randint(0, 2**bits, size=(3, 5, 64)).astype(np.int32)
    ref = np.asarray(jpack.pack(jnp.asarray(codes), bits))
    port = packing.pack(to_t(codes), bits)
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    assert (ref < 0).any()                     # words with the top bit set round-trip too
    np.testing.assert_array_equal(packing.unpack(to_t(ref), bits).numpy(), codes)


@pytest.mark.parametrize("scheme,group", [("per_channel", None), ("per_token", None),
                                          ("per_channel", 16), ("per_token", 16),
                                          ("per_token_group", 16)])
@pytest.mark.parametrize("bits", [2, 4])
def test_quantize_matches_reference(scheme, group, bits):
    x = bf16_np((2, 3, 64, 32), seed=bits)
    fn = jax.jit(lambda a: jquant.quantize(a, bits, scheme, group, stat_dtype=jnp.bfloat16))
    ref = fn(jnp.asarray(x))
    port = quant.quantize(to_t(x), bits, scheme, group, stat_dtype="bfloat16")
    np.testing.assert_array_equal(to_np(port.scale), to_np(ref.scale))
    np.testing.assert_array_equal(to_np(port.zero), to_np(ref.zero))
    assert_codes_close(ref.packed, port.packed, bits, 32)
    deq_ref = np.asarray(jquant.dequantize(ref))
    port_same = quant.QuantizedTensor(to_t(to_np(ref.packed)), port.scale, port.zero,
                                      bits, port.scheme, port.group, port.n, port.d)
    np.testing.assert_array_equal(quant.dequantize(port_same).numpy(), deq_ref)


def test_iterative_topk_matches_lax_top_k():
    x = np.random.RandomState(0).randint(-3, 4, size=(4, 5, 33)).astype(np.float32)  # many ties
    for k in (1, 2, 3):
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        pv, pi = outlier.iterative_topk(to_t(x), k)
        np.testing.assert_array_equal(pv.numpy(), np.asarray(rv))
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("axis", ["token", "channel"])
@pytest.mark.parametrize("k", [1, 2])
def test_filter_outliers_matches_reference(axis, k):
    x = bf16_np((2, 3, 64, 32), seed=k)
    x[0, 0, :, 3] = 3.0            # constant channel (token axis: one index chosen twice)
    x[0, 1, 7, :] = -2.0           # constant token (channel axis)
    sp_r, rem_r = jol.filter_outliers_k(jnp.asarray(x), k, axis)
    sp_p, rem_p = outlier.filter_outliers_k(to_t(x), k, axis)
    np.testing.assert_array_equal(sp_p.indices.numpy(), np.asarray(sp_r.indices))
    np.testing.assert_array_equal(sp_p.values.numpy(), np.asarray(sp_r.values))
    np.testing.assert_array_equal(rem_p.numpy(), np.asarray(rem_r))
    np.testing.assert_array_equal(outlier.densify(sp_p).numpy(), np.asarray(jol.densify(sp_r)))
    idx = sp_p.indices.numpy()
    assert (idx[..., 0] == idx[..., k]).any()  # the duplicate-index case is exercised


def test_power_iteration_init_table_pins_jax_draw():
    """The start matrix is the reference's ``jax.random.normal(PRNGKey(0),
    (d, r))`` bit for bit: at the shapes of the table the port once shipped,
    and at shapes it lacked (d 48 once raised ``KeyError``)."""
    for d in (16, 32, 48, 64, 128, 256):
        for r in (1, 2, 3, 4, 8, 16):
            ref = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (d, r), jnp.float32))
            np.testing.assert_array_equal(lowrank.pi_init(d, r), ref)


@pytest.mark.parametrize("n,d,rank", [(64, 16, 2), (64, 64, 4), (32, 128, 4)])
def test_power_iteration_matches_reference(n, d, rank):
    x = np.random.RandomState(d).randn(3, 2, n, d).astype(np.float32)
    a_r, b_r = jax.jit(lambda t: jlr.power_iteration(t, rank, 4))(jnp.asarray(x))
    a_p, b_p = lowrank.power_iteration(to_t(x), rank, 4)
    ref = np.asarray(jnp.einsum("...nr,...dr->...nd", a_r, b_r))
    port = lowrank.apply_lowrank(a_p, b_p).numpy()
    assert rel_err(ref, port) < 1e-4


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("kind", ["k", "v"])
def test_compress_matrix_matches_reference(polname, kind):
    x = bf16_np((2, 2, 64, 64), seed=3)
    x[0, 0, :, 1] = 1.5
    jpol, pol = jnamed(polname), named_policy(polname)
    ref = jax.jit(lambda t: jgear.compress_matrix(t, jpol, kind, rank=2))(jnp.asarray(x))
    port = gear.compress_matrix(to_t(x), pol, kind, rank=2)
    np.testing.assert_array_equal(to_np(port.qt.scale), to_np(ref.qt.scale))
    np.testing.assert_array_equal(to_np(port.qt.zero), to_np(ref.qt.zero))
    assert_codes_close(ref.qt.packed, port.qt.packed, pol.bits, 64)
    np.testing.assert_array_equal(port.sparse.indices.numpy(), np.asarray(ref.sparse.indices))
    np.testing.assert_array_equal(port.sparse.values.numpy(), np.asarray(ref.sparse.values))
    ab_r = to_np(ref.a) @ np.swapaxes(to_np(ref.b), -1, -2)
    ab_p = to_np(port.a) @ np.swapaxes(to_np(port.b), -1, -2)
    assert rel_err(ab_r, ab_p) < 1e-2


# ---------------------------------------------------------------------------
# layer caches


def port_cache(jc_cache) -> "cache.GEARLayerCache":
    """The port's twin of a JAX GEARLayerCache (leaf by leaf, same dtype)."""
    leaves = {}
    for f in cache.FIELDS:
        x = getattr(jc_cache, f)
        if x is None:
            leaves[f] = None
            continue
        t = to_t(to_np(x))
        leaves[f] = t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t
    return cache.GEARLayerCache(**leaves)


def assert_caches_match(ccfg, ref, port):
    """Leaf-by-leaf comparison under the stated rules."""
    pol = ccfg.policy
    Dh, nb = ccfg.head_dim, ccfg.chunk
    for f in cache.FIELDS:
        r, p = getattr(ref, f), getattr(port, f)
        assert (r is None) == (p is None), f
        if r is None:
            continue
        assert tuple(p.shape) == tuple(r.shape), f
        assert str(p.dtype).split(".")[-1] == str(r.dtype), f
        if f.endswith("_packed"):
            assert_codes_close(r, p, pol.bits, Dh)
        elif f.endswith(("_a", "_b")):
            continue                                     # compared through A·Bᵀ below
        else:
            np.testing.assert_array_equal(to_np(p), to_np(r), err_msg=f)
    if pol.use_lowrank:
        for kv in ("k", "v"):
            B, H, S, rank = getattr(ref, f"{kv}_a").shape
            C = S // nb

            def ab(c, kv=kv, B=B, H=H, C=C, rank=rank):
                a = to_np(getattr(c, f"{kv}_a")).reshape(B, H, C, nb, rank)
                return a @ np.swapaxes(to_np(getattr(c, f"{kv}_b")), -1, -2)
            assert rel_err(ab(ref), ab(port)) < 1e-2, kv


def cache_cfgs(polname, B=2, H=2, Dh=64, S=128):
    j = jcache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S, policy=jnamed(polname))
    p = cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                          policy=named_policy(polname))
    return j, p


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_prefill_layer_cache_matches_reference(polname):
    jcfg, pcfg = cache_cfgs(polname)
    k, v = bf16_np((2, 2, 100, 64), 0), bf16_np((2, 2, 100, 64), 1)
    k[1, 0, :64, 9] = 2.5                                  # constant channel in chunk 0
    fill = jax.jit(lambda a, b: jcache.prefill_layer_cache(
        jcfg, jcache.init_layer_cache(jcfg), a, b))
    ref = fill(jnp.asarray(k).astype(jnp.bfloat16), jnp.asarray(v).astype(jnp.bfloat16))
    port = cache.prefill_layer_cache(pcfg, cache.init_layer_cache(pcfg, device="cpu"),
                                     to_t(k).to(torch.bfloat16), to_t(v).to(torch.bfloat16))
    assert_caches_match(pcfg, ref, port)


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_append_token_matches_reference(polname):
    """From identical ragged caches (slot lengths 63, 100, 127, random
    buffer rows), three appends: slot 0 closes chunk 0 on the first, slot 2
    closes chunk 1 (the last one the capacity holds), slot 1 closes none."""
    jcfg, pcfg = cache_cfgs(polname, B=3)
    kv = [jnp.asarray(bf16_np((3, 2, 128, 64), i)).astype(jnp.bfloat16) for i in range(2)]
    full = jax.jit(lambda a, b: jcache.prefill_layer_cache(
        jcfg, jcache.init_layer_cache(jcfg), a, b))(*kv)
    lengths = np.array([63, 100, 127])
    full = dataclasses.replace(
        full, length=jnp.asarray(lengths, jnp.int32),
        buf_k=jnp.asarray(bf16_np((3, 2, 64, 64), 7)).astype(jnp.bfloat16),
        buf_v=jnp.asarray(bf16_np((3, 2, 64, 64), 8)).astype(jnp.bfloat16))
    port = port_cache(full)
    step = jax.jit(lambda c, a, b: jcache.append_token(jcfg, c, a, b))
    for t in range(3):
        kt, vt = bf16_np((3, 2, 64), 100 + t), bf16_np((3, 2, 64), 200 + t)
        full = step(full, jnp.asarray(kt).astype(jnp.bfloat16),
                    jnp.asarray(vt).astype(jnp.bfloat16))
        cache.append_token(pcfg, port, to_t(kt).to(torch.bfloat16),
                           to_t(vt).to(torch.bfloat16), lengths)
        lengths = lengths + 1
        assert_caches_match(pcfg, full, port)
    assert port.length.tolist() == [66, 103, 130]


def test_splice_reset_and_numeric_guard():
    _, pcfg = cache_cfgs("gear_kcvt4")
    pcfg1 = cache.CacheConfig(batch=1, kv_heads=2, head_dim=64, capacity=128, policy=pcfg.policy)
    one = cache.prefill_layer_cache(pcfg1, cache.init_layer_cache(pcfg1, device="cpu"),
                                    to_t(bf16_np((1, 2, 70, 64), 5)).to(torch.bfloat16),
                                    to_t(bf16_np((1, 2, 70, 64), 6)).to(torch.bfloat16))
    full = cache.init_layer_cache(pcfg, device="cpu")
    cache.splice_slot(full, one, 1)
    for name, t in full.tensors().items():
        assert torch.equal(t[1], getattr(one, name)[0]), name
        assert not t[0].any(), name
    assert bool(cache.tree_finite([full, one]))
    full.k_b[1, 0, 0, 0, 0] = float("nan")
    assert not bool(cache.tree_finite([one, full]))
    cache.reset_slot(full, 1)
    assert all(not t.any() for t in full.tensors().values())
    assert bool(cache.tree_finite(full))


def test_cache_config_rejects_unported_kinds():
    """Every kind of the reference is ported now (the name is kept from when
    the window and FP16 kinds raised): each builds as the reference's does,
    and only a GEAR capacity off the chunk grid raises, as in the reference."""
    pol = named_policy("gear_kcvt4")
    for kind, extra in (("window", dict(window=16)), ("fp16", {})):
        cfg = cache.CacheConfig(batch=1, kv_heads=1, head_dim=64, capacity=40, policy=pol,
                                kind=kind, **extra)
        jcfg = jcache.CacheConfig(batch=1, kv_heads=1, head_dim=64, capacity=40,
                                  policy=jnamed("gear_kcvt4"), kind=kind, **extra)
        assert dataclasses.astuple(cfg)[:4] == dataclasses.astuple(jcfg)[:4]
    with pytest.raises(ValueError, match="not a multiple of chunk"):
        cache.CacheConfig(batch=1, kv_heads=1, head_dim=64, capacity=40, policy=pol)


# ---------------------------------------------------------------------------
# package guards


def port_modules() -> list[str]:
    return sorted("repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
                  .replace(".__init__", "") for p in PORT.rglob("*.py"))


def test_port_imports_with_jax_blocked():
    code = ("import importlib, sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            f"for m in {port_modules()!r}:\n"
            "    importlib.import_module(m.rstrip('.'))\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO / "src")},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PORT.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_port_sources_import_neither_jax_nor_reference(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"
