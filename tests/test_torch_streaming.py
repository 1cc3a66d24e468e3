"""The port's streaming prefill against the JAX reference's.

Same numpy-seeded inputs go through the reference (jitted, or its Pallas
kernel in interpret mode under ``-m kernel``) and the port (CPU tensors, so
its wrappers take their plain versions).  Tolerances:

* ``gear_compress`` plain version vs the jitted ``ref.gear_compress_ref``:
  codes, stats, outliers and residual bit-equal; vs the interpret kernel,
  the reference's own budget (stats and outliers exact, codes off by at most
  1 on under 0.1% of entries, the residual by at most one scale step);
* ``flash_block`` and the history scorer (``gear_hist_block_ref``), f32 on
  both sides in another summation order: 1e-5 on the normalized output and
  the score max;
* ``streaming_prefill_layer_cache``: every cache leaf bit-equal to the
  port's own monolithic ``prefill_layer_cache``, and to the reference's
  streaming cache except the low-rank factors, which are held through
  ``A·Bᵀ`` within 1e-2 relative as ``test_torch_core`` holds the monolithic
  cache (the power iteration's f32 products round apart in torch and XLA,
  moving a few factor entries by one bf16 ulp); the bf16 attention output
  within 1/64 (two bf16 ulps at |x| ~ 1; f32 math ordered apart before the
  final rounding);
* the smoke model's streaming prefill logits within 0.0625, as the
  monolithic path's (``test_torch_serving.PREFILL_ATOL``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as ref_smoke_config  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill_block as j_flash_block  # noqa: E402
from repro.kernels.gear_compress import gear_compress as j_gear_compress  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import gear_compress as gc  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

BLOCK_ATOL = 1e-5
OUT_ATOL = 1 / 64
PREFILL_ATOL = 0.0625


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_t(x) -> torch.Tensor:
    t = torch.from_numpy(to_np(x).copy())
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def chunks(shape, seed):
    """f32 values representable in bf16 (what the cache compresses)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("scheme", ["per_channel", "per_token"])
@pytest.mark.parametrize("bits", [2, 4])
@pytest.mark.parametrize("n_out", [1, 2])
def test_gear_compress_plain_matches_jitted_reference(scheme, bits, n_out):
    x = chunks((6, 64, 128), bits * 10 + n_out)
    x[0, :, 3] = 0.75                       # constant channel / token: top and bottom
    x[1, 5, :] = -1.5                       # outliers share an index (set semantics)
    kw = dict(bits=bits, scheme=scheme, n_out=n_out)
    want = jax.jit(lambda a: jref.gear_compress_ref(a, **kw))(jnp.asarray(x))
    got = gc.gear_compress(torch.from_numpy(x), **kw)
    for name, w, g in zip(("packed", "scale", "zero", "sp_val", "sp_idx", "resid"), want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.kernel
@pytest.mark.parametrize("scheme,group", [("per_channel", None), ("per_token", 64)])
@pytest.mark.parametrize("bits", [2, 4])
def test_gear_compress_plain_matches_interpret_kernel(scheme, group, bits):
    x = chunks((4, 64, 128), bits)
    n_out = 1 if scheme == "per_channel" else 2
    kw = dict(bits=bits, scheme=scheme, group=group, n_out=n_out)
    pk, sk, zk, svk, sik, rk = j_gear_compress(jnp.asarray(x), interpret=True, **kw)
    pp, sp, zp, svp, sip, rp = gc.gear_compress(torch.from_numpy(x), **kw)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sk))
    np.testing.assert_array_equal(zp.numpy(), np.asarray(zk))
    np.testing.assert_array_equal(sip.numpy(), np.asarray(sik))
    np.testing.assert_array_equal(svp.numpy(), np.asarray(svk))
    diff = np.abs(np.asarray(jpacking.unpack(pk, bits, 128))
                  - np.asarray(jpacking.unpack(jnp.asarray(pp.numpy()), bits, 128)))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert np.abs(rp.numpy() - np.asarray(rk)).max() <= float(sk.max()) + 1e-6


@pytest.mark.kernel
@pytest.mark.parametrize("T,rep", [(64, 1), (23, 2)])
def test_flash_block_plain_matches_reference_and_interpret_kernel(T, rep):
    N, Dh = 8, 32
    rng = np.random.RandomState(T)
    q = rng.randn(N, T, Dh).astype(np.float32)
    k = rng.randn(N // rep, T, Dh).astype(np.float32)
    v = rng.randn(N // rep, T, Dh).astype(np.float32)
    kv_len = rng.randint(1, T + 1, size=N).astype(np.int32)
    kv_len[0] = T
    kr, vr = jnp.repeat(jnp.asarray(k), rep, 0), jnp.repeat(jnp.asarray(v), rep, 0)
    acc_r, m_r, l_r = jref.flash_block_ref(jnp.asarray(q), kr, vr, jnp.asarray(kv_len),
                                           scale=Dh ** -0.5)
    acc_i, m_i, l_i = j_flash_block(jnp.asarray(q), kr, vr, jnp.asarray(kv_len),
                                    scale=Dh ** -0.5, interpret=True)
    acc, m, l = ops.flash_prefill_block(torch.from_numpy(q), torch.from_numpy(k),
                                        torch.from_numpy(v), torch.from_numpy(kv_len),
                                        scale=Dh ** -0.5, kv_repeat=rep)
    out = (acc / l[..., None]).numpy()
    for acc_j, m_j, l_j in ((acc_r, m_r, l_r), (acc_i, m_i[..., 0], l_i[..., 0])):
        np.testing.assert_allclose(out, np.asarray(acc_j / l_j[..., None]), atol=BLOCK_ATOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=BLOCK_ATOL)


def prefilled(polname, B=1, H=2, Dh=64, S=256, n=256, seed=0):
    """Reference cache of ``n`` prefilled bf16 tokens, one K channel and one
    V token constant (an outlier index stored as both top and bottom)."""
    jcfg = jcache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                              policy=jnamed(polname))
    rng = np.random.RandomState(seed)
    k = jnp.asarray(rng.randn(B, H, n, Dh).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.randn(B, H, n, Dh).astype(np.float32)).astype(jnp.bfloat16)
    k = k.at[0, 0, :, 3].set(2.0)
    v = v.at[0, 1, 4, :].set(-1.5)
    jc = jax.jit(lambda a, b: jcache.prefill_layer_cache(jcfg, jcache.init_layer_cache(jcfg),
                                                         a, b))(k, v)
    pcfg = cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                             policy=named_policy(polname))
    pc = cache.GEARLayerCache(**{f: None if getattr(jc, f) is None else to_t(getattr(jc, f))
                                 for f in cache.FIELDS})
    return jcfg, jc, pcfg, pc


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_history_scorer_plain_matches_reference(polname):
    """``gear_hist_block_ref`` (the CPU history of a streaming block: G * T
    query rows sharing one extent) equals the reference's, duplicate outlier
    index included."""
    jcfg, jc, pcfg, pc = prefilled(polname)
    BH = 2
    arrays, lr, sp = jops._gear_operands(jcfg, jc, BH)
    kw = dict(bits=jcfg.policy.bits, chunk=64, scale_factor=64 ** -0.5)
    q = np.random.RandomState(1).randn(BH, 2 * 64, 64).astype(np.float32)
    t_arrays, t_lr, t_sp = ops._gear_operands(pcfg, pc, BH)
    for n_comp in (0, 64, 192):
        acc_r, m_r, l_r = jref.gear_hist_block_ref(jnp.asarray(q), *arrays, n_comp, **kw,
                                                   **lr, **sp)
        acc, m, l = ref.gear_hist_block_ref(torch.from_numpy(q), *t_arrays, n_comp, **kw,
                                            **t_lr, **t_sp)
        np.testing.assert_allclose((acc / l[..., None]).numpy(),
                                   np.asarray(acc_r / l_r[..., None]), atol=BLOCK_ATOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_r), atol=BLOCK_ATOL)


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_attend_block_matches_reference(polname):
    """Stacks of blocks (G = 2 query heads per kv head: three full blocks,
    then one ragged tail block) against the reference's one-block
    ``gear_attend_block``."""
    jcfg, jc, pcfg, pc = prefilled(polname, seed=2)
    rng = np.random.RandomState(3)
    T, Dh = 64, 64
    for n_comp, blk_len in (([0, 64, 192], 64), ([128], 17)):
        NB = len(n_comp)
        q = rng.randn(1, 4, NB, T, Dh).astype(np.float32)
        k = rng.randn(1, 2, NB, T, Dh).astype(np.float32)
        v = rng.randn(1, 2, NB, T, Dh).astype(np.float32)
        # query head h * G + g -> the kernel layout [B, H, NB, G, T, Dh], and back
        q_g = np.ascontiguousarray(q.reshape(1, 2, 2, NB, T, Dh).transpose(0, 1, 3, 2, 4, 5))
        got = ops.gear_attend_block(pcfg, pc, torch.from_numpy(q_g), torch.from_numpy(k),
                                    torch.from_numpy(v), n_comp, blk_len, Dh ** -0.5)
        got = got.permute(0, 1, 3, 2, 4, 5).reshape(1, 4, NB, T, Dh)
        for i in range(NB):
            want = jops.gear_attend_block(jcfg, jc, jnp.asarray(q[:, :, i]),
                                          jnp.asarray(k[:, :, i]), jnp.asarray(v[:, :, i]),
                                          n_comp[i], blk_len, Dh ** -0.5)
            rows = slice(None, blk_len)
            np.testing.assert_allclose(got[:, :, i, rows].numpy(), np.asarray(want)[:, :, rows],
                                       atol=BLOCK_ATOL)


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("n,true_n", [(192, None), (215, None), (256, 200)])
def test_streaming_prefill_layer_cache_matches_reference_and_monolithic(polname, n, true_n):
    """Aligned, raw-tail and padded-tail (``true_n < n``) prompts: cache
    leaves bit-equal to the reference's streaming prefill and to the port's
    monolithic prefill of the same real tokens; attention outputs within
    OUT_ATOL of the reference's."""
    B, H, Hq, Dh, S = 1, 2, 4, 64, 320
    jcfg = jcache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                              policy=jnamed(polname))
    pcfg = cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                             policy=named_policy(polname))
    rng = np.random.RandomState(n)
    q = jnp.asarray(rng.randn(B, Hq, n, Dh).astype(np.float32)).astype(jnp.bfloat16)
    k = jnp.asarray(rng.randn(B, H, n, Dh).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.randn(B, H, n, Dh).astype(np.float32)).astype(jnp.bfloat16)
    padded = true_n is not None
    tn = None if not padded else jnp.int32(true_n)
    jc, jout = jax.jit(lambda a, b, c, t: jcache.streaming_prefill_layer_cache(
        jcfg, jcache.init_layer_cache(jcfg), a, b, c, Dh ** -0.5, tail_is_padded=padded,
        true_n=t))(q, k, v, tn)
    pc, out = cache.streaming_prefill_layer_cache(
        pcfg, cache.init_layer_cache(pcfg, device="cpu"), to_t(q), to_t(k), to_t(v),
        Dh ** -0.5, tail_is_padded=padded, true_n=true_n)
    for f in cache.FIELDS:
        if getattr(jc, f) is not None and not f.endswith(("_a", "_b")):
            np.testing.assert_array_equal(to_np(getattr(pc, f)), to_np(getattr(jc, f)),
                                          err_msg=f)
    for kv in ("k", "v"):
        ab = [to_np(getattr(c, f"{kv}_a")).reshape(B, H, S // 64, 64, -1)
              @ np.swapaxes(to_np(getattr(c, f"{kv}_b")), -1, -2) for c in (pc, jc)]
        assert np.linalg.norm(ab[0] - ab[1]) <= 1e-2 * np.linalg.norm(ab[1]), kv
    real = n if true_n is None else true_n
    np.testing.assert_allclose(to_np(out)[:, :, :real], to_np(jout)[:, :, :real], atol=OUT_ATOL)

    mono = cache.prefill_layer_cache(pcfg, cache.init_layer_cache(pcfg, device="cpu"),
                                     to_t(k)[:, :, :real], to_t(v)[:, :, :real])
    n_closed = (n // 64 - 1 if padded else n // 64) * 64
    for f in cache.FIELDS:
        a, b = getattr(pc, f), getattr(mono, f)
        if f in ("buf_k", "buf_v"):
            a, b = a[:, :, :real - n_closed], b[:, :, :real - n_closed]
        if a is not None:
            assert torch.equal(a, b), f


def test_streaming_rejects_what_it_cannot_take():
    pcfg = cache.CacheConfig(batch=1, kv_heads=1, head_dim=32, capacity=128,
                             policy=named_policy("gear_kcvt4"))
    x = torch.zeros(1, 1, 100, 32, dtype=torch.bfloat16)
    c = cache.init_layer_cache(pcfg, device="cpu")
    with pytest.raises(ValueError, match="n % n_b"):
        cache.streaming_prefill_layer_cache(pcfg, c, x, x, x, 1.0, tail_is_padded=True,
                                            true_n=90)
    long = torch.zeros(1, 1, 192, 32, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="exceeds capacity"):
        cache.streaming_prefill_layer_cache(pcfg, c, long, long, long, 1.0)
    flex = dataclasses.replace(pcfg, policy=named_policy("per_token_q4"))
    assert not cache.streaming_supported(flex)
    with pytest.raises(ValueError, match="per-channel K"):
        cache.streaming_prefill_layer_cache(flex, c, x, x, x, 1.0)


def test_streaming_model_prefill_matches_reference():
    """The smoke llama2-7b on the reference's parameters: streaming prefill
    logits (raw and length-bucketed prompts) within PREFILL_ATOL of the
    reference's (CPU oracles), and its caches equal the port's own
    monolithic prefill's wherever the two see the same K/V (the closed
    chunks of layer 0)."""
    ref_model = ref_build_model(ref_smoke_config("llama2-7b"))
    ref_params = ref_model.init(jax.random.PRNGKey(0))
    rpol = jnamed("gear_kcvt4")
    cfg = smoke_config("llama2-7b")
    model = build_model(cfg)
    params = params_from_reference(jax.tree.map(np.asarray, ref_params), cfg, device="cpu")
    pol = named_policy("gear_kcvt4")
    prompt = np.random.RandomState(5).randint(0, cfg.vocab_size, size=150).astype(np.int32)
    cap = 256

    logits_r, _ = ref_model.prefill(ref_params, {"tokens": jnp.asarray(prompt[None])}, rpol, cap,
                                    prefill_mode="streaming")
    logits, caches = model.prefill(params, {"tokens": prompt[None]}, pol, cap,
                                   prefill_mode="streaming")
    ref_last = np.asarray(logits_r[0, -1].astype(jnp.float32))
    np.testing.assert_allclose(logits[0, -1].float().numpy(), ref_last, atol=PREFILL_ATOL)

    padded = np.pad(prompt, (0, 192 - 150))[None]
    logits_b, caches_b = model.prefill(params, {"tokens": padded}, pol, cap,
                                       prefill_mode="streaming", padded_tail=True, true_len=150)
    np.testing.assert_allclose(logits_b[0, -1].float().numpy(), ref_last, atol=PREFILL_ATOL)
    assert caches_b[0].length.tolist() == [150]
    for f in ("k_packed", "k_scale", "v_packed", "v_sp_idx", "k_a"):
        assert torch.equal(getattr(caches_b[0], f), getattr(caches[0], f)), f

    _, mono = model.prefill(params, {"tokens": prompt[None]}, pol, cap)
    for f in cache.FIELDS:
        if f not in ("buf_k", "buf_v"):
            assert torch.equal(getattr(caches[0], f), getattr(mono[0], f)), f
