"""The port's kernel wrappers against the JAX reference's kernels.

On the CPU each wrapper takes its plain PyTorch version (because the tensors
lie on the CPU); these tests hold that version against both the reference's
oracle (``repro.kernels.ref``) and its Pallas kernel run in interpret mode,
on identical inputs made from numpy seeds.  Tolerances (f32 math on both
sides, different summation order):

* ``gear_decode``: normalized output and score max within 1e-4, for ragged
  extents (0, one chunk, mid, full) and a fixture whose constant channel and
  constant token store one outlier index twice;
* ``gear_attend`` (compressed history + FP16 buffer merge): 1e-4;
* ``flash_prefill``: 2e-4 in f32 and 3e-2 in bf16, across causal, window,
  bidirectional prefix, softcap and ``kv_repeat``.

The CUDA kernels themselves run only on a card: ``test_torch_cuda.py``
compares them with these plain versions there.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import cache as jcache  # noqa: E402
from repro.core.policy import named_policy as jnamed  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as j_flash  # noqa: E402
from repro.kernels.gear_decode import gear_decode as j_gear_decode  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import gear_decode as gd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_prefill_ref, gear_decode_ref  # noqa: E402
from torch_fake_device import elsewhere  # noqa: E402

DECODE_ATOL = 1e-4


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_t(x) -> torch.Tensor:
    """JAX array -> torch tensor of the same dtype."""
    t = torch.from_numpy(to_np(x))
    return t.to(torch.bfloat16) if x.dtype == jnp.bfloat16 else t


def bf16(shape, seed):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return jnp.asarray(x).astype(jnp.bfloat16)


def ragged_cache(polname, H=2, Dh=64, S=256, lengths=(10, 70, 150, 256), seed=0):
    """A JAX cache whose slots sit at ``lengths``: every chunk holds data
    (so masking past each slot's extent is exercised), the FP16 buffer holds
    random tokens, and slot 0 has a constant K channel and a constant V
    token (an outlier index stored twice)."""
    B = len(lengths)
    jcfg = jcache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                              policy=jnamed(polname))
    k, v = bf16((B, H, S, Dh), seed), bf16((B, H, S, Dh), seed + 1)
    k = k.at[0, 0, :, 3].set(2.0)
    v = v.at[0, 1, 4, :].set(-1.5)
    full = jax.jit(lambda a, b: jcache.prefill_layer_cache(
        jcfg, jcache.init_layer_cache(jcfg), a, b))(k, v)
    nb = jcfg.chunk
    full = dataclasses.replace(full, length=jnp.asarray(lengths, jnp.int32),
                               buf_k=bf16((B, H, nb, Dh), seed + 2),
                               buf_v=bf16((B, H, nb, Dh), seed + 3))
    return jcfg, full


def port_cache(jc):
    return cache.GEARLayerCache(**{f: None if getattr(jc, f) is None else to_t(getattr(jc, f))
                                   for f in cache.FIELDS})


def decode_operands(jcfg, jc, G, seed):
    BH = jcfg.batch * jcfg.kv_heads
    arrays, lr, sp = jops._gear_operands(jcfg, jc, BH)
    length = jnp.repeat(jc.length, jcfg.kv_heads)
    n_comp = (length // jcfg.chunk) * jcfg.chunk
    q = jnp.asarray(np.random.RandomState(seed).randn(BH, G, jcfg.head_dim).astype(np.float32))
    kw = dict(bits=jcfg.policy.bits, chunk=jcfg.chunk, scale_factor=jcfg.head_dim ** -0.5)
    return q, arrays, n_comp, kw, lr | sp


@pytest.mark.kernel
@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("G", [1, 2])
def test_gear_decode_plain_matches_reference_and_interpret_kernel(polname, G):
    jcfg, jc = ragged_cache(polname, S=192, lengths=(5, 64, 130, 192))
    dup_k = np.asarray(jc.k_sp_idx[..., 0] == jc.k_sp_idx[..., jc.k_sp_idx.shape[-1] // 2])
    dup_v = np.asarray(jc.v_sp_idx[..., 0] == jc.v_sp_idx[..., jc.v_sp_idx.shape[-1] // 2])
    assert dup_k.any() and dup_v.any()          # the stored-twice outlier quirk is exercised
    q, arrays, n_comp, kw, extra = decode_operands(jcfg, jc, G, seed=1)
    assert sorted(set(np.asarray(n_comp).tolist())) == [0, 64, 128, 192]
    acc_r, m_r, l_r = jref.gear_decode_ref(q, *arrays, n_comp, **kw, **extra)
    acc_i, m_i, l_i = j_gear_decode(q, *arrays, n_comp, interpret=True, **kw, **extra)
    t_extra = {k: to_t(v) for k, v in extra.items()}
    acc_p, m_p, l_p = gd.gear_decode(to_t(q), *[to_t(a) for a in arrays], to_t(n_comp),
                                     **kw, **t_extra)
    out_p = to_np(acc_p) / to_np(l_p)[..., None]
    np.testing.assert_allclose(out_p, np.asarray(acc_r / l_r[..., None]), atol=DECODE_ATOL)
    np.testing.assert_allclose(to_np(m_p), np.asarray(m_r), atol=DECODE_ATOL)
    np.testing.assert_allclose(out_p, np.asarray(acc_i / l_i[..., 0:1]), atol=DECODE_ATOL)
    np.testing.assert_allclose(to_np(m_p), np.asarray(m_i[..., 0]), atol=DECODE_ATOL)


@pytest.mark.kernel
@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_attend_matches_reference(polname):
    """Decode attention with the FP16 buffer merged (``ops.gear_attend``)
    against the reference's, with its kernel in interpret mode."""
    jcfg, jc = ragged_cache(polname, S=192, lengths=(0, 64, 130, 191), seed=4)
    q = np.random.RandomState(2).randn(jcfg.batch, 2 * jcfg.kv_heads, 64).astype(np.float32)
    ref = jops.gear_attend(jcfg, jc, jnp.asarray(q), scale=64 ** -0.5, force_kernel=True,
                           interpret=True)
    pcfg = cache.CacheConfig(batch=jcfg.batch, kv_heads=jcfg.kv_heads, head_dim=64,
                             capacity=192, policy=named_policy(polname))
    out = ops.gear_attend(pcfg, port_cache(jc), torch.from_numpy(q), scale=64 ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=DECODE_ATOL)


FLASH_CASES = [
    # (S, Dh, kv_repeat, window, prefix_len, softcap)
    (64, 32, 1, 0, 0, 0.0),
    (96, 16, 2, 0, 0, 0.0),
    (128, 32, 1, 48, 0, 0.0),
    (128, 32, 1, 0, 40, 0.0),
    (96, 32, 2, 32, 0, 20.0),
    (64, 64, 4, 0, 0, 5.0),
]


@pytest.mark.kernel
@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_flash_prefill_plain_matches_reference_and_interpret_kernel(case, dtype, atol):
    S, Dh, rep, window, prefix, cap = case
    BH = 4
    rng = np.random.RandomState(S + Dh + rep)
    jd = jnp.dtype(dtype)
    q = jnp.asarray(rng.randn(BH, S, Dh).astype(np.float32)).astype(jd)
    k = jnp.asarray(rng.randn(BH // rep, S, Dh).astype(np.float32)).astype(jd)
    v = jnp.asarray(rng.randn(BH // rep, S, Dh).astype(np.float32)).astype(jd)
    kw = dict(window=window, prefix_len=prefix, softcap=cap)
    ref = jref.flash_prefill_ref(q, jnp.repeat(k, rep, 0), jnp.repeat(v, rep, 0),
                                 jnp.arange(S), causal=True, **kw)
    interp = j_flash(q, k, v, bq=32, bk=32, kv_repeat=rep, interpret=True, **kw)
    out = fp.flash_prefill(to_t(q), to_t(k), to_t(v), kv_repeat=rep, **kw)
    assert out.dtype == to_t(q).dtype
    np.testing.assert_allclose(to_np(out), to_np(ref), atol=atol)
    np.testing.assert_allclose(to_np(out), to_np(interp), atol=atol)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    jcfg, jc = ragged_cache("gear_kcvt4", S=128, lengths=(70, 128))
    q, arrays, n_comp, kw, extra = decode_operands(jcfg, jc, 1, seed=3)
    before = (gd.gear_decode.launches, fp.flash_prefill.launches)
    gd.gear_decode(to_t(q), *[to_t(a) for a in arrays], int(n_comp[-1]), **kw,
                   **{k: to_t(v) for k, v in extra.items()})
    x = torch.randn(2, 40, 16)
    fp.flash_prefill(x, x, x)
    assert (gd.gear_decode.launches, fp.flash_prefill.launches) == before
    # meta tensors (the dry run) take the plain version too, without counting
    assert fp.flash_prefill(x.to("meta"), x.to("meta"), x.to("meta")).shape == x.shape
    assert (gd.gear_decode.launches, fp.flash_prefill.launches) == before
    # a device with neither a kernel nor a plain version
    with pytest.raises(ValueError, match="no kernel for device"):
        fp.flash_prefill(elsewhere(x), elsewhere(x), elsewhere(x))


def test_plain_versions_are_the_wrapped_ones():
    """The wrappers' CPU path is exactly the plain module function."""
    x = torch.randn(4, 50, 32)
    torch.testing.assert_close(fp.flash_prefill(x, x[:2], x[:2], kv_repeat=2, window=7),
                               flash_prefill_ref(x, x[:2], x[:2], kv_repeat=2, window=7),
                               rtol=0, atol=0)
    jcfg, jc = ragged_cache("gear_kivi2", S=128, lengths=(0, 128))
    q, arrays, n_comp, kw, extra = decode_operands(jcfg, jc, 1, seed=5)
    args = (to_t(q), *[to_t(a) for a in arrays], to_t(n_comp))
    t_extra = {k: to_t(v) for k, v in extra.items()}
    pairs = zip(gd.gear_decode(*args, **kw, **t_extra), gear_decode_ref(*args, **kw, **t_extra))
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=0, atol=0)
