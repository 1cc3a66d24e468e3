"""The arithmetic of the redesigned CUDA kernels, emulated in plain PyTorch
on the CPU and held against the JAX reference.

``csrc/gear_decode.cuh`` and ``csrc/flash_prefill.cu`` run only on a card.
What they compute differently from the plain versions -- the order and
precision of their arithmetic -- is emulated here chunk by chunk and tile
by tile, on numpy-seeded inputs that go through the reference too (its
Pallas ``gear_decode`` in interpret mode, its jitted ``flash_prefill_ref``).
Tolerances:

* ``gear_decode``, both regimes: 1e-3 on the normalized output and the score
  max of rows with history (the reference's n_comp = 0 rows are a uniform
  softmax over masked scores, the kernel's (0, -1e30, 0) by design).  The
  decode regime folds the K / V stats into q / p in f32 and adds outliers
  in 2^-24 fixed point; the history regime multiplies bf16 hi + lo halves of
  q * s_K, q, p * s_V and p with the exact codes (~2^-16 relative);
* the batched history entry's plain version: 1e-5 against the reference
  kernel's per-block history and the port's per-block CPU path (f32 both
  sides, summation order apart);
* ``flash_prefill``: 3e-2 on the bf16-sized output (exp2 with the scale
  folded, P rounded to bf16 before P.V).
"""

import math

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
from repro.kernels.gear_decode import gear_decode as j_gear_decode  # noqa: E402
from repro_torch.core import cache  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import gear_decode as gd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

DECODE_TOL = 1e-3
HIST_TOL = 1e-5
PREFILL_TOL = 3e-2
NEG_INF = -1e30
F32 = torch.float32
BF16 = torch.bfloat16


def to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == BF16 else x).numpy()
    return np.array(x.astype(jnp.float32) if x.dtype == jnp.bfloat16 else x)


def to_t(x) -> torch.Tensor:
    t = torch.from_numpy(to_np(x).copy())
    return t.to(BF16) if x.dtype == jnp.bfloat16 else t


def prefilled(polname, B=2, H=2, Dh=64, S=512, n=512, seed=0, duplicates=True):
    """The reference's prefilled cache and the port's copy of it.  With
    ``duplicates``, one K channel and one V token are constant, so top-k and
    bottom-k store the same outlier index twice."""
    jcfg = jcache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                              policy=jnamed(polname))
    rng = np.random.RandomState(seed)
    k = jnp.asarray(rng.randn(B, H, n, Dh).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.randn(B, H, n, Dh).astype(np.float32)).astype(jnp.bfloat16)
    if duplicates:
        k = k.at[0, 0, :, 3].set(2.0)
        v = v.at[0, 1, 4, :].set(-1.5)
    jc = jax.jit(lambda a, b: jcache.prefill_layer_cache(jcfg, jcache.init_layer_cache(jcfg),
                                                         a, b))(k, v)
    pcfg = cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                             policy=named_policy(polname))
    pc = cache.GEARLayerCache(**{f: None if getattr(jc, f) is None else to_t(getattr(jc, f))
                                 for f in cache.FIELDS})
    return jcfg, jc, pcfg, pc


# ---------------------------------------------------------------------------
# gear_decode: emulation of csrc/gear_decode.cuh


def hi_lo(x: torch.Tensor):
    """The kernel's split of an f32 operand into bf16 hi + lo (as f32)."""
    hi = x.to(BF16).to(F32)
    return hi, (x - hi).to(BF16).to(F32)


def split_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b on the tensor cores: a split hi + lo, b exact in bf16, f32 sums."""
    hi, lo = hi_lo(a)
    return hi @ b + lo @ b


def fix(x: torch.Tensor) -> torch.Tensor:
    """A contribution as the 2^-24 fixed point the decode regime sums."""
    return torch.round(x * 2.0 ** 24) / 2.0 ** 24


def emulate_gear_decode(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp, *,
                        bits, chunk, scale_factor, regime, k_a=None, k_b=None, v_a=None,
                        v_b=None, k_sp_val=None, k_sp_idx=None, v_sp_val=None,
                        v_sp_idx=None):
    """(acc, m, l) of ``gear_decode`` as its kernels compute it: chunk by
    chunk with an online softmax, k_hat and v_hat never formed.  ``regime``
    is "decode" (CUDA cores: stats folded into q / p in f32, outliers in
    fixed point) or "history" (tensor cores: hi + lo halves against the exact
    codes, outliers densified into bf16 tiles in slot order)."""
    BH, G, Dh = q.shape
    nb = chunk
    gv = v_scale.shape[-1]
    grp = torch.arange(Dh) // (Dh // gv)
    n_comp = torch.as_tensor(n_comp, dtype=torch.int32).expand(BH)
    acc = torch.zeros(BH, G, Dh)
    m = torch.full((BH, G), NEG_INF)
    l = torch.zeros(BH, G)
    for x in range(BH):
        qx = q[x].to(F32)
        for c in range(-(-int(n_comp[x]) // nb)):
            tok = slice(c * nb, (c + 1) * nb)
            kc = packing.unpack(k_packed[x, tok], bits, Dh).to(F32)       # [nb, Dh] codes
            vc = packing.unpack(v_packed[x, tok], bits, Dh).to(F32)
            ks, kz = k_scale[x, c].to(F32), k_zero[x, c].to(F32)
            vs = v_scale[x, tok].to(F32)[:, grp]                          # [nb, Dh]
            vz = v_zero[x, tok].to(F32)                                   # [nb, gv]
            r = 0 if k_a is None else k_a.shape[-1]
            ka = torch.zeros(nb, 0) if r == 0 else k_a[x, tok].to(F32)
            kb = torch.zeros(Dh, 0) if r == 0 else k_b[x, c].to(F32)
            va = torch.zeros(nb, 0) if r == 0 else v_a[x, tok].to(F32)
            vb = torch.zeros(Dh, 0) if r == 0 else v_b[x, c].to(F32)
            if regime == "decode":
                s = (qx * ks) @ kc.T + (qx @ kz)[:, None] + (qx @ kb) @ ka.T
                if k_sp_val is not None:
                    for d in range(Dh):
                        for j in range(k_sp_val.shape[-1]):
                            t = int(k_sp_idx[x, c, d, j])
                            if 0 <= t < nb:
                                s[:, t] += fix(qx[:, d] * k_sp_val[x, c, d, j].float())
            else:
                ksp = torch.zeros(nb, Dh, dtype=BF16)
                if k_sp_val is not None:
                    for d in range(Dh):
                        for j in range(k_sp_val.shape[-1]):
                            t = int(k_sp_idx[x, c, d, j])
                            if 0 <= t < nb:
                                ksp[t, d] = (ksp[t, d].float() + k_sp_val[x, c, d, j].float()
                                             ).to(BF16)
                bx = torch.cat([kb, kz[:, None]], dim=1)                   # [Dh, r + 1]
                e = split_mm(qx, bx)
                ka2 = torch.cat([ka, torch.ones(nb, 1)], dim=1)            # [nb, r + 1]
                s = split_mm(qx * ks, kc.T) + split_mm(qx, ksp.float().T) + split_mm(e, ka2.T)
            s = s * scale_factor
            valid = torch.arange(c * nb, (c + 1) * nb) < int(n_comp[x])
            s = torch.where(valid[None], s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m[x], s.amax(-1))
            corr = torch.exp(m[x] - m_new)
            p = torch.exp(s - m_new[:, None])
            l[x] = l[x] * corr + p.sum(-1)
            m[x] = m_new
            onehot = (grp[None, :] == torch.arange(gv)[:, None]).to(F32)  # [gv, Dh]
            if regime == "decode":
                add = (p[:, :, None] * vs[None] * vc[None]).sum(1)
                add = add + (p @ vz) @ onehot + (p @ va) @ vb.T
                if v_sp_val is not None:
                    for t in range(nb):
                        for j in range(v_sp_val.shape[-1]):
                            d = int(v_sp_idx[x, c * nb + t, j])
                            if 0 <= d < Dh:
                                add[:, d] += fix(p[:, t] * v_sp_val[x, c * nb + t, j].float())
            else:
                add = torch.zeros(G, Dh)
                for gi in range(gv):
                    cols = grp == gi
                    add[:, cols] = split_mm(p * vs[:, cols][:, 0][None], vc[:, cols])
                if v_sp_val is not None:
                    vsp = torch.zeros(nb, Dh, dtype=BF16)
                    for t in range(nb):
                        for j in range(v_sp_val.shape[-1]):
                            d = int(v_sp_idx[x, c * nb + t, j])
                            if 0 <= d < Dh:
                                vsp[t, d] = (vsp[t, d].float()
                                             + v_sp_val[x, c * nb + t, j].float()).to(BF16)
                    add = add + split_mm(p, vsp.float())
                f = split_mm(p, torch.cat([va, vz], dim=1))                 # [G, r + gv]
                add = add + split_mm(f, torch.cat([vb.T, onehot], dim=0))
            acc[x] = acc[x] * corr[:, None] + add
    return acc, m, l


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("G", [1, 5, 12, 64])
def test_gear_decode_emulation_matches_reference_kernel(polname, G):
    """Both regimes' arithmetic (G = 1, 5 and 12 decode, G = 64 history) against
    the reference's Pallas kernel in interpret mode: ragged extents with an
    empty row, duplicated outlier indices."""
    B, H, Dh, S = 2, 2, 64, 512
    jcfg, jc, pcfg, pc = prefilled(polname, B=B, H=H, Dh=Dh, S=S, n=S)
    BH = B * H
    n_comp = np.array([0, 64, 320, 512], np.int32)
    q = np.random.RandomState(G).randn(BH, G, Dh).astype(np.float32)
    kw = dict(bits=jcfg.policy.bits, chunk=64, scale_factor=Dh ** -0.5)
    arrays, lr, sp = jops._gear_operands(jcfg, jc, BH)
    acc_j, m_j, l_j = j_gear_decode(jnp.asarray(q), *arrays, jnp.asarray(n_comp), **kw, **lr,
                                    **sp, interpret=True)
    t_arrays, t_lr, t_sp = ops._gear_operands(pcfg, pc, BH)
    regime = "decode" if G <= gd.DECODE_ROWS else "history"
    acc, m, l = emulate_gear_decode(torch.from_numpy(q), *t_arrays, torch.from_numpy(n_comp),
                                    **kw, **t_lr, **t_sp, regime=regime)
    live = n_comp > 0
    np.testing.assert_allclose((acc / l[..., None]).numpy()[live],
                               np.asarray(acc_j / l_j[..., :1])[live], atol=DECODE_TOL)
    np.testing.assert_allclose(m.numpy()[live], np.asarray(m_j[..., 0])[live], atol=DECODE_TOL)
    assert (acc[~live] == 0).all() and (l[~live] == 0).all() and (m[~live] == NEG_INF).all()


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_history_entry_plain_matches_reference_and_per_block_path(polname):
    """``gear_decode_history`` on CPU tensors (its plain version) against the
    reference's per-block history (its ``gear_decode`` kernel in interpret
    mode, one call per block, as its ``gear_attend_block`` runs it) and
    against the port's per-block CPU path (``gear_hist_block_ref`` over the
    chunk prefix of each extent; a cache without duplicate outlier indices,
    where its set semantics and the kernel's add-twice agree)."""
    B, H, Dh, S, NB = 1, 2, 64, 512, 5
    jcfg, jc, pcfg, pc = prefilled(polname, B=B, H=H, Dh=Dh, S=S, n=S, duplicates=False)
    BH = B * H
    extents = [0, 64, 128, 256, 448]
    q = np.random.RandomState(7).randn(BH, NB, 64, Dh).astype(np.float32)
    kw = dict(bits=jcfg.policy.bits, chunk=64, scale_factor=Dh ** -0.5)
    t_arrays, t_lr, t_sp = ops._gear_operands(pcfg, pc, BH)
    before = gd.gear_decode.launches
    acc, m, l = gd.gear_decode_history(torch.from_numpy(q), *t_arrays, extents, **kw, **t_lr,
                                       **t_sp)
    assert gd.gear_decode.launches == before        # CPU tensors: the plain version
    assert acc.shape == (BH, NB, 64, Dh) and m.shape == l.shape == (BH, NB, 64)
    arrays, lr, sp = jops._gear_operands(jcfg, jc, BH)
    for i, e in enumerate(extents[1:], start=1):
        acc_j, m_j, l_j = j_gear_decode(jnp.asarray(q[:, i]), *arrays,
                                        jnp.full((BH,), e, jnp.int32), **kw, **lr, **sp,
                                        interpret=True)
        np.testing.assert_allclose((acc[:, i] / l[:, i, :, None]).numpy(),
                                   np.asarray(acc_j / l_j[..., :1]), atol=HIST_TOL)
        np.testing.assert_allclose(m[:, i].numpy(), np.asarray(m_j[..., 0]), atol=HIST_TOL)
        view = cache.chunk_prefix_view(pcfg, pc, -(-e // 64))
        v_arrays, v_lr, v_sp = ops._gear_operands(pcfg, view, BH)
        acc_b, m_b, l_b = ref.gear_hist_block_ref(torch.from_numpy(q[:, i]), *v_arrays, e, **kw,
                                                  **v_lr, **v_sp)
        torch.testing.assert_close(acc[:, i] / l[:, i, :, None], acc_b / l_b[..., None],
                                   rtol=0, atol=HIST_TOL)
        torch.testing.assert_close(m[:, i], m_b, rtol=0, atol=HIST_TOL)


def test_streaming_prefill_attends_every_block_in_one_call():
    """The streaming pipeline hands the tail block to the same
    ``gear_attend_block`` call as the closed chunks (one history launch per
    layer on the card), and its output equals attending the tail alone."""
    jcfg, jc, pcfg, pc = prefilled("gear_kcvt4", B=1, H=2, Dh=64, S=512, n=512)
    rng = np.random.RandomState(3)
    n = 200                                          # 3 closed chunks + an 8-token tail
    q = torch.from_numpy(rng.randn(1, 4, n, 64).astype(np.float32)).to(BF16)
    k = torch.from_numpy(rng.randn(1, 2, n, 64).astype(np.float32)).to(BF16)
    v = torch.from_numpy(rng.randn(1, 2, n, 64).astype(np.float32)).to(BF16)
    calls = []
    real = ops.gear_attend_block

    def counting(*args, **kwargs):
        calls.append(args[3].shape[2])
        return real(*args, **kwargs)

    ops.gear_attend_block = counting
    try:
        fresh = cache.init_layer_cache(pcfg, BF16, "cpu")
        c, out = cache.streaming_prefill_layer_cache(pcfg, fresh, q, k, v, 64 ** -0.5)
    finally:
        ops.gear_attend_block = real
    assert calls == [4]                              # one call, 4 blocks
    assert int(c.length[0]) == n
    # the tail alone, as a 64-row block whose last 56 rows are padding
    G, rem = 2, n - 192
    qt = torch.zeros(1, 2, 1, G, 64, 64)
    qt[:, :, 0, :, :rem] = q[:, :, 192:].float().reshape(1, 2, G, rem, 64)
    kt = torch.zeros(1, 2, 1, 64, 64)
    vt = torch.zeros(1, 2, 1, 64, 64)
    kt[:, :, 0, :rem] = k[:, :, 192:].float()
    vt[:, :, 0, :rem] = v[:, :, 192:].float()
    tail = ops.gear_attend_block(pcfg, c, qt, kt, vt, [192], rem, 64 ** -0.5)
    want = tail[:, :, 0, :, :rem].reshape(1, 4, rem, 64).to(BF16)
    torch.testing.assert_close(out[:, :, 192:], want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flash_prefill: emulation of csrc/flash_prefill.cu


def emulate_flash_prefill(q, k, v, *, window=0, prefix_len=0, softcap=0.0, kv_repeat=1):
    """The kernel's tile loop: 64-query tiles over 64-key tiles from the
    window's lower edge to the causal / prefix limit, scores in log2 units
    (scale * log2 e folded into one multiply, exp2), the mask applied only
    to tiles that need it, P rounded to bf16 before P.V, l from the f32 P."""
    BH, S, Dh = q.shape
    scale = Dh ** -0.5
    out = torch.zeros(BH, S, Dh)
    for x in range(BH):
        qx, kx, vx = q[x].float(), k[x // kv_repeat].float(), v[x // kv_repeat].float()
        for qs in range(0, S, 64):
            qe = min(qs + 64, S)
            in_prefix = prefix_len > 0 and qs < prefix_len
            kv_hi = max(qe, min(prefix_len, S)) if in_prefix else qe
            kv_lo = max(0, qs - window + 1) if window > 0 and not in_prefix else 0
            m = torch.full((qe - qs,), NEG_INF)
            l = torch.zeros(qe - qs)
            acc = torch.zeros(qe - qs, Dh)
            for k0 in range(kv_lo // 64 * 64, kv_hi, 64):
                ke = min(k0 + 64, S)
                s = qx[qs:qe] @ kx[k0:ke].T
                if softcap > 0:
                    s = softcap * torch.tanh(s * scale / softcap) * math.log2(math.e)
                else:
                    s = s * (scale * math.log2(math.e))
                whole = (k0 + 63 <= qs and k0 + 64 <= S
                         and (window <= 0 or qs + 63 - k0 < window))
                if not whole:
                    qi = torch.arange(qs, qe)[:, None]
                    ki = torch.arange(k0, ke)[None, :]
                    ok = qi >= ki
                    if window > 0:
                        ok = ok & (qi - ki < window)
                    if prefix_len > 0:
                        ok = ok | ((qi < prefix_len) & (ki < prefix_len))
                    s = torch.where(ok, s, torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m - m_new)
                p = torch.exp2(s - m_new[:, None])
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + p.to(BF16).float() @ vx[k0:ke]
                m = m_new
            out[x, qs:qe] = acc / l.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


FLASH_CASES = {
    "causal": dict(S=200, BH=2, Dh=128),
    "window_softcap": dict(S=200, BH=2, Dh=128, window=48, softcap=30.0),
    "prefix": dict(S=150, BH=2, Dh=128, prefix_len=40),
    "kv_repeat5_dh64": dict(S=130, BH=5, Dh=64, kv_repeat=5),
}


@pytest.mark.parametrize("name", list(FLASH_CASES))
def test_flash_prefill_emulation_matches_reference(name):
    case = dict(FLASH_CASES[name])
    S, BH, Dh = case.pop("S"), case.pop("BH"), case.pop("Dh")
    rep = case.get("kv_repeat", 1)
    rng = np.random.RandomState(S + BH)
    bf = lambda a: np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    q = bf(rng.randn(BH, S, Dh).astype(np.float32))
    k = bf(rng.randn(BH // rep, S, Dh).astype(np.float32))
    v = bf(rng.randn(BH // rep, S, Dh).astype(np.float32))
    want = jref.flash_prefill_ref(jnp.asarray(q), jnp.asarray(np.repeat(k, rep, axis=0)),
                                  jnp.asarray(np.repeat(v, rep, axis=0)), jnp.arange(S),
                                  window=case.get("window", 0),
                                  prefix_len=case.get("prefix_len", 0),
                                  softcap=case.get("softcap", 0.0))
    got = emulate_flash_prefill(torch.from_numpy(q).to(BF16), torch.from_numpy(k).to(BF16),
                                torch.from_numpy(v).to(BF16), **case)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want), atol=PREFILL_TOL)
