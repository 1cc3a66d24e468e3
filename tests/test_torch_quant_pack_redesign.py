"""``quant_pack``'s non-finite contract and the redesigned kernel's layout, on
the CPU.

- **Non-finite input.** A NaN column, +inf / -inf / both in others and an
  all-NaN tile: the port's plain version (``ref.quant_pack_ref``, what the
  CUDA kernel is held to on the card) equals the reference's Pallas kernel
  in interpret mode and its jitted ``ref.quant_pack_ref`` bit for bit, a
  NaN equal to any NaN: zero and scale NaN exactly in the NaN columns,
  infinite in the +-inf ones, every code of those columns 0.
- **The layout of ``csrc/quant_pack.cu``.** A plain-PyTorch emulation of its
  routing (the vector kernel, else the scalar kernel), the vector kernel's
  thread-to-column map (a 128-thread block per 32-column slab; 16-byte
  vectors: quads in f32, octets in bf16), its register, warp and block
  folds, its codes (a * RN(1 / s) with the IEEE division near a
  half-integer, rounded by adding 1.5 * 2**23) and its packing (a thread's
  codes shifted into place in one word, OR-combined across the word's
  per / vec lanes by the xor butterfly; bf16 at 8 bits two whole words)
  equals the plain version bit for bit at every card-test shape, bit width
  and dtype, and every word and stat is stored exactly once.  Cases that
  break a lane's shift or order, drop the OR, or drop the division
  fallback must differ.
- **``gear_compress`` on NaN tiles.** A vector with more NaNs than its
  outlier count, one with a single NaN, and an all-NaN tile: the plain
  version equals the reference's Pallas kernel in interpret mode in every
  output (each pick of a NaN vector is (NaN, its length), nothing is taken
  out, its groups' stats are NaN); the port's ``iterative_topk`` equals the
  reference's on NaN vectors.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import outlier as j_outlier  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.gear_compress import gear_compress as j_gear_compress  # noqa: E402
from repro.kernels.quant_pack import quant_pack as j_quant_pack  # noqa: E402
from repro_torch.core import outlier as ol  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32 = torch.float32
VEC_THREADS, SLAB, MAX_ROWS = 128, 32, 16          # csrc/quant_pack.cu
ROUND, ROUND_BITS = 12582912.0, 0x4B400000          # 1.5 * 2**23 and its bits
QP_SHAPES = [(448, 64, 128), (2, 16, 64), (1, 64, 256), (8, 32, 32), (3, 7, 48)]  # card tests
SLAB_SHAPES = [(2, 520, 32), (2, 600, 64)]         # taller than 16 rows a thread

_jit_ref = jax.jit(jref.quant_pack_ref, static_argnums=1)


def inputs(x: np.ndarray, dtype: str):
    """The same values for both packages: f32, or their bf16 cast."""
    xj = jnp.asarray(x)
    if dtype == "bf16":
        xj = xj.astype(jnp.bfloat16)
        return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    return xj, torch.from_numpy(np.array(xj))


def non_finite(shape, seed: int) -> np.ndarray:
    """Normals with a NaN in column 0, +inf in column 1, -inf in column 2 and
    both in column 4 of tile 0, and a last tile that is all NaN."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    n = shape[1]
    x[0, n // 2, 0] = np.nan
    x[0, 0, 1] = np.inf
    x[0, n - 1, 2] = -np.inf
    x[0, 0, 4], x[0, n - 1, 4] = np.inf, -np.inf
    x[-1] = np.nan
    return x


def nan_equal(got, want) -> None:
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))   # NaN == NaN here


# ---------------------------------------------------------------------------
# non-finite input


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", [(3, 64, 128), (2, 7, 48)], ids=["3x64x128", "2x7x48"])
def test_plain_version_equals_reference_on_non_finite_input(shape, bits, dtype):
    xj, xt = inputs(non_finite(shape, seed=bits + shape[1]), dtype)
    got = ref.quant_pack_ref(xt, bits)
    for want in (j_quant_pack(xj, bits, interpret=True), _jit_ref(xj, bits)):
        for g, w in zip(got, want):
            nan_equal(g.numpy(), w)
    packed, scale, zero = got
    nan_cols = torch.isnan(xt.float()).any(dim=1)
    assert torch.equal(torch.isnan(scale), nan_cols) and torch.equal(torch.isnan(zero), nan_cols)
    assert bool(nan_cols[0, 0]) and bool(nan_cols[-1].all()) and not bool(nan_cols[0, 1:].any())
    assert float(scale[0, 1]) == float("inf") and float(zero[0, 2]) == -float("inf")
    assert float(scale[0, 4]) == float("inf") and float(zero[0, 4]) == -float("inf")
    codes = emulate(xt, bits, layout="plain")[0]
    assert torch.equal(packed, codes)
    lanes = ref.packing.unpack(packed, bits, shape[2])
    for col in (0, 1, 2, 4):
        assert int(lanes[0, :, col].abs().sum()) == 0      # NaN, finite / inf, inf / inf
    assert int(lanes[-1].abs().sum()) == 0


# ---------------------------------------------------------------------------
# the kernel's layout


def route(n: int, d: int, bf16: bool):
    """Rows a fast-path thread holds (1, 2, 4, 8 or 16), or None where the C
    entry point sends the shape to the scalar kernel."""
    vec = 8 if bf16 else 4
    if d % vec:
        return None
    rows = -(-n // (VEC_THREADS * vec // SLAB))
    return next((r for r in (1, 2, 4, 8, MAX_ROWS) if r >= rows), None)


def fold(vals, live, dim):
    """The kernel's NaN-propagating min / max over ``dim`` (dead entries are
    the fold's identity)."""
    inf = torch.tensor(float("inf"), dtype=F32)
    return torch.where(live, vals, inf).amin(dim), torch.where(live, vals, -inf).amax(dim)


def round_code(q, bits):
    """The scalar kernel's round_code: clamp (fmax maps NaN to 0), then q +
    1.5 * 2**23 rounds half to even into the low bits."""
    qc = torch.fmin(torch.fmax(q, torch.zeros((), dtype=F32)),
                    torch.tensor(2.0 ** bits - 1, dtype=F32))
    return ((qc + torch.tensor(ROUND, dtype=F32)).view(torch.int32) - ROUND_BITS).to(torch.int64)


def fma(x, y, z):
    """f32 fused multiply-add: the product is exact in f64, the sum rounds
    once in f64 and once to f32 (a double rounding that could differ from
    the card's single one only within 2**-53 of an f32 midpoint)."""
    return (x.double() * y.double() + z.double()).float()


def div_rn(a, s, corrections: int = 2):
    """The fast path's quotient: RN(a * y) with y = RN(1 / s), then
    ``corrections`` Markstein steps q <- RN(q + RN(a - s q) y)."""
    y = 1.0 / s
    q = a * y
    for _ in range(corrections):
        q = fma(fma(-s, q, a), y, q)
    return q


def t_bits(a, s, corrections: int = 2):
    """The bits of t = RN(max(q, 0) + 1.5 * 2**23): ROUND_BITS + the code."""
    t = torch.fmax(div_rn(a, s, corrections), torch.zeros((), dtype=F32))
    return (t + torch.tensor(ROUND, dtype=F32)).view(torch.int32).to(torch.int64)


def col_scale(mn, mx, bits):
    inv = torch.tensor(1.0 / (2 ** bits - 1), dtype=F32)
    return torch.clamp_min((mx - mn) * inv, 1e-8)       # NaN stays NaN


def to_int32(words):
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def word_of(tb, shift):
    """Each t's bits added at its code's position, ROUND's bits at every
    position subtracted once (mod 2**32): the OR of the codes."""
    return ((tb << shift).sum(-1) - (ROUND_BITS << shift).sum()) & 0xFFFFFFFF


def emulate(x, bits: int, *, layout: str = "kernel", mutation: str = ""):
    """(packed, scale, zero) as ``csrc/quant_pack.cu`` computes them.
    ``layout="plain"`` packs by whole words from the columns in order with
    the IEEE division (the scalar kernel) whatever the route."""
    N, n, d = x.shape
    bf16 = x.dtype == torch.bfloat16
    xf = x.to(F32)
    per = 32 // bits
    L = d // per
    R = route(n, d, bf16) if layout == "kernel" else None
    if R is None:                                      # the scalar kernel: whole words
        mn, mx = fold(xf, torch.ones_like(xf, dtype=torch.bool), 1)
        scale = col_scale(mn, mx, bits)
        code = round_code((xf - mn[:, None]) / scale[:, None], bits).reshape(N, n, L, per)
        words = (code << (torch.arange(per) * bits)).sum(-1)
        return to_int32(words), scale, mn

    vec = 8 if bf16 else 4
    QS = SLAB // vec
    RG = VEC_THREADS // QS
    G = max(per // vec, 1)
    tid = torch.arange(VEC_THREADS)
    q, ty = tid % QS, tid // QS
    rows = ty[:, None] + torch.arange(R)[None, :] * RG                  # [128, R]
    slots = q[:, None] * vec + torch.arange(vec)[None, :]                # [128, vec] in the slab
    packed = torch.full((N, n, L), -1, dtype=torch.int64)
    writes = torch.zeros((N, n, L), dtype=torch.int64)
    scale = torch.full((N, d), float("nan"), dtype=F32)
    zero = torch.full((N, d), float("nan"), dtype=F32)
    stat_writes = torch.zeros(d, dtype=torch.int64)
    for slab in range(-(-d // SLAB)):                  # blockIdx.y
        c0 = slab * SLAB + q * vec
        col = c0 < d
        live = col[:, None] & (rows < n)
        cols = slab * SLAB + slots
        regs = xf[:, rows.clamp(max=n - 1)[:, :, None], cols.clamp(max=d - 1)[:, None, :]]
        mn, mx = fold(regs, live[None, :, :, None].expand(regs.shape), 2)   # [N, 128, vec]
        s_mn = torch.empty((N, RG, SLAB), dtype=F32)                      # every row group
        s_mx = torch.empty((N, RG, SLAB), dtype=F32)
        s_mn[:, ty[:, None], slots], s_mx[:, ty[:, None], slots] = mn, mx
        z_col = torch.minimum(s_mn[:, 0::2].amin(1), s_mn[:, 1::2].amin(1))  # warp 0
        s_col = col_scale(z_col, torch.maximum(s_mx[:, 0::2].amax(1), s_mx[:, 1::2].amax(1)),
                          bits)
        c_all = slab * SLAB + torch.arange(SLAB)
        keep = c_all < d
        scale[:, c_all[keep]], zero[:, c_all[keep]] = s_col[:, keep], z_col[:, keep]
        stat_writes[c_all[keep]] += 1

        a = regs - z_col[:, slots][:, :, None, :]
        corrections = {"no correction": 0, "one correction": 1}.get(mutation, 2)
        tb = t_bits(a, s_col[:, slots][:, :, None, :], corrections)
        if bf16 and bits == 8:                         # two whole words per thread and row
            shift = 8 * torch.arange(4)
            pair = torch.stack([word_of(tb[..., :4], shift), word_of(tb[..., 4:], shift)], -1)
            for th, i in torch.nonzero(live).tolist():
                w = int(c0[th]) // 4
                packed[:, rows[th, i], w:w + 2] = pair[:, th, i]
                writes[:, rows[th, i], w:w + 2] += 1
            continue
        base = (c0 % per) * bits                                         # [128]
        if mutation == "reversed lanes" and G > 1:
            base = (c0 // vec // G * G * vec + (G - 1 - q % G) * vec) % per * bits
        step = 1 if mutation == "column shift" else bits
        word = word_of(tb, torch.arange(vec) * step)                     # [N, 128, R]
        word = (word << base[None, :, None]) & 0xFFFFFFFF
        if mutation != "no OR":
            o = 1
            while o < G:                               # __shfl_xor_sync over the word's lanes
                word = word | word[:, tid ^ o]
                o <<= 1
        store = live & (q % G == 0)[:, None]
        for th, i in torch.nonzero(store).tolist():
            w = int(c0[th]) // per
            packed[:, rows[th, i], w] = word[:, th, i]
            writes[:, rows[th, i], w] += 1
    assert bool((writes == 1).all()), "every word stored exactly once"
    assert bool((stat_writes == 1).all()), "every column's stats stored exactly once"
    return to_int32(packed), scale, zero


def layout_input(shape, dtype, seed):
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    x[0, :, 3] = 1.5                                    # the 1e-8 scale floor
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", QP_SHAPES + SLAB_SHAPES,
                         ids=["x".join(map(str, s)) for s in QP_SHAPES + SLAB_SHAPES])
def test_kernel_layout_emulation_matches_plain_version(shape, bits, dtype):
    x = layout_input(shape, dtype, seed=bits + shape[2])
    got = emulate(x, bits)
    for g, w in zip(got, ref.quant_pack_ref(x, bits)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    routed = route(shape[1], shape[2], dtype == torch.bfloat16)
    assert (routed is None) == (shape in SLAB_SHAPES)


@pytest.mark.parametrize("dtype", [F32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_kernel_layout_emulation_on_non_finite_input(bits, dtype):
    x = torch.from_numpy(non_finite((3, 64, 128), seed=bits)).to(dtype)
    for g, w in zip(emulate(x, bits), ref.quant_pack_ref(x, bits)):
        nan_equal(g.numpy(), w.numpy())


def test_route_takes_every_card_shape_and_sends_the_rest_to_the_scalar_kernel():
    assert [route(n, d, bf) for (_, n, d) in QP_SHAPES for bf in (False, True)] == [
        4, 2, 1, 1, 4, 2, 2, 1, 1, 1]
    assert route(64, 12, True) is None                  # bf16, d % 8 == 4 (8 bits only)
    assert route(64, 12, False) == 4
    assert route(257, 128, False) is None and route(256, 128, False) == MAX_ROWS
    assert route(512, 128, True) == MAX_ROWS and route(513, 128, True) is None


@pytest.mark.parametrize("mutation", ["reversed lanes", "column shift", "no OR"])
@pytest.mark.parametrize("bits", [2, 4])
def test_kernel_layout_emulation_fails_with_a_wrong_lane_shift_or_order(mutation, bits):
    """f32 at 2 and 4 bits spreads a word over 4 and 2 lanes: a reversed lane
    order, a shift counted in columns instead of bits, or a missing OR
    across lanes each changes the packed words (the stats stay)."""
    x = layout_input((2, 16, 64), F32, seed=bits)
    got, want = emulate(x, bits, mutation=mutation), ref.quant_pack_ref(x, bits)
    assert not torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def near_half_quotients(bits: int):
    """Seeded column ranges [0, top] and, for each, values a = RN((k + 1/2) s)
    and their f32 neighbours, whose quotients a / s sit on a half-integer's
    edge (where one rounding decides the code); flattened (a, s, top)."""
    rs = np.random.RandomState(bits)
    top = torch.from_numpy(rs.uniform(0.25, 8.0, 4096).astype(np.float32))
    s = col_scale(torch.zeros_like(top), top, bits)
    k = torch.arange(2 ** bits - 1, dtype=F32) + 0.5
    a = (k[None, :] * s[:, None]).reshape(-1)
    a = torch.cat([a, torch.nextafter(a, a + 1), torch.nextafter(a, a - 1)])
    return a, s.repeat_interleave(len(k)).repeat(3), top.repeat_interleave(len(k)).repeat(3)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_quotient_by_reciprocal_and_two_corrections_is_the_ieee_quotient(bits):
    """The fast path's q equals RN(a / s) bit for bit on quotients at a
    half-integer's edge and on seeded uniform ones; RN(a * RN(1 / s))
    alone does not, and its codes differ there."""
    a_edge, s_edge, _ = near_half_quotients(bits)
    rs = np.random.RandomState(10 + bits)
    s_uni = col_scale(torch.zeros(200_000), torch.from_numpy(
        rs.uniform(1e-3, 100.0, 200_000).astype(np.float32)), bits)
    a_uni = torch.from_numpy(rs.uniform(0, 1, 200_000).astype(np.float32)) * s_uni * (2 ** bits - 1)
    for a, s in ((a_edge, s_edge), (a_uni, s_uni)):
        assert torch.equal(div_rn(a, s).view(torch.int32), (a / s).view(torch.int32))
    alone = div_rn(a_edge, s_edge, corrections=0)
    assert not torch.equal(alone, a_edge / s_edge)
    assert not torch.equal(round_code(alone, bits), round_code(a_edge / s_edge, bits))


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_codes_at_half_integer_edges_match_the_plain_version(bits):
    """A column of 0, its max and values whose quotients sit on a
    half-integer's edge: the emulated kernel equals the plain version, and
    without the corrections (the reciprocal product alone) it does not."""
    a, s, top = near_half_quotients(bits)
    differ = round_code(div_rn(a, s, corrections=0), bits) != round_code(a / s, bits)
    j = int(torch.nonzero(differ)[0])
    same_col = torch.nonzero(differ & (top == top[j])).flatten()[:6]
    x = torch.zeros(1, 8, 32, dtype=F32)
    x[0, 1, :] = top[j]
    x[0, 2:2 + len(same_col), 0] = a[same_col]
    want = ref.quant_pack_ref(x, bits)
    assert float(want[1][0, 0]) == float(s[j])          # the column's scale is the searched s
    for g, w in zip(emulate(x, bits), want):
        assert torch.equal(g, w)
    assert not torch.equal(emulate(x, bits, mutation="no correction")[0], want[0])


# ---------------------------------------------------------------------------
# gear_compress on NaN tiles


def nan_tiles(per_channel: bool, n_out: int) -> np.ndarray:
    """bf16-representable normals (the residual is then exact on both
    sides); tile 0: a K channel (V token) with 2 n_out + 1 NaNs and another
    with one; tile 1 all NaN."""
    x = np.random.RandomState(n_out).randn(3, 64, 128).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    many = np.arange(2 * n_out + 1) * 5
    if per_channel:
        x[0, many, 7] = np.nan
        x[0, 30, 9] = np.nan
    else:
        x[0, 7, many] = np.nan
        x[0, 30, 100] = np.nan
    x[1] = np.nan
    return x


@pytest.mark.parametrize("kind", ["k", "v"])
@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_compress_plain_version_equals_pallas_kernel_on_nan_tiles(polname, kind):
    from repro_torch.core.outlier import outlier_count

    pol = named_policy(polname)
    scheme, group = pol.scheme_for(kind)
    per_channel = scheme == "per_channel"
    length = 64 if per_channel else 128
    kw = dict(bits=pol.bits, scheme=scheme, group=group,
              n_out=outlier_count(length, pol.sparsity), stat_dtype=pol.stat_dtype)
    x = nan_tiles(per_channel, kw["n_out"])
    got = ref.gear_compress_ref(torch.from_numpy(x), **kw)
    want = j_gear_compress(jnp.asarray(x), interpret=True, **kw)
    for name, g, w in zip(("packed", "scale", "zero", "sp_val", "sp_idx", "resid"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    scale, sp_idx = got[1], got[4]
    assert bool(torch.isnan(scale[1]).all()) and not bool(torch.isnan(scale[2]).any())
    for vec in (7, 9 if per_channel else 30):
        assert bool((sp_idx[0, vec] == length).all())   # (NaN, its length): nothing taken out
    assert bool((sp_idx[2] < length).all())


def test_iterative_topk_equals_reference_on_nan_vectors():
    x = np.random.RandomState(0).randn(4, 6, 16).astype(np.float32)
    x[0, 2, 5] = np.nan
    x[1, :, 3] = np.nan
    x[2] = np.nan
    for k in (1, 3):
        got = ol.iterative_topk(torch.from_numpy(x), k, dim=-1)
        want = j_outlier.iterative_topk(jnp.asarray(x), k, axis=-1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool((got[1][0, 2] == 16).all()) and bool((got[1][0, 1] < 16).all())
