"""The arithmetic of the redesigned ``flash_prefill_block`` and
``gear_compress`` kernels, emulated in plain PyTorch on the CPU and held
against the JAX reference.

``csrc/flash_prefill_block.cu`` and ``csrc/gear_compress.cu`` run only on a
card.  What they compute differently from the plain versions -- the order
and precision of the attention products, which key blocks are computed, how
outliers are selected and codes packed -- is emulated here on numpy-seeded
inputs that go through the reference too (``repro.kernels.ref`` jitted, and
the Pallas kernels in interpret mode):

* ``flash_prefill_block``: a warp per 16-row query tile computes only the
  key blocks of 8 that a row of the tile can see (the causal diagonal and
  kv_len, rounded up to an even count), the scores and P.V on TF32 tensor
  cores with both operands split hi + lo and three products per k-step of 8
  (lo.lo dropped), P taken straight from the score tile; held within 1e-4
  (``chip_smoke.BLOCK_TOL``) on the normalized output and the score max.
  One TF32 product alone fails that where keys share a large component the
  queries are orthogonal to.  The shared-memory layouts (K rows padded by 4
  floats and read in the permuted key order, V rows padded by 8 and read
  through the permuted output columns) give every 16-byte fragment read of
  a quarter-warp eight distinct bank groups.
* ``gear_compress``: K orientation, a thread per channel keeps its best k
  per extreme in a sorted list during one scan; V orientation, eight lanes
  per token keep lists of their channels and pick the k winners by a
  3-round xor tournament (the winner's lane pops); both pack codes from
  4-channel quads OR-reduced over per / 4 lanes.  Held bit for bit against
  ``ref.gear_compress_ref`` (the port's and the reference's) and the Pallas
  kernel in interpret mode, with ties: a constant channel and a constant
  token, where the top and bottom outliers share an index.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill_block as j_flash_block  # noqa: E402
from repro.kernels.gear_compress import gear_compress as j_gear_compress  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32 = torch.float32
NEG_INF = -1e30
BLOCK_TOL = 1e-4
TMAX = 64            # rows of a block
KPAD, VPAD = 4, 8    # shared-memory row padding of K and V (floats)
NKB_STEP = 2         # key blocks are computed in steps of two


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor-core operand keeps of an f32 value."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(F32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


# ---------------------------------------------------------------------------
# flash_prefill_block


def key_blocks(tile: int, T: int, length: int) -> int:
    n = min(2 * (tile + 1), (min(length, T) + 7) // 8) if length > 0 else (T + 7) // 8
    return min(8, -(-n // NKB_STEP) * NKB_STEP)


def k_steps(Dh: int):
    """The columns of each mma k-step of 8, in the kernel's order: q chunks
    of 64 columns, then 16-column groups j whose float4 per lane (tg) feeds
    k-step 2 j (its x, y) and 2 j + 1 (z, w)."""
    steps = []
    for j in range(Dh // 16):
        for st in range(2):
            steps.append([16 * j + 4 * tg + 2 * st + e for tg in range(4) for e in range(2)])
    return steps


def emulate_block(q, k, v, kv_len, *, scale, softcap=0.0, kv_repeat=1, lo=True):
    """``flash_block_kernel``'s arithmetic: (acc, m, l) of every row group."""
    N, T, Dh = q.shape
    kr = torch.zeros(N, TMAX, Dh, dtype=F32)
    vr = torch.zeros(N, TMAX, Dh, dtype=F32)
    kr[:, :T] = k.repeat_interleave(kv_repeat, 0)
    vr[:, :T] = v.repeat_interleave(kv_repeat, 0)
    qp = torch.zeros(N, TMAX, Dh, dtype=F32)
    qp[:, :T] = q
    acc = torch.zeros(N, T, Dh, dtype=F32)
    m = torch.zeros(N, T, dtype=F32)
    l = torch.zeros(N, T, dtype=F32)
    steps = k_steps(Dh)
    for n in range(N):
        length = int(kv_len[n])
        for tile in range(-(-T // 16)):
            rows = torch.arange(16 * tile, 16 * tile + 16)
            keys = torch.arange(8 * key_blocks(tile, T, length))
            qt, kt, vt = qp[n, rows], kr[n, keys], vr[n, keys]
            s = torch.zeros(16, len(keys), dtype=F32)
            for cols in steps:                        # k-steps of 8 in order
                qh, ql = split(qt[:, cols])
                kh, kl = split(kt[:, cols])
                if lo:
                    s = s + ql @ kh.T
                    s = s + qh @ kl.T
                s = s + qh @ kh.T
            s = s * scale
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            seen = (keys[None] <= rows[:, None]) & (keys[None] < length)
            s = torch.where(keys[None] >= T, torch.tensor(-float("inf")),
                            torch.where(seen, s, torch.tensor(NEG_INF)))
            mx = s.amax(-1)
            p = torch.exp(s - mx[:, None])
            o = torch.zeros(16, Dh, dtype=F32)
            for kb in range(len(keys) // 8):          # P.V, a k-step per key block
                blk = slice(8 * kb, 8 * kb + 8)
                ph, pl = split(p[:, blk])
                vh, vl = split(vt[blk])
                if lo:
                    o = o + pl @ vh
                    o = o + ph @ vl
                o = o + ph @ vh
            live = rows < T
            acc[n, rows[live]] = o[live]
            m[n, rows[live]] = mx[live]
            l[n, rows[live]] = p.sum(-1)[live]
    return acc, m, l


def block_inputs(seed, N, T, Dh, rep, lens):
    rng = np.random.RandomState(seed)
    q = rng.randn(N, T, Dh).astype(np.float32)
    k = rng.randn(N // rep, T, Dh).astype(np.float32)
    v = rng.randn(N // rep, T, Dh).astype(np.float32)
    kv_len = {"one": np.ones(N), "full": np.full(N, T)}[lens].astype(np.int32)
    return q, k, v, kv_len


def normalized(acc, m, l):
    return np.asarray(acc) / np.asarray(l)[..., None], np.asarray(m)


def assert_block_close(got, want):
    for a, b in zip(normalized(*got), normalized(*want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=BLOCK_TOL)


@pytest.mark.parametrize("T", [64, 37])
@pytest.mark.parametrize("rep", [1, 4])
@pytest.mark.parametrize("lens", ["one", "full"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_block_emulation_matches_reference_and_pallas_kernel(T, rep, lens, softcap):
    N, Dh = 8, 64
    q, k, v, kv_len = block_inputs(T + rep, N, T, Dh, rep, lens)
    kw = dict(scale=Dh ** -0.5, softcap=softcap)
    got = [x.numpy() for x in emulate_block(*map(torch.from_numpy, (q, k, v, kv_len)), **kw,
                                            kv_repeat=rep)]
    kr, vr = (jnp.repeat(jnp.asarray(a), rep, 0) for a in (k, v))
    want = jref.flash_block_ref(jnp.asarray(q), kr, vr, jnp.asarray(kv_len), **kw)
    assert_block_close(got, want)
    acc_i, m_i, l_i = j_flash_block(jnp.asarray(q), kr, vr, jnp.asarray(kv_len), **kw,
                                    interpret=True)
    assert_block_close(got, (acc_i, m_i[..., 0], l_i[..., 0]))
    plain = ref.flash_block_ref(*map(torch.from_numpy, (q, k, v, kv_len)), **kw, kv_repeat=rep)
    assert_block_close(got, [x.numpy() for x in plain])


def test_block_emulation_at_a_nonpositive_kv_len():
    """kv_len 0 masks every score: every row then sums all T keys at
    weight 1, as the reference does, so no key block may be skipped."""
    q, k, v, _ = block_inputs(3, 4, 40, 64, 1, "one")
    kv_len = np.array([0, 3, 40, 0], np.int32)
    t = [torch.from_numpy(a) for a in (q, k, v, kv_len)]
    got = [x.numpy() for x in emulate_block(*t, scale=0.125)]
    want = [x.numpy() for x in ref.flash_block_ref(*t, scale=0.125)]
    assert_block_close(got, want)


def test_block_lo_half_is_needed():
    """Keys with a large shared component that every query is orthogonal
    to: the three products hold BLOCK_TOL, one TF32 product does not."""
    N, T, Dh = 4, 64, 64
    q, k, v, kv_len = block_inputs(11, N, T, Dh, 1, "full")
    common = np.random.RandomState(2).randn(Dh).astype(np.float32)
    common /= np.linalg.norm(common)
    k = (k + 100.0 * common).astype(np.float32)
    q = (4.0 * (q - (q @ common)[..., None] * common)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v, kv_len)]
    want = [x.numpy() for x in ref.flash_block_ref(*t, scale=Dh ** -0.5)]
    assert_block_close([x.numpy() for x in emulate_block(*t, scale=Dh ** -0.5)], want)
    one = normalized(*[x.numpy() for x in emulate_block(*t, scale=Dh ** -0.5, lo=False)])
    assert np.abs(one[0] - normalized(*want)[0]).max() > 10 * BLOCK_TOL


def bank_groups(addresses):
    """16-byte bank group (of 8) of each float address of a 16-byte read."""
    return [(a // 4) % 8 for a in addresses]


@pytest.mark.parametrize("Dh", [64, 128, 256])
def test_fragment_reads_are_conflict_free(Dh):
    """Every quarter-warp (8 lanes) of every 16-byte shared-memory read
    touches 8 distinct bank groups: the q.k B fragments (lane (g, tg) reads
    K row 8 kb + g / 2 + 4 (g % 2) at column c0 + 16 j + 4 tg, rows padded
    by KPAD) and the P.V B fragments (lane (g, tg) reads V rows 8 kb + tg
    and 8 kb + tg + 4 at column p0 + 32 J + 4 g, rows padded by VPAD)."""
    KS, VS = Dh + KPAD, Dh + VPAD
    lanes = [(lane // 4, lane % 4) for lane in range(32)]
    for quarter in range(4):
        ql = lanes[8 * quarter: 8 * quarter + 8]
        for kb in range(8):
            for col0 in range(0, Dh, 16):
                ka = [(8 * kb + g // 2 + 4 * (g % 2)) * KS + col0 + 4 * tg for g, tg in ql]
                assert len(set(bank_groups(ka))) == 8
            for col0 in range(0, Dh, 32):
                for extra in (0, 4):
                    va = [(8 * kb + tg + extra) * VS + col0 + 4 * g for g, tg in ql]
                    assert len(set(bank_groups(va))) == 8


# ---------------------------------------------------------------------------
# gear_compress


def beats(v, i, bv, bi):
    return (v > bv) | ((v == bv) & (i < bi))


class Lists:
    """Sorted best-KCAP (value, index) lists, many at once (the kernel's
    ``Best``, one per thread or lane), with its branch-free insertion."""

    NONE = 2 ** 31 - 1

    def __init__(self, shape, kcap):
        self.v = torch.full(shape + (kcap,), -float("inf"), dtype=F32)
        self.i = torch.full(shape + (kcap,), self.NONE, dtype=torch.int64)

    def push(self, x, idx):
        idx = torch.as_tensor(idx, dtype=torch.int64).expand(x.shape)
        b = beats(x[..., None], idx[..., None], self.v, self.i)
        v, i = self.v.clone(), self.i.clone()
        for q in range(self.v.shape[-1] - 1, 0, -1):
            v[..., q] = torch.where(b[..., q - 1], self.v[..., q - 1],
                                    torch.where(b[..., q], x, self.v[..., q]))
            i[..., q] = torch.where(b[..., q - 1], self.i[..., q - 1],
                                    torch.where(b[..., q], idx, self.i[..., q]))
        v[..., 0] = torch.where(b[..., 0], x, self.v[..., 0])
        i[..., 0] = torch.where(b[..., 0], idx, self.i[..., 0])
        self.v, self.i = v, i

    def pick(self):
        """The kernel's ``pick`` over lanes on the second-to-last axis (8):
        three xor rounds; every lane gets the winner, whose lane pops it."""
        bv, bi = self.v[..., 0], self.i[..., 0]
        lane = torch.arange(8)
        for o in (4, 2, 1):
            ov, oi = bv[..., lane ^ o], bi[..., lane ^ o]
            win = beats(ov, oi, bv, bi)
            bv, bi = torch.where(win, ov, bv), torch.where(win, oi, bi)
        pop = self.i[..., 0] == bi
        shifted_v = torch.cat([self.v[..., 1:], torch.full_like(self.v[..., :1], -float("inf"))], -1)
        shifted_i = torch.cat([self.i[..., 1:], torch.full_like(self.i[..., :1], self.NONE)], -1)
        self.v = torch.where(pop[..., None], shifted_v, self.v)
        self.i = torch.where(pop[..., None], shifted_i, self.i)
        return bi[..., 0]


def kcap(n_out: int) -> int:
    return 1 if n_out <= 1 else 2 if n_out <= 2 else 4 if n_out <= 4 else 8


def stat_round(s, stat_dtype):
    return s.to(torch.bfloat16).to(F32) if stat_dtype == "bfloat16" else s


def emulate_compress(x, *, bits, scheme, group=None, n_out=0, stat_dtype="bfloat16"):
    """``gear_compress_kernel``'s algorithm, every floating step an IEEE f32
    operation as the kernel's round-to-nearest intrinsics are."""
    N, nb, d = x.shape
    per_channel = scheme == "per_channel"
    group = group or (nb if per_channel else d)
    inv = torch.tensor(1.0 / (2 ** bits - 1), dtype=F32)
    flag = torch.zeros(N, nb, d, dtype=torch.bool)
    sp_val = sp_idx = None
    if n_out:
        sp_rows = d if per_channel else nb
        sp_val = torch.zeros(N, sp_rows, 2 * n_out, dtype=F32)
        sp_idx = torch.zeros(N, sp_rows, 2 * n_out, dtype=torch.int32)
        if per_channel:                       # a thread per channel, one scan of its tokens
            top, bot = Lists((N, d), kcap(n_out)), Lists((N, d), kcap(n_out))
            for t in range(nb):
                top.push(x[:, t], t)
                bot.push(-x[:, t], t)
            chosen = [top.i[..., :n_out], bot.i[..., :n_out]]
            for half, idx in enumerate(chosen):
                sp_idx[..., half * n_out:(half + 1) * n_out] = idx.to(torch.int32)
                sp_val[..., half * n_out:(half + 1) * n_out] = torch.gather(
                    x.transpose(1, 2), 2, idx)
                flag.transpose(1, 2).scatter_(2, idx, True)
        else:                                 # eight lanes per token, strided quads
            quads = -(-(d // 4) // 8)
            top = Lists((N, nb, 8), kcap(n_out))
            bot = Lists((N, nb, 8), kcap(n_out))
            lane = torch.arange(8)
            for kq in range(quads):
                for e in range(4):
                    c = 4 * (lane + 8 * kq) + e
                    ok = c < d
                    val = torch.where(ok, x[:, :, c.clamp(max=d - 1)], -float("inf"))
                    nval = torch.where(ok, -x[:, :, c.clamp(max=d - 1)], -float("inf"))
                    cc = torch.where(ok, c, Lists.NONE)
                    top.push(val, cc)
                    bot.push(nval, cc)
            for j in range(n_out):
                for half, lists in ((0, top), (1, bot)):
                    idx = lists.pick()
                    sp_idx[..., half * n_out + j] = idx.to(torch.int32)
                    sp_val[..., half * n_out + j] = torch.gather(x, 2, idx[..., None])[..., 0]
                    flag.scatter_(2, idx[..., None], True)
    r = torch.where(flag, torch.zeros((), dtype=F32), x)
    if per_channel:
        rg = r.reshape(N, nb // group, group, d)
        mn, mx = rg.amin(2), rg.amax(2)
    else:
        rg = r.reshape(N, nb, d // group, group)
        mn, mx = rg.amin(3), rg.amax(3)
    scale = torch.clamp_min((mx - mn) * inv, 1e-8)
    zero = mn
    # codes, packing and residual: a thread per 4-channel quad
    if per_channel:
        s_full = scale.repeat_interleave(group, 1)
        z_full = zero.repeat_interleave(group, 1)
    else:
        s_full = scale.repeat_interleave(group, 2)
        z_full = zero.repeat_interleave(group, 2)
    code = torch.clamp(torch.round((r - z_full) / s_full), 0, 2 ** bits - 1)
    deq = code * stat_round(s_full, stat_dtype) + stat_round(z_full, stat_dtype)
    resid = (x - deq) - torch.where(flag, x, torch.zeros((), dtype=F32))
    per = 32 // bits
    q = code.to(torch.int64).reshape(N, nb * d // 4, 4)          # quads, row-major
    e = torch.arange(q.shape[1])
    shift = (4 * (e % (per // 4)))[:, None] + torch.arange(4)[None]
    partial = (q << (shift * bits)).sum(-1)                         # the lane's word bits
    words = partial.reshape(N, -1, per // 4).sum(-1)                # OR over per / 4 lanes
    packed = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    return packed.reshape(N, nb, d // per), scale, zero, sp_val, sp_idx, resid


def compress_input(seed, shape):
    """bf16-representable f32 values (what the cache compresses), with a
    constant channel and a constant token."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    x[0, :, 3] = 0.75
    x[1, 5, :] = -1.5
    return x


def assert_outputs_equal(got, want):
    names = ("packed", "scale", "zero", "sp_val", "sp_idx", "resid")
    for name, a, b in zip(names, got, want):
        if a is None or b is None:
            assert a is None and b is None, name
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("scheme,group", [("per_channel", None), ("per_token", None),
                                          ("per_token", 32)])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("n_out", [1, 2, 8])
def test_compress_emulation_matches_reference_bit_for_bit(scheme, group, bits, n_out):
    x = compress_input(bits * 10 + n_out, (3, 64, 128))
    kw = dict(bits=bits, scheme=scheme, group=group, n_out=n_out)
    got = [None if a is None else a.numpy() for a in emulate_compress(torch.from_numpy(x), **kw)]
    want = jax.jit(lambda a: jref.gear_compress_ref(a, **kw))(jnp.asarray(x))
    assert_outputs_equal(got, want)
    plain = ref.gear_compress_ref(torch.from_numpy(x), **kw)
    assert_outputs_equal(got, [None if a is None else a.numpy() for a in plain])


@pytest.mark.parametrize("scheme", ["per_channel", "per_token"])
@pytest.mark.parametrize("bits,n_out", [(2, 8), (4, 1), (8, 2)])
def test_compress_emulation_matches_pallas_kernel(scheme, bits, n_out):
    x = compress_input(bits + n_out, (2, 64, 128))
    kw = dict(bits=bits, scheme=scheme, n_out=n_out)
    got = [None if a is None else a.numpy() for a in emulate_compress(torch.from_numpy(x), **kw)]
    assert_outputs_equal(got, j_gear_compress(jnp.asarray(x), interpret=True, **kw))


def test_compress_emulation_picks_set_semantics_on_ties():
    """A constant vector: top and bottom both pick its lowest indices, each
    position one outlier, its value the entry itself."""
    x = compress_input(7, (2, 64, 128))
    for scheme, tile, row in (("per_channel", 0, 3), ("per_token", 1, 5)):
        _, _, _, sp_val, sp_idx, _ = emulate_compress(torch.from_numpy(x), bits=4,
                                                      scheme=scheme, n_out=2)
        assert sp_idx[tile, row].tolist() == [0, 1, 0, 1]
        assert sp_val[tile, row].tolist() == [float(x[tile, 0, row] if scheme == "per_channel"
                                                    else x[tile, row, 0])] * 4
