"""The arithmetic of the redesigned ``linear_scan_chunked`` kernel, emulated
in plain PyTorch on the CPU and held against the JAX reference.

``csrc/linear_scan.cu`` runs only on a card.  What it computes differently
from the plain version -- the order and precision of its arithmetic -- is
emulated here regime by regime, on numpy-seeded inputs that go through the
reference too (``repro.models.linear_scan.chunked_scan``, and its Pallas
``linear_scan_chunked`` in interpret mode, which starts from a zero state
only):

* the step regime (chunk = 1, RWKV6's decode step): the closed form
  y = q_fac S + c v, S' = S e^{max(log w, -30)} + k v^T, token by token;
* the chunked regime: ``scan_factors``' segmented cumsum (16 segments of 8
  rows per 128-row tile; the carry into a tile and cum_last summed per
  segment over the tiles, then over the segments), its factor arrays and
  each 128-row tile's state increment; ``scan_states``' fixed-order
  sum of the increments and its chunk-start states; ``scan_tiles``'
  products per 64-row query tile -- the cross term q_fac S_c, q_fac
  k_fac^T and att v.  Every product (the increments too) runs with both
  operands split into TF32 hi + lo halves
  (hi the top 10 mantissa bits, lo the rest, of which the tensor cores read
  the top bits again; three products, lo.lo dropped).

Tolerance: ``chip_smoke.py``'s ``row_err``, 2e-3 x max(1, max |row|) for
every row (a token of y, a Dk row of the state) and 2e-3 x max(1, max |x|)
over the whole output.  One TF32 product alone (the lo halves dropped)
fails it where keys share a large component that the queries are nearly
orthogonal to.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax.numpy as jnp  # noqa: E402

from repro.kernels.linear_scan_kernel import linear_scan_chunked as ref_scan_kernel  # noqa: E402
from repro.models import linear_scan as ref_ls  # noqa: E402

F32 = torch.float32
CLAMP = 30.0
TILE = 64            # rows of a query or key tile (scan_tiles)
FAC_ROWS = 128       # rows of a factor-pass tile (scan_factors): 16 segments of 8
ROW_TOL = 2e-3


def tf32(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor-core operand keeps of an f32 value: the sign, the
    exponent and the top 10 mantissa bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(F32)


def split(x: torch.Tensor):
    """The kernel's split: hi = the top bits, lo = x - hi (exact in f32), of
    which the tensor cores read the top bits again."""
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm3(a: torch.Tensor, b: torch.Tensor, lo: bool = True) -> torch.Tensor:
    """a @ b as ``mma3`` runs it: lo.hi + hi.lo + hi.hi in f32 (with
    ``lo=False``, the hi.hi product alone)."""
    ah, al = split(a)
    bh, bl = split(b)
    if not lo:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


# ---------------------------------------------------------------------------
# the emulation


def emulate_step(r, k, v, lw, u, state0, bonus: bool):
    """``scan_step``: the chunk = 1 closed form, one token after another."""
    BH, S, Dk = r.shape
    st = torch.zeros(BH, Dk, v.shape[-1], dtype=F32) if state0 is None else state0.clone()
    lwb = torch.broadcast_to(lw, r.shape)
    ys = []
    for t in range(S):
        rr, kk, vv, w = r[:, t], k[:, t], v[:, t], lwb[:, t]
        dec = torch.exp(torch.clamp(w, min=-CLAMP))
        if bonus:
            q, coef = rr, (rr * u * kk).sum(-1)
        else:
            q = rr * dec
            coef = (q * (kk * torch.exp(torch.clamp(-w, max=CLAMP)))).sum(-1)
        ys.append((q[..., None] * st).sum(-2) + coef[:, None] * vv)
        st = st * dec[..., None] + kk[..., None] * vv[:, None, :]
    return torch.stack(ys, 1), st


def emulate_factors(r, k, lw, W: int, bonus: bool):
    """``scan_factors``: the chunk-relative cumsum as a segmented scan, then
    q_fac, k_fac, k_state and e^{max(cum_last, -30)} per chunk."""
    BH, S, Dk = r.shape
    C = S // W
    lwb = torch.broadcast_to(lw, r.shape)
    cum = torch.empty(BH, S, Dk, dtype=F32)
    last = torch.empty(BH, C, Dk, dtype=F32)
    n = -(-W // FAC_ROWS) * FAC_ROWS
    for c in range(C):
        w = torch.zeros(BH, n, Dk, dtype=F32)
        w[:, :W] = lwb[:, c * W:(c + 1) * W]
        tiles = w.reshape(BH, n // FAC_ROWS, 16, 8, Dk)
        seg = tiles.sum(3)                                   # [BH, tiles, 16, Dk]
        # per segment over the tiles before (or all tiles), then over segments
        carry = (torch.cumsum(seg, 1) - seg).sum(2)          # [BH, tiles, Dk]
        seg_before = torch.cumsum(seg, 2) - seg
        cum_t = (carry[:, :, None, None] + seg_before[:, :, :, None]) + torch.cumsum(tiles, 3)
        cum[:, c * W:(c + 1) * W] = cum_t.reshape(BH, n, Dk)[:, :W]
        last[:, c] = seg.sum(1).sum(1)
    lw_c = lwb.reshape(BH, C, W, Dk)
    cum_c = cum.reshape(BH, C, W, Dk)
    q_cum = cum_c - lw_c if bonus else cum_c
    qf = r.reshape(BH, C, W, Dk) * torch.exp(torch.clamp(q_cum, min=-CLAMP))
    kf = k.reshape(BH, C, W, Dk) * torch.exp(torch.clamp(-cum_c, max=CLAMP))
    ks = k.reshape(BH, C, W, Dk) * torch.exp(torch.clamp(last[:, :, None] - cum_c, min=-CLAMP))
    decay = torch.exp(torch.clamp(last, min=-CLAMP))
    return qf, kf, ks, decay


def emulate_chunked(r, k, v, lw, u, state0, W: int, bonus: bool, lo: bool = True):
    """``scan_factors`` -> ``scan_states`` -> ``scan_tiles``."""
    BH, S, Dk = r.shape
    Dv = v.shape[-1]
    C, nt, n128 = S // W, -(-W // TILE), -(-W // FAC_ROWS)
    qf, kf, ks, decay = emulate_factors(r, k, lw, W, bonus)
    vc = v.reshape(BH, C, W, Dv)
    # scan_factors: each 128-row tile's state increment
    part = torch.stack([torch.stack([
        mm3(ks[:, c, i * FAC_ROWS:(i + 1) * FAC_ROWS].transpose(1, 2),
            vc[:, c, i * FAC_ROWS:(i + 1) * FAC_ROWS], lo) for i in range(n128)], 1)
        for c in range(C)], 1)                               # [BH, C, n128, Dk, Dv]
    # scan_states: the chunk-start states, increments added in tile order
    starts = []
    st = torch.zeros(BH, Dk, Dv, dtype=F32) if state0 is None else state0.clone()
    for c in range(C):
        starts.append(st if c > 0 or state0 is not None else None)
        inc = torch.zeros(BH, Dk, Dv, dtype=F32)
        for i in range(n128):
            inc = inc + part[:, c, i]
        st = st * decay[:, c, :, None] + inc
    # scan_tiles: per 64-row query tile, the cross term, then the key tiles
    y = torch.empty(BH, C, W, Dv, dtype=F32)
    for c in range(C):
        for qi in range(nt):
            q = slice(qi * TILE, min(W, (qi + 1) * TILE))
            acc = torch.zeros(BH, q.stop - q.start, Dv, dtype=F32)
            if starts[c] is not None:
                acc = acc + mm3(qf[:, c, q], starts[c], lo)
            for kj in range(qi + 1):
                kk = slice(kj * TILE, min(W, (kj + 1) * TILE))
                att = mm3(qf[:, c, q], kf[:, c, kk].transpose(1, 2), lo)
                if kj == qi:
                    att = att * torch.tril(torch.ones(att.shape[1:], dtype=F32), -int(bonus))
                acc = acc + mm3(att, vc[:, c, kk], lo)
            if bonus:
                rk = (r.reshape(BH, C, W, Dk)[:, c, q] * u[:, None] *
                      k.reshape(BH, C, W, Dk)[:, c, q]).sum(-1)
                acc = acc + rk[..., None] * vc[:, c, q]
            y[:, c, q] = acc
    return y.reshape(BH, S, Dv), st


def emulate(r, k, v, lw, u=None, *, chunk: int, mode: str, state0=None, lo: bool = True):
    """The kernel's arithmetic for one ``linear_scan_chunked`` call."""
    bonus = mode == "bonus"
    if chunk == 1:
        return emulate_step(r, k, v, lw, u, state0, bonus)
    return emulate_chunked(r, k, v, lw, u, state0, chunk, bonus, lo)


# ---------------------------------------------------------------------------
# helpers


def row_err(got: np.ndarray, want: np.ndarray) -> float:
    """Worst ratio, over the rows of the last dim, of the error to 2e-3 x
    max(1, max |want| of that row)."""
    limit = ROW_TOL * np.maximum(np.abs(want).max(-1), 1.0)
    return float((np.abs(got - want).max(-1) / limit).max())


def assert_rows_close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert row_err(got, want) <= 1.0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ROW_TOL * max(1.0, float(np.abs(want).max())))


def inputs(seed: int, BH: int, S: int, Dk: int, Dv: int, per_dk: bool, decay=None):
    rng = np.random.RandomState(seed)
    r = rng.randn(BH, S, Dk).astype(np.float32)
    k = rng.randn(BH, S, Dk).astype(np.float32)
    v = rng.randn(BH, S, Dv).astype(np.float32)
    shape = (BH, S, Dk if per_dk else 1)
    if decay is None:
        lw = -np.logaddexp(0.0, rng.randn(*shape)).astype(np.float32)
    else:
        lw = np.full(shape, decay, np.float32)
    u = (rng.randn(BH, Dk) * 0.5).astype(np.float32)
    s0 = rng.randn(BH, Dk, Dv).astype(np.float32)
    return r, k, v, lw, u, s0


def reference(r, k, v, lw, u, chunk, mode, s0):
    """The reference's ``chunked_scan`` with B = 1 and H = BH heads."""
    y, st = ref_ls.chunked_scan(*(jnp.asarray(a)[None] for a in (r, k, v, lw)), chunk=chunk,
                                u=jnp.asarray(u) if mode == "bonus" else None,
                                state0=None if s0 is None else jnp.asarray(s0)[None], mode=mode)
    return np.asarray(y[0]), np.asarray(st[0])


def run_emulation(r, k, v, lw, u, chunk, mode, s0, lo=True):
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    y, st = emulate(*t, chunk=chunk, mode=mode, lo=lo,
                    state0=None if s0 is None else torch.from_numpy(s0))
    return y.numpy(), st.numpy()


# ---------------------------------------------------------------------------
# tests


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("S,chunk", [(130, 130), (200, 200), (192, 64), (96, 32)],
                         ids=["chunk=S-130", "chunk=S-200", "aligned-64", "aligned-32"])
@pytest.mark.parametrize("per_dk", [False, True], ids=["log_w-1", "log_w-Dk"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero-state", "state0"])
def test_chunked_emulation_matches_reference(mode, S, chunk, per_dk, with_state):
    """The chunked regime against the reference's ``chunked_scan``, at the
    reference's init decay (-0.313 per token), where a chunk of 130 or 200
    passes the e^-30 clamp, and at a random decay."""
    decay = -0.313 if not per_dk else None
    r, k, v, lw, u, s0 = inputs(S + 3 * per_dk + with_state, 3, S, 16, 24, per_dk, decay)
    s0 = s0 if with_state else None
    y_ref, st_ref = reference(r, k, v, lw, u, chunk, mode, s0)
    y, st = run_emulation(r, k, v, lw, u, chunk, mode, s0)
    assert_rows_close(y, y_ref)
    assert_rows_close(st, st_ref)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("S,chunk", [(200, 200), (128, 64)], ids=["chunk=S-200", "aligned-64"])
def test_chunked_emulation_matches_pallas_kernel(mode, S, chunk):
    """Against the reference's Pallas kernel in interpret mode (zero state)
    at RWKV6's head shape (Dk = Dv = 64, per-Dk decay)."""
    r, k, v, lw, u, _ = inputs(S + 11, 2, S, 64, 64, True)
    y_ref, st_ref = ref_scan_kernel(*map(jnp.asarray, (r, k, v, lw)), u=jnp.asarray(u),
                                    chunk=chunk, mode=mode, interpret=True)
    y, st = run_emulation(r, k, v, lw, u, chunk, mode, None)
    assert_rows_close(y, np.asarray(y_ref))
    assert_rows_close(st, np.asarray(st_ref))


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("S", [1, 5])
def test_step_emulation_matches_reference(mode, S):
    """The step regime from an initial state: RWKV6's decode step (S = 1)
    at its head shape, and chunks of one token over a short sequence."""
    r, k, v, lw, u, s0 = inputs(S + 5, 4, S, 64, 64, True)
    y_ref, st_ref = reference(r, k, v, lw, u, 1, mode, s0)
    y, st = run_emulation(r, k, v, lw, u, 1, mode, s0)
    assert_rows_close(y, y_ref)
    assert_rows_close(st, st_ref)


def test_step_emulation_matches_pallas_kernel_from_zero():
    r, k, v, lw, u, _ = inputs(17, 2, 3, 64, 64, True)
    y_ref, st_ref = ref_scan_kernel(*map(jnp.asarray, (r, k, v, lw)), u=jnp.asarray(u),
                                    chunk=1, mode="bonus", interpret=True)
    y, st = run_emulation(r, k, v, lw, u, 1, "bonus", None)
    assert_rows_close(y, np.asarray(y_ref))
    assert_rows_close(st, np.asarray(st_ref))


def test_tf32_split_keeps_twenty_bits():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11),
                      3.0e-30, -1.5 * 2.0 ** 40, 1.0 / 3.0, -9.87654e12], dtype=F32)
    hi, lo = split(x)
    assert torch.equal(hi[:4], torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10)]))
    assert torch.all(hi.abs() <= x.abs()) and torch.all((x - hi).abs() < x.abs() * 2.0 ** -10)
    assert torch.all((hi + lo - x).abs() <= x.abs() * 2.0 ** -20)


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
def test_lo_half_is_needed(mode):
    """Keys with a large shared component that every query is orthogonal
    to: q_fac k_fac^T is a small difference of large terms.  The three
    products hold the tolerance; one TF32 product per tile (the lo halves
    dropped) does not."""
    S, Dk, Dv = 192, 64, 64
    r, k, v, lw, u, _ = inputs(23, 2, S, Dk, Dv, True)
    rng = np.random.RandomState(5)
    common = rng.randn(Dk).astype(np.float32)
    common /= np.linalg.norm(common)
    k = (k + 300.0 * common).astype(np.float32)
    r = (r - (r @ common)[..., None] * common).astype(np.float32)
    lw = (lw * 0.05).astype(np.float32)
    y_ref, st_ref = reference(r, k, v, lw, u, S, mode, None)
    y, st = run_emulation(r, k, v, lw, u, S, mode, None)
    assert_rows_close(y, y_ref)
    assert_rows_close(st, st_ref)
    y_hi, _ = run_emulation(r, k, v, lw, u, S, mode, None, lo=False)
    assert row_err(y_hi, np.asarray(y_ref, np.float32)) > 1.0
