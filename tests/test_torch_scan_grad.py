"""The backward of ``linear_scan_chunked`` on the CPU: the plain
``ref.linear_scan_bwd_ref`` (the algorithm ``csrc/linear_scan.cu``'s
backward runs, written out) against autograd through the plain forward
``ref.linear_scan_ref`` and against ``jax.vjp`` of the reference's
``repro.models.linear_scan.chunked_scan``; and ``models.linear_scan.chunked_scan``'s
gradients through the wrapper's ``autograd.Function`` against autograd
through the plain forward.

Cases: both modes; log_w of one column (hymba) and of Dk columns (RWKV6);
aligned chunks, chunk = S (also at S = 200: four 64-token tiles, the last
ragged, the shape class the card's backward splits into tile pairs), and
chunks whose cumulative decay passes e^-30 so that the clamps cut the
gradient; with and without ``state0`` and a final-state gradient.  Inputs from numpy seeds.  Tolerances, each on
max |got - want| against max(1, max |want|) of the gradient:

* against autograd through the plain forward: 1e-5 (the same f32 math in
  another order; measured at most 4.9e-7);
* against ``jax.vjp`` of the reference: 1e-4 (XLA's f32 products and sums
  in their own order; measured at most 2.7e-6);
* ``chunked_scan`` through the Function: 1e-5, as the first.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import linear_scan as ref_ls  # noqa: E402
from repro_torch.kernels import linear_scan_kernel as lsk  # noqa: E402
from repro_torch.kernels.ref import SCAN_CLAMP, linear_scan_bwd_ref, linear_scan_ref  # noqa: E402
from repro_torch.models import linear_scan as ls  # noqa: E402

AUTOGRAD_TOL = 1e-5
JAX_TOL = 1e-4
B, H, Dk, Dv = 2, 2, 16, 24
CHUNKS = {"aligned": (128, 32), "chunk=S": (96, 96), "clamp": (128, 64),
          "chunk=S ragged": (200, 200)}
NAMES = ("r", "k", "v", "log_w", "u", "state0")


def inputs(mode: str, lw_cols: int, chunk_case: str, with_state: bool, seed: int = 0):
    """numpy arrays in the reference's [B, H, S, D] layout: r, k, v, log_w,
    u [H, Dk] (None for inclusive), state0 (or None), dy, dstate (or None).
    The clamp case draws log w in [-0.9, -0.3], so a 64-token chunk's
    cumulative decay passes e^-30."""
    S, _ = CHUNKS[chunk_case]
    rng = np.random.RandomState(seed + 97 * lw_cols + S)
    f = np.float32
    r, k = (rng.randn(B, H, S, Dk).astype(f) for _ in range(2))
    v = rng.randn(B, H, S, Dv).astype(f)
    if chunk_case == "clamp":
        lw = -(0.3 + 0.6 * rng.rand(B, H, S, lw_cols)).astype(f)
    else:
        lw = -np.log1p(np.exp(rng.randn(B, H, S, lw_cols))).astype(f)
    u = (rng.randn(H, Dk) * 0.5).astype(f) if mode == "bonus" else None
    st0 = rng.randn(B, H, Dk, Dv).astype(f) if with_state else None
    dy = rng.randn(B, H, S, Dv).astype(f)
    dst = rng.randn(B, H, Dk, Dv).astype(f) if with_state else None
    return r, k, v, lw, u, st0, dy, dst


def flat(x, cols=None):
    return None if x is None else torch.from_numpy(x).reshape(B * H, x.shape[2],
                                                               cols or x.shape[-1])


def port_bwd(mode, chunk, r, k, v, lw, u, st0, dy, dst):
    """linear_scan_bwd_ref on the flattened operands; du summed over B."""
    S = r.shape[2]
    u_rows = None if u is None else torch.from_numpy(
        np.broadcast_to(u, (B, H, Dk)).reshape(B * H, Dk).copy())
    s0 = None if st0 is None else torch.from_numpy(st0).reshape(B * H, Dk, Dv)
    ds = None if dst is None else torch.from_numpy(dst).reshape(B * H, Dk, Dv)
    dr, dk, dv, dlw, du, ds0 = linear_scan_bwd_ref(
        flat(r), flat(k), flat(v), flat(lw), u_rows, chunk=chunk, mode=mode, state0=s0,
        dy=flat(dy), dstate=ds)
    out = {"r": dr.reshape(B, H, S, Dk), "k": dk.reshape(B, H, S, Dk),
           "v": dv.reshape(B, H, S, Dv), "log_w": dlw.reshape(lw.shape)}
    if du is not None:
        out["u"] = du.reshape(B, H, Dk).sum(0)
    if ds0 is not None:
        out["state0"] = ds0.reshape(B, H, Dk, Dv)
    return out


def assert_close(got: dict, want: dict, tol: float) -> None:
    assert set(got) == set(want)
    for name in want:
        g, w = got[name].double(), torch.from_numpy(np.array(want[name])).double()
        assert g.shape == w.shape, name
        scale = max(1.0, float(w.abs().max()))
        err = float((g - w).abs().max())
        assert err <= tol * scale, (name, err, scale)


CASES = [(mode, lw_cols, chunk_case, with_state)
         for mode in ("inclusive", "bonus") for lw_cols in (1, Dk)
         for chunk_case in CHUNKS for with_state in (False, True)]


def case_id(c):
    return f"{c[0]}-lw{c[1]}-{c[2]}-{'state0' if c[3] else 'zero'}"


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bwd_ref_matches_autograd_of_plain_forward(case):
    mode, lw_cols, chunk_case, with_state = case
    S, chunk = CHUNKS[chunk_case]
    r, k, v, lw, u, st0, dy, dst = inputs(*case)
    arrs = {"r": r, "k": k, "v": v, "log_w": lw, "u": u, "state0": st0}
    leaves = {n: torch.from_numpy(a).requires_grad_(True) for n, a in arrs.items()
              if a is not None}
    u_rows = (None if u is None
              else torch.broadcast_to(leaves["u"], (B, H, Dk)).reshape(B * H, Dk))
    s0 = None if st0 is None else leaves["state0"].reshape(B * H, Dk, Dv)
    y, fin = linear_scan_ref(*(leaves[n].reshape(B * H, S, -1) for n in NAMES[:4]), u_rows,
                             chunk=chunk, mode=mode, state0=s0)
    out = (y * flat(dy)).sum()
    if dst is not None:
        out = out + (fin * torch.from_numpy(dst).reshape(B * H, Dk, Dv)).sum()
    grads = torch.autograd.grad(out, list(leaves.values()))
    want = {n: g.numpy() for n, g in zip(leaves, grads)}
    if chunk_case == "clamp":     # the clamps bite: cum passes -30 within a chunk
        cum = np.cumsum(lw.reshape(B, H, S // chunk, chunk, lw_cols), axis=3)
        assert cum.min() < -SCAN_CLAMP
    assert_close(port_bwd(mode, chunk, r, k, v, lw, u, st0, dy, dst), want, AUTOGRAD_TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_bwd_ref_matches_jax_vjp_of_reference(case):
    mode, lw_cols, chunk_case, with_state = case
    _, chunk = CHUNKS[chunk_case]
    r, k, v, lw, u, st0, dy, dst = inputs(*case)
    arrs = {"r": r, "k": k, "v": v, "log_w": lw, "u": u, "state0": st0}
    names = [n for n, a in arrs.items() if a is not None]

    def f(*xs):
        kw = dict(zip(names, xs))
        return ref_ls.chunked_scan(kw["r"], kw["k"], kw["v"], kw["log_w"], chunk=chunk,
                                   u=kw.get("u"), state0=kw.get("state0"), mode=mode)

    (y, fin), vjp = jax.vjp(f, *(jnp.asarray(arrs[n]) for n in names))
    cot_state = jnp.zeros_like(fin) if dst is None else jnp.asarray(dst)
    grads = vjp((jnp.asarray(dy), cot_state))
    want = {n: np.asarray(g) for n, g in zip(names, grads)}
    assert_close(port_bwd(mode, chunk, r, k, v, lw, u, st0, dy, dst), want, JAX_TOL)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_chunked_scan_grads_through_the_function_match_plain_autograd(case):
    """``models.linear_scan.chunked_scan`` with grad on goes through the
    wrapper's autograd.Function (on CPU tensors: plain forward, plain
    backward); autograd then reduces u over B.  Held against autograd through
    ``linear_scan_ref`` on the same [B, H, S, D] operands."""
    mode, lw_cols, chunk_case, with_state = case
    S, chunk = CHUNKS[chunk_case]
    r, k, v, lw, u, st0, dy, dst = inputs(*case)
    arrs = {"r": r, "k": k, "v": v, "log_w": lw, "u": u, "state0": st0}

    def run(scan):
        leaves = {n: torch.from_numpy(a).requires_grad_(True) for n, a in arrs.items()
                  if a is not None}
        y, fin = scan(leaves)
        out = (y * torch.from_numpy(dy)).sum()
        if dst is not None:
            out = out + (fin * torch.from_numpy(dst)).sum()
        return dict(zip(leaves, torch.autograd.grad(out, list(leaves.values()))))

    def through_function(t):
        return ls.chunked_scan(t["r"], t["k"], t["v"], t["log_w"], chunk=chunk, u=t.get("u"),
                               state0=t.get("state0"), mode=mode)

    def plain(t):
        u_rows = (None if "u" not in t else
                  torch.broadcast_to(t["u"], (B, H, Dk)).reshape(B * H, Dk))
        s0 = None if "state0" not in t else t["state0"].reshape(B * H, Dk, Dv)
        y, fin = linear_scan_ref(*(t[n].reshape(B * H, S, -1) for n in NAMES[:4]), u_rows,
                                 chunk=chunk, mode=mode, state0=s0)
        return y.reshape(B, H, S, Dv), fin.reshape(B, H, Dk, Dv)

    calls = []
    real = lsk.linear_scan_chunked_bwd

    def spy(*a, **kw):
        calls.append(kw["chunk"])
        return real(*a, **kw)

    lsk.linear_scan_chunked_bwd = spy
    try:
        got = run(through_function)
    finally:
        lsk.linear_scan_chunked_bwd = real
    assert calls == [chunk]                  # the gradient came from the hand-derived backward
    assert_close(got, {n: g.numpy() for n, g in run(plain).items()}, AUTOGRAD_TOL)


def test_function_returns_only_the_gradients_asked_for():
    """A gradient for each operand that requires one, None for the others;
    an unused final state reaches the backward as a zero gradient; no double
    backward; no autograd.Function without grad mode."""
    S, chunk = 64, 32
    g = torch.Generator().manual_seed(3)
    r, k = (torch.randn(4, S, Dk, generator=g) for _ in range(2))
    v = torch.randn(4, S, Dv, generator=g)
    lw = -torch.rand(4, S, 1, generator=g)
    u = torch.randn(4, Dk, generator=g)
    rq = r.clone().requires_grad_(True)
    y, _ = lsk.linear_scan_chunked(rq, k, v, lw, u, chunk=chunk, mode="bonus")
    assert y.grad_fn is not None
    (gr,) = torch.autograd.grad(y.sum(), [rq])
    want = linear_scan_bwd_ref(r, k, v, lw, u, chunk=chunk, mode="bonus",
                               dy=torch.ones(4, S, Dv))[0]
    torch.testing.assert_close(gr, want, rtol=0, atol=0)
    y, st = lsk.linear_scan_chunked(rq, k, v, lw, chunk=chunk)
    (gr,) = torch.autograd.grad(y.sum(), [rq], create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gr.sum(), [rq])
    with torch.no_grad():
        y, _ = lsk.linear_scan_chunked(rq, k, v, lw, chunk=chunk)
    assert y.grad_fn is None
