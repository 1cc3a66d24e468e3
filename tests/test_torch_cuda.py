"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports torch and the port only (the machine with the card has no JAX).
Every test is marked ``cuda`` and skips without a CUDA device:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``gear_decode`` 1e-3 on the normalized output and score max of
rows with history (f32 on both sides, different summation order; a row with
no closed chunk returns (0, -1e30, 0) from the kernel by design, see
``csrc/gear_decode.cu``), also at G = 64 query rows (the streaming history
scorer); ``gear_decode_paged`` bitwise equal to ``gear_decode`` on the
gathered operands and 1e-3 from its plain version; ``flash_prefill`` 3e-2
on the bf16 output (the kernel rounds P to bf16 before P·V);
``flash_prefill_block`` 1e-4 on the normalized output and score max (f32
both sides, 3xTF32 products in the kernel), also at the live [448, 64,
128] call, kv_len = 1, softcap 30 and head_dim 64 and 256, two calls bitwise
equal; ``gear_compress`` bit for bit in packed codes, stats, outlier values
and indices and the residual (both orientations, 2/4/8 bits, n_out up to 8,
head_dim 48 to 256, f32 or bf16 stats), two calls bitwise equal;
``linear_scan_chunked`` 2e-3 x max(1, max |y_plain|) on y and likewise on
the final state (the reference's own kernel tolerance, scaled because the
factored form's clamp lets y grow), also from an initial state
(``state0``: RWKV6's decode step at S = chunk = 1, and chunk = S);
``linear_scan_chunked``'s two regimes also per row (2e-3 x max(1, max
|row|) for every token of y and Dk row of the state): the step (chunk = 1,
both modes, Dv 40) and chunk = S at S in {1, 63, 65, 129, 1152}, with two
calls bitwise equal, also on tiles with NaN (a NaN equal to any NaN); ``quant_pack``
(through ``kernels.quantize_chunk``) bit for bit in packed codes, scale and zero, two calls
bitwise equal, also on non-finite input (NaN, +-inf, an all-NaN tile).  Hymba's shapes are held too: ``gear_decode`` at
G = 5, head_dim 64 and ``flash_prefill`` at kv_repeat 5, head_dim 64.

The redesigned kernels, with the same tolerances: ``flash_prefill`` (TMA +
wgmma) at S in {1, 63, 64, 65, 127, 129, 1000}, head_dim 64, 128 and 256
(two consumer warpgroups), under every mask, and at gemma-2b's MQA
(kv_repeat 8, head_dim 256) with a ragged S, window + softcap and a
256-token prefix; ``gear_decode`` in both regimes (G = 1, 2, 5, 8 and 12 on
CUDA cores with one or several chunks per block, G = 64 on tensor cores) at
head_dim 64, 128 and 256 over 18 chunks with an empty row and duplicated
outlier indices, and G = 12 also through the tensor-core body
(``tensor_cores=True``); ``gear_decode_history`` against its plain version
and, bit for bit, one ``gear_decode`` call per block, at head_dim 128 and
256 (gear_kivi2's 4 V stat groups there); ``gear_decode_paged`` bit for bit
against the dense body in both regimes, at head_dim 128 and 256.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import gear_compress as gc  # noqa: E402
from repro_torch.kernels import gear_decode as gd  # noqa: E402
from repro_torch.kernels import linear_scan_kernel as lsk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quant_pack as qp  # noqa: E402
from repro_torch.kernels.ref import (flash_block_ref, flash_prefill_ref,  # noqa: E402
                                     gather_paged_operands, gear_compress_ref,
                                     gear_decode_paged_ref, gear_decode_ref, linear_scan_bwd_ref,
                                     linear_scan_ref, quant_pack_ref)
from repro_torch.models import linear_scan as ls  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("G", [1, 4])
def test_gear_decode_kernel_matches_plain(dev, polname, G):
    H, Dh, S = 4, 128, 256
    cfg = cache.CacheConfig(batch=4, kv_heads=H, head_dim=Dh, capacity=S,
                            policy=named_policy(polname))
    g = torch.Generator(device=dev).manual_seed(G)
    k = torch.randn(4, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(4, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    k[0, 0, :, 7] = 1.5                  # constant channel: an outlier index stored twice
    c = cache.prefill_layer_cache(cfg, cache.init_layer_cache(cfg, torch.bfloat16, dev), k, v)
    c.length.copy_(torch.tensor([5, 64, 130, 256], dtype=torch.int32, device=dev))
    BH = 4 * H
    n_comp = (c.length.repeat_interleave(H) // 64 * 64).to(torch.int32)
    arrays, lr, sp = ops._gear_operands(cfg, c, BH)
    q = torch.randn(BH, G, Dh, generator=g, device=dev)
    kw = dict(bits=cfg.policy.bits, chunk=64, scale_factor=Dh ** -0.5, **lr, **sp)
    before = gd.gear_decode.launches
    acc_k, m_k, l_k = gd.gear_decode(q, *arrays, n_comp, **kw)
    assert gd.gear_decode.launches == before + 1
    acc_p, m_p, l_p = gear_decode_ref(q, *arrays, n_comp, **kw)
    live = n_comp > 0
    torch.testing.assert_close((acc_k / l_k[..., None])[live], (acc_p / l_p[..., None])[live],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(m_k[live], m_p[live], rtol=0, atol=1e-3)
    assert (l_k[~live] == 0).all() and (m_k[~live] == -1e30).all()


@pytest.mark.parametrize("case", [(300, 32, 1, 0, 0, 0.0), (257, 32, 4, 64, 0, 30.0),
                                  (200, 16, 2, 0, 50, 0.0), (65, 8, 1, 0, 0, 0.0)])
@pytest.mark.parametrize("Dh", [64, 128])
def test_flash_prefill_kernel_matches_plain(dev, case, Dh):
    S, BH, rep, window, prefix, cap = case
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(BH, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(BH // rep, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(BH // rep, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    kw = dict(window=window, prefix_len=prefix, softcap=cap, kv_repeat=rep)
    torch.testing.assert_close(fp.flash_prefill(q, k, v, **kw).float(),
                               flash_prefill_ref(q, k, v, **kw).float(), rtol=0, atol=3e-2)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    q = torch.randn(2, 64, 96, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fp.flash_prefill(q, q, q)
    with pytest.raises(ValueError, match="bf16"):
        fp.flash_prefill(q.float(), q.float(), q.float())
    x = torch.randn(2, 64, 128, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        fp.flash_prefill(x.transpose(1, 2).contiguous().transpose(1, 2), x, x)


def decode_fixture(dev, polname, B=2, H=4, Dh=128, S=256, seed=0):
    cfg = cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                            policy=named_policy(polname))
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(B, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    c = cache.prefill_layer_cache(cfg, cache.init_layer_cache(cfg, torch.bfloat16, dev), k, v)
    arrays, lr, sp = ops._gear_operands(cfg, c, B * H)
    return cfg, arrays, lr | sp, g


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_decode_kernel_at_streaming_block_rows(dev, polname):
    """The history scorer's shape: G * T = 64 query rows per row, one shared
    extent n_comp = c * n_b over a whole batch-1 cache (blocks past it exit)."""
    cfg, arrays, extra, g = decode_fixture(dev, polname, B=1, H=8, S=512)
    q = torch.randn(8, 64, 128, generator=g, device=dev)
    kw = dict(bits=cfg.policy.bits, chunk=64, scale_factor=128 ** -0.5, **extra)
    for c in (1, 3, 8):
        acc_k, m_k, l_k = gd.gear_decode(q, *arrays, c * 64, **kw)
        acc_p, m_p, l_p = gear_decode_ref(q, *arrays, c * 64, **kw)
        torch.testing.assert_close(acc_k / l_k[..., None], acc_p / l_p[..., None],
                                   rtol=0, atol=1e-3)
        torch.testing.assert_close(m_k, m_p, rtol=0, atol=1e-3)


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_decode_paged_kernel_equals_dense_on_gathered_operands(dev, polname):
    """Pool pages in a shuffled order, block-table entries past each slot's
    extent on the zero page: the paged kernel's triple equals the dense
    kernel's on the gathered operands bit for bit, and its plain version
    within 1e-3."""
    B, H, S, nb = 2, 4, 256, 64
    cfg, arrays, extra, g = decode_fixture(dev, polname, B=B, H=H, S=S, seed=3)
    C = S // nb
    names = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero")
    dense = dict(zip(names, arrays)) | extra
    n_comp = torch.tensor([64] * H + [192] * H, dtype=torch.int32, device=dev)
    live = [1, 3]                                  # chunks each slot holds
    P = 1 + sum(live)
    pages = torch.randperm(P - 1, generator=torch.Generator().manual_seed(0)) + 1
    bt = torch.zeros((B, C), dtype=torch.int32)
    it = iter(pages.tolist())
    for b in range(B):
        for c in range(live[b]):
            bt[b, c] = next(it)
    bt = bt.to(dev)
    pools = {}
    for name, x in dense.items():
        rpc = x.shape[1] // C                      # rows of one chunk
        pool = torch.zeros((P * H, rpc) + tuple(x.shape[2:]), dtype=x.dtype, device=dev)
        for b in range(B):
            for c in range(live[b]):
                p = int(bt[b, c])
                pool[p * H:(p + 1) * H] = x[b * H:(b + 1) * H, c * rpc:(c + 1) * rpc]
        pools[name] = pool
    gathered = gather_paged_operands(bt, B * H, pools)
    q = torch.randn(B * H, 1, 128, generator=g, device=dev)
    kw = dict(bits=cfg.policy.bits, chunk=nb, scale_factor=128 ** -0.5)
    before = gd.gear_decode_paged.launches
    paged = gd.gear_decode_paged(q, *[pools[n] for n in names], n_comp, bt, **kw,
                                 **{n: pools[n] for n in extra})
    assert gd.gear_decode_paged.launches == before + 1
    flat = gd.gear_decode(q, *[gathered[n] for n in names], n_comp, **kw,
                          **{n: gathered[n] for n in extra})
    for a, b in zip(paged, flat):
        assert torch.equal(a, b)
    acc_p, m_p, l_p = gear_decode_paged_ref(q, *[pools[n] for n in names], n_comp, bt, **kw,
                                            **{n: pools[n] for n in extra})
    torch.testing.assert_close(paged[0] / paged[2][..., None], acc_p / l_p[..., None],
                               rtol=0, atol=1e-3)


BLOCK_CASES = [
    # (N, T, kv_repeat, Dh, kv_len: "random" / "full" / "one", softcap)
    (64, 64, 1, 128, "random", 0.0),
    (64, 64, 4, 128, "random", 0.0),
    (64, 37, 1, 128, "random", 0.0),
    (448, 64, 1, 128, "full", 0.0),        # the streaming prefill's live call
    (64, 64, 1, 128, "one", 0.0),
    (64, 64, 1, 128, "random", 30.0),
    (32, 64, 2, 64, "random", 0.0),
    (32, 50, 4, 256, "random", 0.0),
    (40, 16, 5, 64, "full", 30.0),
]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_prefill_block_kernel_matches_plain(dev, case):
    """Normalized output and score max within 1e-4 of the plain version (f32
    both sides; the kernel's products are 3xTF32), l within 1e-5 relative,
    two calls bitwise equal."""
    N, T, rep, Dh, lens, cap = case
    g = torch.Generator(device=dev).manual_seed(T + rep + Dh)
    q = torch.randn(N, T, Dh, generator=g, device=dev)
    k = torch.randn(N // rep, T, Dh, generator=g, device=dev)
    v = torch.randn(N // rep, T, Dh, generator=g, device=dev)
    kv_len = {"random": torch.randint(1, T + 1, (N,), generator=g, device=dev, dtype=torch.int32),
              "full": torch.full((N,), T, dtype=torch.int32, device=dev),
              "one": torch.ones(N, dtype=torch.int32, device=dev)}[lens]
    kw = dict(scale=Dh ** -0.5, softcap=cap, kv_repeat=rep)
    before = fp.flash_prefill_block.launches
    acc_k, m_k, l_k = fp.flash_prefill_block(q, k, v, kv_len, **kw)
    assert fp.flash_prefill_block.launches == before + 1
    again = fp.flash_prefill_block(q, k, v, kv_len, **kw)
    assert all(torch.equal(a, b) for a, b in zip((acc_k, m_k, l_k), again))
    acc_p, m_p, l_p = flash_block_ref(q, k, v, kv_len, **kw)
    torch.testing.assert_close(acc_k / l_k[..., None], acc_p / l_p[..., None], rtol=0, atol=1e-4)
    torch.testing.assert_close(m_k, m_p, rtol=0, atol=1e-4)
    torch.testing.assert_close(l_k, l_p, rtol=1e-5, atol=1e-5)


def test_flash_prefill_block_rejects_an_unbuilt_head_dim(dev):
    q = torch.randn(4, 16, 96, device=dev)
    lens = torch.full((4,), 16, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fp.flash_prefill_block(q, q, q, lens, scale=0.1)


COMPRESS_CASES = [
    # (scheme, group, n_out, bits, (N, nb, d), stat_dtype)
    *[(scheme, group, n_out, bits, (96, 64, 128), "bfloat16")
      for scheme, group, n_out in [("per_channel", None, 1), ("per_token", None, 2),
                                   ("per_channel", 64, 1), ("per_token", 64, 2),
                                   ("per_channel", 16, 0)]
      for bits in (2, 4)],
    ("per_channel", None, 1, 8, (96, 64, 128), "bfloat16"),
    ("per_token", None, 2, 8, (96, 64, 128), "bfloat16"),
    ("per_channel", None, 8, 4, (96, 64, 128), "bfloat16"),
    ("per_token", None, 8, 4, (96, 64, 128), "bfloat16"),
    ("per_channel", None, 1, 4, (96, 64, 64), "bfloat16"),
    ("per_token", 32, 2, 2, (96, 64, 64), "bfloat16"),
    ("per_channel", 32, 3, 4, (48, 64, 256), "bfloat16"),
    ("per_token", None, 2, 4, (48, 64, 256), "bfloat16"),
    ("per_channel", None, 1, 4, (96, 64, 128), "float32"),
    ("per_token", None, 2, 4, (96, 64, 128), "float32"),
    ("per_token_group", 12, 1, 4, (16, 16, 48), "bfloat16"),
    ("per_channel", 8, 2, 2, (16, 24, 32), "bfloat16"),
    ("per_channel", 1, 1, 4, (8, 64, 256), "bfloat16"),      # largest stats: 198 KB of smem
]


@pytest.mark.parametrize("case", COMPRESS_CASES, ids=lambda c: "-".join(map(str, c)))
def test_gear_compress_kernel_matches_plain(dev, case):
    """Bit for bit: packed codes, stats, outlier values and indices, and the
    residual equal the plain version's, with a constant channel and a
    constant token (top and bottom outliers share an index); two calls
    bitwise equal."""
    scheme, group, n_out, bits, shape, stat_dtype = case
    g = torch.Generator(device=dev).manual_seed(bits + n_out)
    x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16).float()
    x[0, :, 5] = 1.25                      # constant channel: top and bottom share an index
    x[1, 7, :] = -0.5                      # constant token, likewise
    kw = dict(bits=bits, scheme=scheme, group=group, n_out=n_out, stat_dtype=stat_dtype)
    before = gc.gear_compress.launches
    got = gc.gear_compress(x, **kw)
    assert gc.gear_compress.launches == before + 1
    again = gc.gear_compress(x, **kw)
    want = gear_compress_ref(x, **kw)
    names = ("packed", "scale", "zero", "sp_val", "sp_idx", "resid")
    for name, a, b, w in zip(names, got, again, want):
        if n_out == 0 and name.startswith("sp_"):
            assert a is None and w is None
            continue
        assert torch.equal(a, b), f"{name}: two calls differ"
        assert torch.equal(a, w.to(a.dtype)), f"{name} differs from the plain version"


@pytest.mark.parametrize("kind", ["k", "v"])
@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_compress_kernel_matches_plain_on_nan(dev, polname, kind):
    """A K channel (V token) with more NaNs than its outlier count, one with
    a single NaN, and an all-NaN tile, under both policies at the main
    path's [64, 128] tiles: every output equals the plain version's, a NaN
    equal to any NaN.  A vector that holds a NaN picks (NaN, its length) for
    each outlier and takes nothing out (the reference's Pallas kernel), and
    its groups get NaN stats.  Before the repair the plain version raised
    (its scatter took index n) and the kernel dropped NaN, returning finite
    stats."""
    from repro_torch.core.outlier import outlier_count

    pol = named_policy(polname)
    scheme, group = pol.scheme_for(kind)
    per_channel = scheme == "per_channel"
    n_out = outlier_count(64 if per_channel else 128, pol.sparsity)
    g = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn(4, 64, 128, generator=g, device=dev).to(torch.bfloat16).float()
    many = torch.arange(2 * n_out + 1, device=dev) * 5
    if per_channel:
        x[0, many, 7] = float("nan")
        x[1, 30, 9] = float("nan")
    else:
        x[0, 7, many] = float("nan")
        x[1, 30, 100] = float("nan")
    x[2] = float("nan")
    kw = dict(bits=pol.bits, scheme=scheme, group=group, n_out=n_out, stat_dtype=pol.stat_dtype)
    got = gc.gear_compress(x, **kw)
    want = gear_compress_ref(x, **kw)
    names = ("packed", "scale", "zero", "sp_val", "sp_idx", "resid")
    for name, a, w in zip(names, got, want):
        assert nan_equal(a, w.to(a.dtype)), f"{name} differs from the plain version"
    scale, sp_idx = got[1], got[4]
    length = 64 if per_channel else 128              # channel 7 (token 7) of tile 0
    assert torch.isnan(scale[0]).any() and torch.isnan(scale[2]).all()
    assert bool((sp_idx[0, 7] == length).all()) and bool((sp_idx[3] < length).all())


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_decode_kernel_at_hymba_shape(dev, polname):
    """hymba-1.5b's decode: 5 KV heads with G = 5 query rows each, head_dim
    64, capacity 1152, ragged extents."""
    cfg, arrays, extra, g = decode_fixture(dev, polname, B=4, H=5, Dh=64, S=1152)
    n_comp = torch.tensor([0, 64, 576, 1152], dtype=torch.int32,
                          device=dev).repeat_interleave(5)
    q = torch.randn(20, 5, 64, generator=g, device=dev)
    kw = dict(bits=cfg.policy.bits, chunk=64, scale_factor=64 ** -0.5, **extra)
    acc_k, m_k, l_k = gd.gear_decode(q, *arrays, n_comp, **kw)
    acc_p, m_p, l_p = gear_decode_ref(q, *arrays, n_comp, **kw)
    live = n_comp > 0
    torch.testing.assert_close((acc_k / l_k[..., None])[live], (acc_p / l_p[..., None])[live],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(m_k[live], m_p[live], rtol=0, atol=1e-3)


@pytest.mark.parametrize("S", [1000, 333])
def test_flash_prefill_kernel_at_hymba_shape(dev, S):
    """hymba-1.5b's prefill attention: 25 query heads over 5 KV heads
    (kv_repeat 5), head_dim 64."""
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(25, S, 64, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(5, S, 64, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(5, S, 64, generator=g, device=dev).to(torch.bfloat16)
    torch.testing.assert_close(fp.flash_prefill(q, k, v, kv_repeat=5).float(),
                               flash_prefill_ref(q, k, v, kv_repeat=5).float(),
                               rtol=0, atol=3e-2)


def scan_case(dev, BH, S, Dk, Dv, lw_cols, seed, decay=None):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.randn(BH, S, Dk, generator=g, device=dev)
    k = torch.randn(BH, S, Dk, generator=g, device=dev)
    v = torch.randn(BH, S, Dv, generator=g, device=dev)
    if decay is None:
        lw = -torch.nn.functional.softplus(torch.randn(BH, S, lw_cols, generator=g, device=dev))
    else:
        lw = torch.full((BH, S, lw_cols), decay, device=dev)
    u = torch.randn(BH, Dk, generator=g, device=dev) * 0.5
    return r, k, v, lw, u


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("S,chunk", [(256, 64), (200, 200), (859, 859), (96, 32)])
@pytest.mark.parametrize("Dk,Dv,lw_cols", [(16, 64, 1), (16, 40, 16), (64, 64, 64)])
def test_linear_scan_kernel_matches_plain(dev, mode, S, chunk, Dk, Dv, lw_cols):
    """Both modes; aligned chunks carrying the state, chunk = S (one chunk
    of up to 859 tokens, tiled in 64-row tiles with a ragged last tile);
    log_w broadcast or per Dk; Dv = 40 is not a multiple of the 16-column
    tile.  The reference's init decay (-0.313 per token) drives the
    clamped regime."""
    r, k, v, lw, u = scan_case(dev, 6, S, Dk, Dv, lw_cols, S + Dv,
                               decay=-0.313 if lw_cols == 1 else None)
    before = lsk.linear_scan_chunked.launches
    y_k, st_k = lsk.linear_scan_chunked(r, k, v, lw, u, chunk=chunk, mode=mode)
    assert lsk.linear_scan_chunked.launches == before + 1
    y_p, st_p = linear_scan_ref(r, k, v, lw, u, chunk=chunk, mode=mode)
    tol = 2e-3 * max(1.0, float(y_p.abs().max()))
    torch.testing.assert_close(y_k, y_p, rtol=0, atol=tol)
    torch.testing.assert_close(st_k, st_p, rtol=0, atol=2e-3 * max(1.0, float(st_p.abs().max())))


def test_linear_scan_wrappers_reject_what_the_kernel_does_not_take(dev):
    r, k, v, lw, u = scan_case(dev, 2, 128, 16, 32, 1, 0)
    with pytest.raises(ValueError, match="does not divide"):
        lsk.linear_scan_chunked(r, k, v, lw, chunk=100)
    with pytest.raises(ValueError, match="f32"):
        lsk.linear_scan_chunked(r.to(torch.bfloat16), k, v, lw, chunk=64)
    with pytest.raises(ValueError, match="Dk"):
        big = torch.zeros(2, 128, 80, device=dev)
        lsk.linear_scan_chunked(big, big, v, lw, chunk=64)
    with pytest.raises(ValueError, match="state0 has shape"):
        lsk.linear_scan_chunked(r, k, v, lw, chunk=64, state0=torch.zeros(2, 16, 31, device=dev))
    with pytest.raises(ValueError, match="state0 must be"):
        lsk.linear_scan_chunked(r, k, v, lw, chunk=64,
                                state0=torch.zeros(2, 16, 32, device=dev, dtype=torch.bfloat16))


@pytest.mark.parametrize("mode", ["inclusive", "bonus"])
@pytest.mark.parametrize("S,chunk", [(1, 1), (859, 859), (128, 64)],
                         ids=["decode-S1", "chunk=S-859", "aligned-64"])
def test_linear_scan_kernel_with_state0_matches_plain(dev, mode, S, chunk):
    """From a non-zero initial state at RWKV6's head shape (Dk = Dv = 64,
    per-Dk decay): the decode step's S = chunk = 1 over 4 slots x 40 heads,
    an unaligned prompt's chunk = S, and aligned chunks carrying the state;
    through ``chunked_scan`` too, which hands the state to the kernel."""
    BH = 160 if S == 1 else 40
    r, k, v, lw, u = scan_case(dev, BH, S, 64, 64, 64, S + 7)
    st0 = torch.randn(BH, 64, 64, generator=torch.Generator(device=dev).manual_seed(S),
                      device=dev)
    before = lsk.linear_scan_chunked.launches
    y_k, st_k = lsk.linear_scan_chunked(r, k, v, lw, u, chunk=chunk, mode=mode, state0=st0)
    assert lsk.linear_scan_chunked.launches == before + 1
    y_p, st_p = linear_scan_ref(r, k, v, lw, u, chunk=chunk, mode=mode, state0=st0)
    torch.testing.assert_close(y_k, y_p, rtol=0, atol=2e-3 * max(1.0, float(y_p.abs().max())))
    torch.testing.assert_close(st_k, st_p, rtol=0,
                               atol=2e-3 * max(1.0, float(st_p.abs().max())))
    H = 40
    y_m, st_m = ls.chunked_scan(r.reshape(-1, H, S, 64), k.reshape(-1, H, S, 64),
                                v.reshape(-1, H, S, 64), lw.reshape(-1, H, S, 64), chunk=chunk,
                                u=u[:H], state0=st0.reshape(-1, H, 64, 64), mode=mode)
    assert lsk.linear_scan_chunked.launches == before + 2
    u_rows = u[:H].repeat(BH // H, 1)
    y_p2, st_p2 = linear_scan_ref(r, k, v, lw, u_rows, chunk=chunk, mode=mode, state0=st0)
    torch.testing.assert_close(y_m.reshape(BH, S, 64), y_p2, rtol=0,
                               atol=2e-3 * max(1.0, float(y_p2.abs().max())))
    torch.testing.assert_close(st_m.reshape(BH, 64, 64), st_p2, rtol=0,
                               atol=2e-3 * max(1.0, float(st_p2.abs().max())))


def assert_scan_rows_close(got, want):
    """2e-3 x max(1, max |want|) over the whole output and 2e-3 x max(1,
    max |want| of the row) for every row of the last dim (a token of y, a
    Dk row of the state): ``chip_smoke.py``'s ``row_err``."""
    torch.testing.assert_close(got, want, rtol=0, atol=2e-3 * max(1.0, float(want.abs().max())))
    limit = 2e-3 * want.abs().amax(-1).clamp_min(1.0)
    assert float(((got - want).abs().amax(-1) / limit).max()) <= 1.0


SCAN_REGIMES = [
    # (mode, S, chunk, Dk, Dv, log_w columns, initial state)
    ("inclusive", 1, 1, 64, 64, 64, True),            # the step regime, inclusive
    ("inclusive", 1, 1, 64, 40, 64, True),            # step at Dv 40 (not a 16-byte group)
    ("bonus", 1, 1, 64, 40, 64, True),
    ("bonus", 1, 1, 16, 64, 1, False),
    ("bonus", 6, 1, 64, 64, 64, True),                # chunks of one token over 6
] + [(mode, S, S, Dk, 64, lw, st) for mode in ("inclusive", "bonus")
     for S in (1, 63, 65, 129, 1152)                  # chunk = S: ragged tiles; 1152 = capacity
     for Dk, lw, st in ((64, 64, mode == "bonus"), (16, 1, mode == "inclusive"))]


@pytest.mark.parametrize("case", SCAN_REGIMES, ids=lambda c: "-".join(map(str, c)))
def test_linear_scan_regimes_match_plain_per_row(dev, case):
    """Both regimes of the redesigned kernel, globally and per row: the
    step (chunk = 1, inclusive and bonus, Dv 40, a sequence of one-token
    chunks) and chunk = S at S in {1, 63, 65, 129, 1152} (ragged last
    tiles, one and several query tiles) at RWKV6's and hymba's head shapes,
    from a zero or a non-zero initial state."""
    mode, S, chunk, Dk, Dv, lw_cols, with_state = case
    BH = 12
    r, k, v, lw, u = scan_case(dev, BH, S, Dk, Dv, lw_cols, S + Dk + Dv,
                               decay=-0.313 if lw_cols == 1 else None)
    st0 = (torch.randn(BH, Dk, Dv, generator=torch.Generator(device=dev).manual_seed(S),
                       device=dev) if with_state else None)
    before = lsk.linear_scan_chunked.launches
    y_k, st_k = lsk.linear_scan_chunked(r, k, v, lw, u, chunk=chunk, mode=mode, state0=st0)
    assert lsk.linear_scan_chunked.launches == before + 1
    y_p, st_p = linear_scan_ref(r, k, v, lw, u, chunk=chunk, mode=mode, state0=st0)
    assert_scan_rows_close(y_k, y_p)
    assert_scan_rows_close(st_k, st_p)


@pytest.mark.parametrize("S,chunk,with_state", [(1, 1, True), (859, 859, False),
                                                (859, 859, True), (256, 64, True)],
                         ids=["step", "chunk=S", "chunk=S-state0", "aligned"])
def test_linear_scan_two_calls_are_bitwise_equal(dev, S, chunk, with_state):
    """No float atomics: the state increments are summed in tile order, so
    two calls on the same inputs give the same bits."""
    BH = 40
    r, k, v, lw, u = scan_case(dev, BH, S, 64, 64, 64, S)
    st0 = torch.randn(BH, 64, 64, device=dev) if with_state else None
    y1, s1 = lsk.linear_scan_chunked(r, k, v, lw, u, chunk=chunk, mode="bonus", state0=st0)
    y2, s2 = lsk.linear_scan_chunked(r, k, v, lw, u, chunk=chunk, mode="bonus", state0=st0)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


SCAN_BWD_CASES = [
    # (mode, BH, S, chunk, Dk, Dv, log_w columns, state0 and a final-state gradient):
    # tests/test_torch_scan_grad.py's grid (aligned, chunk = S, a clamp that bites)
    (mode, 4, S, chunk, 16, 24, lw, st) for mode in ("inclusive", "bonus") for lw in (1, 16)
    for S, chunk in ((128, 32), (96, 96), (128, 64)) for st in (False, True)
] + [
    ("inclusive", 50, 512, 64, 16, 64, 1, False),     # hymba-1.5b's training scan
    ("bonus", 80, 512, 64, 64, 64, 64, False),        # rwkv6-3b's training scan
    ("bonus", 6, 859, 859, 64, 64, 64, True),         # chunk = S over 14 ragged tiles
    ("inclusive", 6, 200, 200, 16, 100, 1, True),     # Dv over two 64-column slices
    ("bonus", 6, 37, 1, 64, 40, 64, True),            # chunk = 1
    ("inclusive", 6, 130, 65, 7, 33, 7, False),       # odd widths, a ragged tile
    # the tile-pair kernels' edges
    ("bonus", 4, 1024, 1024, 64, 64, 64, False),      # a chunk of 16 full tiles (120 pairs)
    ("inclusive", 4, 192, 192, 16, 64, 1, False),     # exactly three tiles
    ("inclusive", 4, 256, 64, 8, 64, 8, False),       # Dk 8: one column block, per-Dk decay
    ("bonus", 4, 128, 64, 64, 64, 64, True),          # the clamp at rwkv's widths, from state0
]


def scan_bwd_inputs(dev, case, seed=0):
    mode, BH, S, chunk, Dk, Dv, lw_cols, with_state = case
    g = torch.Generator(device=dev).manual_seed(seed + S + Dk + Dv)
    r, k = (torch.randn(BH, S, Dk, generator=g, device=dev) for _ in range(2))
    v = torch.randn(BH, S, Dv, generator=g, device=dev)
    if chunk == 64 and S == 128:          # the clamp bites: log w in [-0.9, -0.3]
        lw = -(0.3 + 0.6 * torch.rand(BH, S, lw_cols, generator=g, device=dev))
    else:
        lw = -torch.nn.functional.softplus(torch.randn(BH, S, lw_cols, generator=g, device=dev))
    u = torch.randn(BH, Dk, generator=g, device=dev) * 0.5 if mode == "bonus" else None
    st0 = torch.randn(BH, Dk, Dv, generator=g, device=dev) if with_state else None
    dy = torch.randn(BH, S, Dv, generator=g, device=dev)
    dst = torch.randn(BH, Dk, Dv, generator=g, device=dev) if with_state else None
    return (r, k, v, lw, u), dict(chunk=chunk, mode=mode, state0=st0, dy=dy, dstate=dst)


@pytest.mark.parametrize("case", SCAN_BWD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_linear_scan_bwd_kernel_matches_plain(dev, case):
    """The backward kernel against ``linear_scan_bwd_ref`` on the same
    operands, every gradient within 2e-3 x max(1, max |plain|) overall and
    per row (the forward's bound); two calls bit for bit (no float
    atomics); one count a call."""
    args, kw = scan_bwd_inputs(dev, case)
    before = lsk.linear_scan_chunked_bwd.launches
    got = lsk.linear_scan_chunked_bwd(*args, **kw)
    again = lsk.linear_scan_chunked_bwd(*args, **kw)
    assert lsk.linear_scan_chunked_bwd.launches == before + 2
    want = linear_scan_bwd_ref(*args, **kw)
    for name, a, b, w in zip(("dr", "dk", "dv", "dlog_w", "du", "dstate0"), got, again, want):
        assert (a is None) == (w is None), name
        if w is None:
            continue
        assert torch.equal(a, b), name
        assert_scan_rows_close(a, w)


@pytest.mark.parametrize("mode,lw_cols", [("inclusive", 1), ("bonus", 64)])
def test_chunked_scan_trains_through_the_kernels(dev, mode, lw_cols):
    """``models.linear_scan.chunked_scan`` with grad on, at [B, H, S, D]
    with a [H, Dk] u broadcast over B: one forward and one backward launch,
    and every gradient within the forward's bound of autograd through the
    plain forward on the card (f32 leaves: a bf16 leaf's gradient is
    rounded to bf16 on both sides, one ulp apart where the f32 sums round
    across a bf16 boundary)."""
    B, H, S, Dk, Dv = 2, 4, 256, 64 if lw_cols == 64 else 16, 64
    g = torch.Generator(device=dev).manual_seed(lw_cols)
    leaves = {"r": torch.randn(B, H, S, Dk, generator=g, device=dev),
              "k": torch.randn(B, H, S, Dk, generator=g, device=dev),
              "v": torch.randn(B, H, S, Dv, generator=g, device=dev),
              "log_w": -torch.rand(B, H, S, lw_cols, generator=g, device=dev),
              "state0": torch.randn(B, H, Dk, Dv, generator=g, device=dev)}
    if mode == "bonus":
        leaves["u"] = torch.randn(H, Dk, generator=g, device=dev)
    dy = torch.randn(B, H, S, Dv, generator=g, device=dev)

    def run(scan):
        t = {n: x.detach().clone().requires_grad_(True) for n, x in leaves.items()}
        y, fin = scan(t)
        ((y * dy).sum() + fin.sum()).backward()
        return {n: x.grad for n, x in t.items()}

    def plain(t):
        u = None if "u" not in t else torch.broadcast_to(t["u"], (B, H, Dk)).reshape(B * H, Dk)
        y, fin = linear_scan_ref(*(t[n].reshape(B * H, S, -1) for n in
                                   ("r", "k", "v", "log_w")), u, chunk=64, mode=mode,
                                 state0=t["state0"].reshape(B * H, Dk, Dv))
        return y.reshape(B, H, S, Dv), fin

    fwd, bwd = lsk.linear_scan_chunked.launches, lsk.linear_scan_chunked_bwd.launches
    got = run(lambda t: ls.chunked_scan(t["r"], t["k"], t["v"], t["log_w"], chunk=64,
                                        u=t.get("u"), state0=t["state0"], mode=mode))
    assert lsk.linear_scan_chunked.launches == fwd + 1
    assert lsk.linear_scan_chunked_bwd.launches == bwd + 1
    want = run(plain)
    for name in want:
        assert_scan_rows_close(got[name], want[name])


def test_scan_training_is_bitwise_equal_across_remat_policies(dev):
    """hymba-1.5b's and rwkv6-3b's smoke configs: loss and every gradient on
    the card bit for bit with remat off, ``full`` and ``dots`` (the scan's
    kernels add no float atomics; the recompute runs the same launches)."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model

    for arch in ("hymba-1.5b", "rwkv6-3b"):
        cfg = smoke_config(arch)
        m = build_model(cfg)
        params = m.init(seed=0, device=dev, dtype=torch.float32).requires_grad_(True)
        tokens = torch.randint(0, cfg.vocab_size, (2, 128), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(1))
        runs = []
        for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
            params.zero_grad(set_to_none=True)
            loss, _ = m.loss_fn(params, {"tokens": tokens}, remat=remat, remat_policy=policy)
            loss.backward()
            runs.append((loss.detach(), [p.grad.clone() for p in params.parameters()]))
        for loss, grads in runs[1:]:
            assert torch.equal(loss, runs[0][0]), arch
            assert all(torch.equal(a, b) for a, b in zip(grads, runs[0][1])), arch


QP_SHAPES = [(448, 64, 128), (2, 16, 64), (1, 64, 256), (8, 32, 32), (3, 7, 48)]


def nan_equal(a, b) -> bool:
    """Bitwise equal, a NaN equal to any NaN (its payload and sign aside)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a.masked_fill(na, 0), b.masked_fill(nb, 0))


def non_finite(x):
    """x with a NaN in column 0, +inf in column 1, -inf in column 2 and
    both in column 4 of tile 0, and, when there is more than one tile, a
    last tile that is all NaN."""
    x = x.clone()
    n = x.shape[1]
    x[0, n // 2, 0] = float("nan")
    x[0, 0, 1] = float("inf")
    x[0, n - 1, 2] = -float("inf")
    x[0, 0, 4], x[0, n - 1, 4] = float("inf"), -float("inf")
    if x.shape[0] > 1:
        x[-1] = float("nan")
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bits", [2, 4, 8])
@pytest.mark.parametrize("shape", QP_SHAPES, ids=["x".join(map(str, s)) for s in QP_SHAPES])
def test_quant_pack_kernel_matches_plain_bit_for_bit(dev, shape, bits, dtype):
    """Through ``kernels.quantize_chunk``: the phase-5 tiles, the reference's
    sweep shapes, and a width (48) that is not a power of two over 7 rows; a
    constant column takes the 1e-8 scale floor.  Two calls are bitwise
    equal.  Then the non-finite input: NaN in one column, +inf, -inf and
    both in others, an all-NaN tile; scale and zero are NaN exactly in the
    NaN columns (as the reference's Pallas kernel gives,
    ``tests/test_torch_quant_pack_redesign.py``), infinite in the +-inf
    ones, and every code equals the plain version's.  The kernel before the
    redesign fails this part: its fminf / fmaxf folds dropped the NaN and
    returned the other rows' finite stats."""
    from repro_torch.kernels import quantize_chunk

    g = torch.Generator(device=dev).manual_seed(bits + shape[0])
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    x[0, :, 3] = 1.5
    before = qp.quant_pack.launches
    got = quantize_chunk(x, bits)
    assert qp.quant_pack.launches == before + 1
    for a, b in zip(got, quant_pack_ref(x, bits)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert float(got[1][0, 3]) == pytest.approx(1e-8)
    for a, b in zip(got, quantize_chunk(x, bits)):
        assert torch.equal(a, b), "two calls differ"

    xn = non_finite(x)
    got = quantize_chunk(xn, bits)
    want = quant_pack_ref(xn, bits)
    for name, a, b in zip(("packed", "scale", "zero"), got, want):
        assert nan_equal(a, b), f"{name} differs from the plain version on non-finite input"
    packed, scale, zero = got
    nan_cols = torch.isnan(xn.float()).any(dim=1)
    assert torch.equal(torch.isnan(scale), nan_cols) and torch.equal(torch.isnan(zero), nan_cols)
    assert float(scale[0, 1]) == float("inf") and float(zero[0, 2]) == -float("inf")
    assert float(scale[0, 4]) == float("inf") and float(zero[0, 4]) == -float("inf")
    codes = packing.unpack(packed, bits, shape[2])
    assert int(codes[0, :, 0].abs().sum()) == 0


def test_quant_pack_wrapper_rejects_what_the_kernel_does_not_take(dev):
    x = torch.randn(2, 16, 64, device=dev)
    with pytest.raises(ValueError, match="bits"):
        qp.quant_pack(x, 3)
    with pytest.raises(ValueError, match="multiple of 16"):
        qp.quant_pack(x[..., :40], 2)
    with pytest.raises(ValueError, match="contiguous"):
        qp.quant_pack(x.transpose(1, 2), 4)


# ---------------------------------------------------------------------------
# the redesigned flash_prefill (TMA ring + wgmma) and gear_decode (byte-lean
# decode regime, tensor-core history regime)

FLASH_MASKS = {"causal": dict(), "window_softcap": dict(window=48, softcap=30.0),
               "prefix": dict(prefix_len=40), "kv_repeat": dict(kv_repeat=2)}


@pytest.mark.parametrize("mask", list(FLASH_MASKS))
@pytest.mark.parametrize("Dh", [64, 128, 256])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 127, 129, 1000])
def test_flash_prefill_kernel_ragged_lengths(dev, S, Dh, mask):
    """Every sequence length class around the 64-token tiles (TMA zero-fills
    the ragged tail of the 3-D map), every head dim (one, two or four
    128-byte swizzled boxes per tile row; two consumer warpgroups at 256),
    every mask."""
    kw = FLASH_MASKS[mask]
    rep = kw.get("kv_repeat", 1)
    g = torch.Generator(device=dev).manual_seed(S * Dh)
    q = torch.randn(4, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(4 // rep, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(4 // rep, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    before = fp.flash_prefill.launches
    got = fp.flash_prefill(q, k, v, **kw)
    assert fp.flash_prefill.launches == before + 1
    torch.testing.assert_close(got.float(), flash_prefill_ref(q, k, v, **kw).float(),
                               rtol=0, atol=3e-2)


GEMMA_FLASH = {"causal": dict(), "window_softcap": dict(window=300, softcap=50.0),
               "prefix": dict(prefix_len=256)}


@pytest.mark.parametrize("mask", list(GEMMA_FLASH))
@pytest.mark.parametrize("S", [1000, 333])
def test_flash_prefill_kernel_at_gemma_shape(dev, S, mask):
    """Head_dim 256 at gemma-2b's MQA: 4 slots x 8 query heads over one KV
    head each (kv_repeat 8), a ragged S, window + softcap, and a 256-token
    bidirectional prefix (paligemma's)."""
    kw = dict(GEMMA_FLASH[mask], kv_repeat=8)
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(32, S, 256, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(4, S, 256, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(4, S, 256, generator=g, device=dev).to(torch.bfloat16)
    torch.testing.assert_close(fp.flash_prefill(q, k, v, **kw).float(),
                               flash_prefill_ref(q, k, v, **kw).float(), rtol=0, atol=3e-2)


@pytest.mark.parametrize("S", [1500, 1024, 1025])
def test_flash_prefill_kernel_at_gemma3_local_shape(dev, S):
    """Head_dim 256 at gemma3-12b's local layers: 16 query heads over 8 KV
    heads (kv_repeat 2) with the 1024-token sliding window, at a prompt past
    it and at its edge."""
    kw = dict(window=1024, kv_repeat=2)
    g = torch.Generator(device=dev).manual_seed(S)
    q = torch.randn(16, S, 256, generator=g, device=dev).to(torch.bfloat16)
    k = torch.randn(8, S, 256, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(8, S, 256, generator=g, device=dev).to(torch.bfloat16)
    torch.testing.assert_close(fp.flash_prefill(q, k, v, **kw).float(),
                               flash_prefill_ref(q, k, v, **kw).float(), rtol=0, atol=3e-2)


def dup_fixture(dev, polname, B, H, Dh, S, seed):
    """A cache whose row 0 holds a constant K channel and a constant V token,
    so top-k and bottom-k store the same outlier index twice."""
    cfg = cache.CacheConfig(batch=B, kv_heads=H, head_dim=Dh, capacity=S,
                            policy=named_policy(polname))
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.randn(B, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    v = torch.randn(B, H, S, Dh, generator=g, device=dev).to(torch.bfloat16)
    k[0, 0, :, 5] = 3.0
    v[0, 0, 10, :] = 2.0
    c = cache.prefill_layer_cache(cfg, cache.init_layer_cache(cfg, torch.bfloat16, dev), k, v)
    half = c.k_sp_idx.shape[-1] // 2
    assert bool((c.k_sp_idx[..., 0] == c.k_sp_idx[..., half]).any())
    arrays, lr, sp = ops._gear_operands(cfg, c, B * H)
    return cfg, arrays, lr | sp, g


@pytest.mark.parametrize("blocks_per_sm", [1, gd.BLOCKS_PER_SM])
@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("G,Dh", [(1, 128), (5, 64), (64, 128), (12, 128), (12, 64),
                                  (8, 256), (2, 256), (1, 256), (64, 256)])
def test_gear_decode_regimes_match_plain(dev, polname, G, Dh, blocks_per_sm, monkeypatch):
    """G = 1, 2, 5, 8 and 12 take the decode regime (split chunks merged by
    the last block; a small ``BLOCKS_PER_SM`` gives each block several
    chunks, the next one prefetched; G = 12 its 16-row build), G = 64 the
    tensor-core regime; head_dim 64, 128 and 256 (two channels a thread of
    the per-channel terms, gear_kivi2's 4 V stat groups); C = 18 chunks,
    ragged extents including 0, duplicated outlier indices."""
    monkeypatch.setattr(gd, "BLOCKS_PER_SM", blocks_per_sm)
    B, H, S = 4, 4, 1152
    cfg, arrays, extra, g = dup_fixture(dev, polname, B, H, Dh, S, seed=G)
    n_comp = torch.tensor([0, 64, 640, 1152], dtype=torch.int32, device=dev).repeat_interleave(H)
    q = torch.randn(B * H, G, Dh, generator=g, device=dev)
    kw = dict(bits=cfg.policy.bits, chunk=64, scale_factor=Dh ** -0.5, **extra)
    for _ in range(2):                     # the second launch finds the tickets cleared
        acc_k, m_k, l_k = gd.gear_decode(q, *arrays, n_comp, **kw)
    acc_p, m_p, l_p = gear_decode_ref(q, *arrays, n_comp, **kw)
    live = n_comp > 0
    torch.testing.assert_close((acc_k / l_k[..., None])[live], (acc_p / l_p[..., None])[live],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(m_k[live], m_p[live], rtol=0, atol=1e-3)
    assert (acc_k[~live] == 0).all() and (l_k[~live] == 0).all()
    assert (m_k[~live] == -1e30).all()


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_decode_twelve_rows_take_the_decode_body_and_match_the_history_body(dev, polname):
    """starcoder2-3b's G = 12 (24 query heads over 2 KV heads, head_dim 128):
    the decode regime's 16-row build, and the same operands through the
    tensor-core body (``tensor_cores=True``), both within 1e-3 of the plain
    version; one launch each."""
    B, H, S = 4, 2, 1152
    cfg, arrays, extra, g = dup_fixture(dev, polname, B, H, 128, S, seed=12)
    n_comp = torch.tensor([0, 64, 640, 1152], dtype=torch.int32, device=dev).repeat_interleave(H)
    q = torch.randn(B * H, 12, 128, generator=g, device=dev)
    kw = dict(bits=cfg.policy.bits, chunk=64, scale_factor=128 ** -0.5, **extra)
    acc_p, m_p, l_p = gear_decode_ref(q, *arrays, n_comp, **kw)
    live = n_comp > 0
    for tensor_cores in (False, True):
        before = gd.gear_decode.launches
        acc_k, m_k, l_k = gd.gear_decode(q, *arrays, n_comp, tensor_cores=tensor_cores, **kw)
        assert gd.gear_decode.launches == before + 1
        torch.testing.assert_close((acc_k / l_k[..., None])[live],
                                   (acc_p / l_p[..., None])[live], rtol=0, atol=1e-3)
        torch.testing.assert_close(m_k[live], m_p[live], rtol=0, atol=1e-3)


@pytest.mark.parametrize("Dh", [128, 256])
@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
def test_gear_decode_history_matches_plain_and_per_block_calls(dev, polname, Dh):
    """The batched history entry (one launch for every in-flight block of a
    layer) against its plain version and against one ``gear_decode`` call
    per block; it counts one ``gear_decode`` launch.  At head_dim 256 the
    body splits the channels across two warps per row group (gear_kivi2:
    4 V stat groups)."""
    H, S, NB = 8, 1152, 14
    cfg, arrays, extra, g = dup_fixture(dev, polname, 1, H, Dh, S, seed=11)
    q = torch.randn(H, NB, 64, Dh, generator=g, device=dev)
    extents = [64 * i for i in range(NB)]
    kw = dict(bits=cfg.policy.bits, chunk=64, scale_factor=Dh ** -0.5, **extra)
    before = gd.gear_decode.launches
    acc, m, l = gd.gear_decode_history(q, *arrays, extents, **kw)
    assert gd.gear_decode.launches == before + 1
    acc_p, m_p, l_p = gd.gear_decode_history_ref(q, *arrays, extents, **kw)
    live = torch.tensor(extents, device=dev)[None, :, None].expand(H, NB, 64) > 0
    torch.testing.assert_close((acc / l[..., None])[live], (acc_p / l_p[..., None])[live],
                               rtol=0, atol=1e-3)
    torch.testing.assert_close(m[live], m_p[live], rtol=0, atol=1e-3)
    for i, e in enumerate(extents):
        one = gd.gear_decode(q[:, i].contiguous(), *arrays, e, **kw)
        for a, b in zip((acc[:, i], m[:, i], l[:, i]), one):
            assert torch.equal(a, b)


@pytest.mark.parametrize("polname", ["gear_kcvt4", "gear_kivi2"])
@pytest.mark.parametrize("G,Dh", [(1, 128), (5, 128), (64, 128), (12, 128), (8, 256),
                                  (64, 256)])
def test_gear_decode_paged_equals_dense_every_regime(dev, polname, G, Dh):
    """Paged ≡ dense bit for bit under both regimes, over a shuffled pool of
    18-chunk slots (several decode splits per row), at head_dim 128 and 256."""
    B, H, S, nb = 2, 4, 1152, 64
    cfg, arrays, extra, g = dup_fixture(dev, polname, B, H, Dh, S, seed=5)
    C = S // nb
    names = ("k_packed", "k_scale", "k_zero", "v_packed", "v_scale", "v_zero")
    dense = dict(zip(names, arrays)) | extra
    live = [3, 18]
    n_comp = torch.tensor([64 * live[0] - 10] * H + [S] * H, dtype=torch.int32, device=dev)
    n_comp = n_comp // nb * nb
    P = 1 + sum(live)
    pages = iter((torch.randperm(P - 1, generator=torch.Generator().manual_seed(1)) + 1).tolist())
    bt = torch.zeros((B, C), dtype=torch.int32)
    for b in range(B):
        for c in range(live[b]):
            bt[b, c] = next(pages)
    bt = bt.to(dev)
    pools = {}
    for name, x in dense.items():
        rpc = x.shape[1] // C
        pool = torch.zeros((P * H, rpc) + tuple(x.shape[2:]), dtype=x.dtype, device=dev)
        for b in range(B):
            for c in range(live[b]):
                p = int(bt[b, c])
                pool[p * H:(p + 1) * H] = x[b * H:(b + 1) * H, c * rpc:(c + 1) * rpc]
        pools[name] = pool
    gathered = gather_paged_operands(bt, B * H, pools)
    q = torch.randn(B * H, G, Dh, generator=g, device=dev)
    kw = dict(bits=cfg.policy.bits, chunk=nb, scale_factor=Dh ** -0.5)
    paged = gd.gear_decode_paged(q, *[pools[n] for n in names], n_comp, bt, **kw,
                                 **{n: pools[n] for n in extra})
    flat = gd.gear_decode(q, *[gathered[n] for n in names], n_comp, **kw,
                          **{n: gathered[n] for n in extra})
    for a, b in zip(paged, flat):
        assert torch.equal(a, b)


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 11008), (11008, 4096)])
def test_prefill_row_products_do_not_depend_on_row_count(dev, K, N):
    """llama2-7b's prefill products (wo, w_gate / w_up, w_down; bf16) through
    ``common.rowwise``: a one-chunk suffix's rows equal the same rows inside
    a cold prefill's product bit for bit (cuBLAS gives a 64-row
    [64, 11008] x [11008, 4096] product other bits; ROADMAP §3)."""
    from repro_torch.models.common import rowwise

    g = torch.Generator(device=dev).manual_seed(K + N)
    w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
    x = torch.randn(1, 1152, K, generator=g, device=dev).to(torch.bfloat16)
    cold = rowwise(lambda t: t @ w, x)
    for lo, hi in ((512, 576), (512, 640), (1088, 1152), (0, 64)):
        assert torch.equal(rowwise(lambda t: t @ w, x[:, lo:hi]), cold[:, lo:hi]), (lo, hi)


def test_wave_prefill_row_matches_batch1_prefill(dev):
    """A batch-4 monolithic prefill (the wave path: ``flash_prefill`` at BHq =
    4 x heads, the plain compression at batch 4) computes, row for row, what
    a batch-1 prefill of the same left-padded prompt does: its last-position
    logits bit for bit, as ``chip_smoke.py`` path 7; smoke llama2-7b at head_dim
    128 (the card's ``flash_prefill`` build), four prompts padded to 300."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import _pad

    cfg = dataclasses.replace(smoke_config("llama2-7b"), head_dim=128, num_layers=4)
    model = build_model(cfg)
    eng = Engine(model, model.init(seed=0, device=dev),
                 EngineConfig(batch=4, capacity=384, policy=named_policy("gear_kcvt4")),
                 device=dev)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (300, 211, 97, 256)]
    padded = np.stack([_pad(p, 300) for p in prompts])
    before = fp.flash_prefill.launches
    wave, _ = eng.prefill({"tokens": padded})
    assert fp.flash_prefill.launches - before == cfg.num_layers
    for i in range(4):
        one, _ = eng.prefill({"tokens": padded[i:i + 1]})
        err = float((one[0].float() - wave[i].float()).abs().max())
        assert torch.equal(one[0], wave[i]), (i, err)


# ---------------------------------------------------------------------------
# served output across devices


CROSS_PREFILL_ATOL = 0.1             # PREFILL_LOGIT_ATOL of tests/test_torch_wave.py
CROSS_GAP = 0.25                     # that file's teacher-forced gap bound
CROSS_CASES = {    # id: (arch, policy, head_dim, EngineConfig overrides[, config overrides])
    "llama2-gear_kcvt4-streaming-paged": ("llama2-7b", "gear_kcvt4", 64,
                                          dict(prefill_mode="streaming", layout="paged")),
    "llama2-gear_kcvt4-monolithic-dense": ("llama2-7b", "gear_kcvt4", 64, {}),
    "llama2-gear_kivi2-streaming-paged": ("llama2-7b", "gear_kivi2", 64,
                                          dict(prefill_mode="streaming", layout="paged")),
    "llama2-gear_kivi2-monolithic-dense": ("llama2-7b", "gear_kivi2", 64, {}),
    "hymba-gear_kcvt4": ("hymba-1.5b", "gear_kcvt4", 64, {}),
    "rwkv6-gear_kcvt4": ("rwkv6-3b", "gear_kcvt4", None, {}),
    "llama2-fp16": ("llama2-7b", "fp16", 64, {}),
    "llama2-per_token_q4": ("llama2-7b", "per_token_q4", 64, {}),
    "minicpm-gear_kcvt4": ("minicpm-2b", "gear_kcvt4", 64, {}),
    "starcoder2-gear_kcvt4": ("starcoder2-3b", "gear_kcvt4", 64, {}),
    "gemma-gear_kcvt4": ("gemma-2b", "gear_kcvt4", 64, {}),
    "gemma-gear_kivi2-dh256-streaming-paged": ("gemma-2b", "gear_kivi2", 256,
                                               dict(prefill_mode="streaming", layout="paged")),
    "gemma-gear_kcvt4-dh256": ("gemma-2b", "gear_kcvt4", 256, {}),
    # gemma3's 5 local + 1 global units with a window below the prompts: the
    # rings wrap in prefill and decode
    "gemma3-gear_kcvt4-window64": ("gemma3-12b", "gear_kcvt4", 64, {}, dict(local_window=64)),
    "gemma3-gear_kcvt4-window64-streaming-paged": (
        "gemma3-12b", "gear_kcvt4", 64, dict(prefill_mode="streaming", layout="paged"),
        dict(local_window=64)),
    # text-only requests, decoding after the 8 image positions they do not carry
    "paligemma-gear_kcvt4-continuous": ("paligemma-3b", "gear_kcvt4", 64, {}),
}


def cross_model(case):
    """One cross case's smoke model, its seeded CPU weights and a copy on the card."""
    import copy
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model

    arch, _, head_dim, _, *cfg_over = CROSS_CASES[case] if isinstance(case, str) else case
    cfg = smoke_config(arch)
    if head_dim is not None:
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    cfg = dataclasses.replace(cfg, **(cfg_over[0] if cfg_over else {}))
    model = build_model(cfg)
    cpu = model.init(seed=0, device="cpu")
    return cfg, model, cpu, copy.deepcopy(cpu)


def serve_across(case, dev, lengths=(120, 190), gen=12):
    """Serve one case's requests on the CPU and on ``dev`` with the same
    weights (seeded on the CPU, then copied), then teacher-force both
    devices' batch-1 engines along ``dev``'s tokens.  The default prompts
    close chunks in prefill and, 8 and 2 tokens in, during decode.  Returns (CPU results,
    ``dev`` results, per-request (CPU logits, ``dev`` logits) [T, V])."""
    import numpy as np

    from repro_torch.serving import Engine, EngineConfig, Request, Scheduler

    _, polname, _, over, *_ = CROSS_CASES[case]
    cfg, model, cpu, copy_ = cross_model(case)
    params = {"cpu": cpu, "dev": copy_.to(dev)}                 # Module.to moves in place
    devices = {"cpu": torch.device("cpu"), "dev": dev}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).astype(np.int32) for n in lengths]
    cap = 256
    results = {}
    for side in ("cpu", "dev"):
        eng = Engine(model, params[side], EngineConfig(
            batch=2, capacity=cap, policy=named_policy(polname), **over), device=devices[side])
        sched = Scheduler(eng)
        for rid, p in enumerate(prompts):
            sched.submit(Request(rid=rid, tokens=p, max_new_tokens=gen))
        results[side] = {r.rid: r for r in sched.run_continuous()}
    along = {}
    for rid, p in enumerate(prompts):
        toks = np.asarray(results["dev"][rid].tokens)
        rows = {}
        for side in ("cpu", "dev"):
            eng = Engine(model, params[side], EngineConfig(
                batch=1, capacity=cap, policy=named_policy(polname), **over),
                device=devices[side])
            view = eng.new_view()
            logits = view.prefill_slot({"tokens": p[None]}, 0, reserve_tokens=len(p) + gen)
            out = [logits[0, -1].float().cpu().numpy()]
            start = eng._prompt_len({"tokens": p[None]})         # a VLM's after its prefix
            for i, tok in enumerate(toks[:-1]):
                logits = view.decode({"tokens": np.array([[tok]], np.int32)},
                                     np.array([start + i]))
                out.append(logits[0, -1].float().cpu().numpy())
            rows[side] = np.stack(out)
        along[rid] = (rows["cpu"], rows["dev"])
    return results["cpu"], results["dev"], along


@pytest.mark.parametrize("case", list(CROSS_CASES))
def test_served_output_matches_the_cpu_port(dev, case):
    """The smoke configs at head_dim 64 (gemma-2b also at 256: the kernels'
    builds) served on the card and on the CPU (where the kernels' plain versions run) with the same
    seeded weights: statuses equal; prefill logits within
    ``CROSS_PREFILL_ATOL``; every token the card served is the card's argmax
    when both devices are teacher-forced along the card's stream, the
    devices' logit gap stays within ``CROSS_GAP``, and the CPU's tokens leave
    the card's only where the CPU's top-2 margin is within twice the gap.
    The CPU port is held against the reference elsewhere, so this closes the
    chain from the card to the reference."""
    import numpy as np

    cpu, card, along = serve_across(case, dev)
    assert {r: str(x.status) for r, x in card.items()} == {r: str(x.status)
                                                           for r, x in cpu.items()}
    for rid, (lc, ld) in along.items():
        toks, want = np.asarray(card[rid].tokens), np.asarray(cpu[rid].tokens)
        gaps = np.abs(lc - ld).max(-1)
        print(f"{case} rid {rid}: prefill gap {gaps[0]:.4f}, largest gap {gaps.max():.4f}")
        assert gaps[0] <= CROSS_PREFILL_ATOL, (rid, gaps[0])
        assert (gaps <= CROSS_GAP).all(), (rid, gaps)
        np.testing.assert_array_equal(toks, ld.argmax(-1))
        m = min(len(toks), len(want))
        diff = np.flatnonzero(toks[:m] != want[:m])
        if diff.size:
            top2 = np.sort(lc[diff[0]])[-2:]
            assert top2[1] - top2[0] <= 2 * gaps[diff[0]], (rid, toks, want)


def test_served_vlm_wave_matches_the_cpu_port(dev):
    """paligemma's smoke config at head_dim 64 in wave mode (``Engine.generate``
    on text behind seeded image embeddings) on the card and the CPU with the
    same weights: every token the card served is the card's argmax when both
    devices are teacher-forced at batch 2 along the card's tokens, and the
    devices' logit gap stays within ``CROSS_GAP`` (prefill within
    ``CROSS_PREFILL_ATOL``)."""
    import numpy as np

    from repro_torch.serving import Engine, EngineConfig

    cfg, model, cpu, copy_ = cross_model(("paligemma-3b", "gear_kcvt4", 64, {}))
    params = {"cpu": cpu, "dev": copy_.to(dev)}
    devices = {"cpu": torch.device("cpu"), "dev": dev}
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab_size, size=(2, 150)).astype(np.int32)
    img = torch.from_numpy(rng.standard_normal((2, cfg.num_prefix_tokens, cfg.d_model))
                           .astype(np.float32)).to(torch.bfloat16)
    engines = {side: Engine(model, params[side], EngineConfig(
        batch=2, capacity=256, policy=named_policy("gear_kcvt4")), device=devices[side])
        for side in devices}
    served, _ = engines["dev"].generate({"tokens": toks, "img_embeds": img.to(dev)}, 12)
    rows = {}
    for side, eng in engines.items():
        logits, caches = eng.prefill({"tokens": toks, "img_embeds": img.to(devices[side])})
        out = [logits[:, -1].float().cpu().numpy()]
        start = eng._prompt_len({"tokens": toks})
        for t in range(served.shape[1] - 1):
            logits, caches = eng.decode({"tokens": np.ascontiguousarray(served[:, t:t + 1])},
                                        caches, np.full(2, start + t, np.int32))
            out.append(logits[:, -1].float().cpu().numpy())
        rows[side] = np.stack(out, 1)
    gaps = np.abs(rows["cpu"] - rows["dev"]).max(-1)
    print(f"paligemma wave: prefill gap {gaps[:, 0].max():.4f}, largest gap {gaps.max():.4f}")
    assert (gaps[:, 0] <= CROSS_PREFILL_ATOL).all(), gaps[:, 0]
    assert (gaps <= CROSS_GAP).all(), gaps
    np.testing.assert_array_equal(served, rows["dev"].argmax(-1))


def test_kernel_wrappers_refuse_grad_on_the_card(dev):
    """A serving kernel's CUDA operand that requires grad raises while grad
    mode is on (the ctypes call would cut the autograd graph); under
    ``inference_mode`` the same call launches.  ``linear_scan_chunked``
    takes a gradient through its backward kernel: a hybrid's training step
    on the card runs the scan forward twice a layer (``dots`` remat
    recomputes it) and its backward once, a dense model's trains through
    ``attention_train`` without any kernel."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import build_model

    g = torch.Generator(device=dev).manual_seed(0)
    r, k, v = (torch.randn(4, 64, 16, device=dev, generator=g) for _ in range(3))
    lw = -torch.rand(4, 64, 16, device=dev, generator=g)
    r.requires_grad_(True)
    bwd = lsk.linear_scan_chunked_bwd.launches
    y, _ = lsk.linear_scan_chunked(r, k, v, lw, chunk=64)
    y.sum().backward()
    assert lsk.linear_scan_chunked_bwd.launches == bwd + 1
    assert r.grad is not None and torch.isfinite(r.grad).all()
    q = torch.randn(4, 64, 64, device=dev, dtype=torch.bfloat16, requires_grad=True)
    with pytest.raises(RuntimeError, match="attention_train"):
        fp.flash_prefill(q, q.detach(), q.detach())
    with torch.inference_mode():
        fp.flash_prefill(q, q.detach(), q.detach())
    for arch, scans in (("hymba-1.5b", True), ("minicpm-2b", False)):
        cfg = smoke_config(arch)
        m = build_model(cfg)
        params = m.init(seed=0, device=dev, dtype=torch.float32).requires_grad_(True)
        tokens = torch.randint(0, cfg.vocab_size, (2, 64), device=dev, generator=g)
        before = {name: fn.launches for name, fn in
                  (("scan", lsk.linear_scan_chunked), ("scan_bwd", lsk.linear_scan_chunked_bwd),
                   ("flash", fp.flash_prefill))}
        loss, _ = m.loss_fn(params, {"tokens": tokens}, remat=True, remat_policy="dots")
        loss.backward()
        assert all(p.grad is not None and torch.isfinite(p.grad).all()
                   for p in params.parameters())
        layers = cfg.num_layers if scans else 0
        assert lsk.linear_scan_chunked.launches == before["scan"] + 2 * layers
        assert lsk.linear_scan_chunked_bwd.launches == before["scan_bwd"] + layers
        assert fp.flash_prefill.launches == before["flash"]


@pytest.mark.parametrize("shape", [(7,), (4, 32000), (80, 3)], ids=str)
def test_prng_draws_on_the_card_equal_the_host_draws(dev, shape):
    """``repro_torch.core.prng`` on the card: the reference's stream, bit for
    bit the host's (the CPU tests hold the host's to ``jax.random``), and
    ``sample`` at temperature 0.8 with ``top_k`` 0 and 40 the host's ids."""
    from repro_torch.core import prng
    from repro_torch.serving.sampling import sample

    key = prng.fold_in(prng.PRNGKey(3), 2 ** 31 + 5)
    for fn in (prng.bits, prng.normal, prng.gumbel):
        got = fn(key, shape, dev)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), fn(key, shape)), fn.__name__
    assert torch.equal(prng.uniform(key, shape, -0.5, 2.0, dev).cpu(),
                       prng.uniform(key, shape, -0.5, 2.0))
    logits = torch.randn((3,) + shape, generator=torch.Generator().manual_seed(0)) * 3
    for top_k in (0, 40):
        want = sample(logits, key, 0.8, top_k)
        assert torch.equal(sample(logits.to(dev), key, 0.8, top_k).cpu(), want)
