"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports torch and the port only (the machine with the card has no JAX).
Every test is marked ``cuda`` and skips without a CUDA device:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: ``gear_decode`` 1e-3 on the normalized output and score max of
rows with history (f32 on both sides, different summation order; a row with
no closed chunk returns (0, -1e30, 0) from the kernel by design, see
``csrc/gear_decode.cu``); ``flash_prefill`` 3e-2 on the bf16 output (the
kernel rounds P to bf16 before P·V).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import cache  # noqa: E402
from repro_torch.core.policy import named_policy  # noqa: E402
from repro_torch.kernels import flash_prefill as fp  # noqa: E402
from repro_torch.kernels import gear_decode as gd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import flash_prefill_ref, gear_decode_ref  # noqa: E402

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
