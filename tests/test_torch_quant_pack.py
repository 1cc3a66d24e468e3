"""The port's ``quant_pack`` (behind ``repro_torch.kernels.quantize_chunk``)
against the JAX reference.

On the CPU the wrapper takes its plain version (``ref.quant_pack_ref``),
which must equal the reference's Pallas kernel in interpret mode and its
jitted oracle bit for bit: packed codes, scale and zero.  Both scale by the
f32 reciprocal of 2**bits - 1 (XLA rewrites the oracle's division so).  The
reference's own entry point on a CPU, ``repro.kernels.ops.quantize_chunk``,
runs the oracle eagerly, which divides: against it the port holds the
reference's own kernel budget (``tests/test_kernels.py``): zero exact, scale
within one f32 ulp, codes off by at most 1 on under 1e-3 of entries
(ROADMAP §3).  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # the suite runs in several worker processes: one thread each,
                           # not torch's default of one per core in every worker

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro_torch.kernels as port_kernels  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.quant_pack import quant_pack as j_quant_pack  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.quant_pack import quant_pack  # noqa: E402
from repro_torch.kernels.ref import quant_pack_ref  # noqa: E402
from torch_fake_device import elsewhere  # noqa: E402

CODE_FLIP_BUDGET = 1e-3
SHAPES = [(4, 64, 128), (2, 16, 64), (1, 64, 256), (8, 32, 32)]   # tests/test_kernels.py:19

_jit_ref = jax.jit(jref.quant_pack_ref, static_argnums=1)


def inputs(shape, dtype: str, seed: int):
    """The same values for both packages: f32 normals, or their bf16 cast."""
    xj = jnp.asarray(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    if dtype == "bf16":
        xj = xj.astype(jnp.bfloat16)
        return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    return xj, torch.from_numpy(np.array(xj))


def equal(got, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=["x".join(map(str, s)) for s in SHAPES])
@pytest.mark.parametrize("bits", [2, 4, 8])
def test_plain_version_is_bit_equal_to_pallas_kernel_and_jitted_oracle(bits, shape, dtype):
    xj, xt = inputs(shape, dtype, seed=bits + sum(shape))
    got = port_kernels.quantize_chunk(xt, bits)
    assert [t.dtype for t in got] == [torch.int32, torch.float32, torch.float32]
    assert got[0].shape == (shape[0], shape[1], shape[2] * bits // 32)
    for want in (j_quant_pack(xj, bits, interpret=True), _jit_ref(xj, bits)):
        for g, w in zip(got, want):
            equal(g, w)


@pytest.mark.parametrize("bits", [2, 4, 8])
def test_against_eager_reference_entry_point_within_its_budget(bits):
    """``repro.kernels.ops.quantize_chunk`` on a CPU divides for the scale
    (eager oracle): the port, which follows the kernel, meets it within the
    reference's own budget, and at these inputs the two do differ (the
    pinned finding of ROADMAP §3)."""
    xj, xt = inputs((256, 64, 128), "bf16", seed=bits)
    xj = xj.astype(jnp.float32)
    xt = xt.float()
    pe, se, ze = jops.quantize_chunk(xj, bits)
    pp, sp, zp = ops.quantize_chunk(xt, bits)
    equal(zp, ze)
    np.testing.assert_allclose(sp.numpy(), np.asarray(se), rtol=2 ** -23, atol=0)
    flips = np.abs(packing.unpack(pp, bits, 128).numpy()
                   - np.asarray(packing.unpack(torch.from_numpy(np.array(pe)), bits, 128)))
    assert flips.max() <= 1
    assert 0 < (flips > 0).mean() < CODE_FLIP_BUDGET
    assert not np.array_equal(sp.numpy(), np.asarray(se))    # the scale's last bit moves


def test_plain_version_is_the_cache_quantizer():
    """``quant_pack_ref`` is the cache's per-channel quantizer with
    whole-column groups and f32 stats."""
    from repro_torch.core import quant

    x = torch.randn(3, 64, 32, generator=torch.Generator().manual_seed(0))
    qt = quant.quantize(x, 4, "per_channel")
    packed, scale, zero = quant_pack_ref(x, 4)
    assert torch.equal(packed, qt.packed)
    assert torch.equal(scale, qt.scale[:, 0]) and torch.equal(zero, qt.zero[:, 0])
    codes = packing.unpack(packed, 4, 32).float()
    assert float((codes * scale[:, None] + zero[:, None] - x).abs().max()) <= float(
        scale.max()) / 2 + 1e-6


def test_wrapper_rejects_what_the_kernel_does_not_take_and_cpu_does_not_count():
    x = torch.randn(2, 16, 64)
    for bad_bits in (1, 3, 16):
        with pytest.raises(ValueError, match="bits"):
            quant_pack(x, bad_bits)
    with pytest.raises(ValueError, match="multiple of 16"):
        quant_pack(torch.randn(2, 16, 40), 2)
    with pytest.raises(ValueError, match="f32 or bf16"):
        quant_pack(x.half(), 4)
    with pytest.raises(ValueError, match=r"\[N, n, d\]"):
        quant_pack(x[0], 4)
    before = quant_pack.launches
    port_kernels.quantize_chunk(x, 4)
    quant_pack(x.to(torch.bfloat16), 8)
    assert quant_pack.launches == before                   # CPU tensors: the plain version
    meta = port_kernels.quantize_chunk(x.to("meta"), 4)    # meta (the dry run): the plain version
    assert [t.shape for t in meta] == [t.shape for t in port_kernels.quantize_chunk(x, 4)]
    assert quant_pack.launches == before
    # a device with neither a kernel nor a plain version
    with pytest.raises(ValueError, match="no kernel for device"):
        port_kernels.quantize_chunk(elsewhere(x), 4)
    assert port_kernels.quantize_chunk is ops.quantize_chunk
    assert "quantize_chunk" in port_kernels.__all__
