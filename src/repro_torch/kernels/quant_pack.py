"""Fused per-column quantize + int32 bit-pack: wrapper of ``csrc/quant_pack.cu``.

Port of ``repro.kernels.quant_pack.quant_pack`` (contract of
``ref.quant_pack_ref``): each ``[n, d]`` tile of ``x`` is quantized per
column over its n rows (whole-column groups, the KCVT layout) and packed
into int32 lanes, without integer codes ever reaching memory.  The kernel
equals the plain version bit for bit on every input: a column holding a
NaN gets NaN zero and scale (and codes 0), as the reference's kernel gives,
so the cache's numeric guard sees it.  A CPU or meta tensor takes the
plain version (``_build.runs_plain``); a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import quant_pack_ref

__all__ = ["quant_pack"]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("quant_pack").quant_pack_launch
    fn.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    fn.restype = ctypes.c_int
    return fn


def quant_pack(x: torch.Tensor, bits: int):
    """x [N, n, d] f32 or bf16 -> (packed [N, n, d // (32 // bits)] int32,
    scale [N, d] f32, zero [N, d] f32); bits 2, 4 or 8 with d a multiple of
    the codes per lane."""
    if bits not in (2, 4, 8):
        raise ValueError(f"quant_pack: bits must be 2, 4 or 8, got {bits}")
    if x.dim() != 3 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quant_pack: x must be an [N, n, d] f32 or bf16 tensor "
                         f"(got {x.dtype} {tuple(x.shape)})")
    N, n, d = x.shape
    per = 32 // bits
    if n < 1 or d % per:
        raise ValueError(f"quant_pack: tile [{n}, {d}] unsupported at {bits} bits "
                         f"(d must be a multiple of {per})")
    if _build.runs_plain(x):
        return quant_pack_ref(x, bits)
    if x.device.type != "cuda":
        raise ValueError(f"quant_pack: no kernel for device {x.device}")
    _build.refuse_grad("quant_pack", (x,))
    if not x.is_contiguous():
        raise ValueError("quant_pack: x must be contiguous")
    dev = x.device
    packed = torch.empty((N, n, d // per), dtype=torch.int32, device=dev)
    scale = torch.empty((N, d), dtype=torch.float32, device=dev)
    zero = torch.empty((N, d), dtype=torch.float32, device=dev)
    code = _launcher()(x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                       N, n, d, bits, int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "quant_pack")
    quant_pack.launches += 1
    return packed, scale, zero


quant_pack.launches = 0
