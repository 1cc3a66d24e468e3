"""Fused GEAR chunk compression: wrapper of ``csrc/gear_compress.cu``.

Port of ``repro.kernels.gear_compress.gear_compress`` (contract of
``ref.gear_compress_ref``): outliers, quantization, packing, stats and the
f32 residual of a batch of ``[nb, d]`` chunk tiles in one launch.  A CPU
or meta tensor takes the plain version (``_build.runs_plain``); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gear_compress_ref

__all__ = ["gear_compress", "MAX_OUT"]

MAX_OUT = 8          # outliers per extreme the kernel keeps in registers

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("gear_compress").gear_compress_launch
    fn.argtypes = [_P] * 7 + [_I] * 8 + [_P]
    fn.restype = ctypes.c_int
    return fn


def gear_compress(x: torch.Tensor, *, bits: int, scheme: str, group: int | None = None,
                  n_out: int = 0, stat_dtype="bfloat16"):
    """Compress ``x`` [N, nb, d] f32.  Returns (packed, scale, zero, sp_val,
    sp_idx, resid) as :func:`repro_torch.kernels.ref.gear_compress_ref`
    (sp_* None when ``n_out == 0``)."""
    kw = dict(bits=bits, scheme=scheme, group=group, n_out=n_out, stat_dtype=stat_dtype)
    if _build.runs_plain(x):
        return gear_compress_ref(x, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"gear_compress: no kernel for device {x.device}")
    _build.refuse_grad("gear_compress", (x,))
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"gear_compress: x must be a contiguous [N, nb, d] f32 tensor "
                         f"(got {x.dtype} {tuple(x.shape)})")
    if x.data_ptr() % 16:
        raise ValueError("gear_compress: x is not 16-byte aligned")
    N, nb, d = x.shape
    per_channel = scheme == "per_channel"
    if scheme not in ("per_channel", "per_token", "per_token_group"):
        raise ValueError(f"gear_compress: unknown scheme {scheme!r}")
    if group is None:
        group = nb if per_channel else d
    per = 32 // bits
    vec = nb if per_channel else d
    if (bits not in (2, 4, 8) or d % per or (nb if per_channel else d) % group
            or n_out > MAX_OUT or 2 * n_out > vec or nb * d > 64 * 256):
        raise ValueError(f"gear_compress: bits={bits}, tile [{nb}, {d}], group={group}, "
                         f"n_out={n_out} unsupported")
    sd = str(stat_dtype).removeprefix("torch.")
    if sd not in ("bfloat16", "float32"):
        raise ValueError(f"gear_compress: stat_dtype {stat_dtype} unsupported")
    dev, f32 = x.device, torch.float32
    stat = (N, nb // group, d) if per_channel else (N, nb, d // group)
    sp_shape = (N, d if per_channel else nb, 2 * n_out)
    packed = torch.empty((N, nb, d // per), dtype=torch.int32, device=dev)
    scale = torch.empty(stat, dtype=f32, device=dev)
    zero = torch.empty(stat, dtype=f32, device=dev)
    sp_val = torch.empty(sp_shape, dtype=f32, device=dev) if n_out else None
    sp_idx = torch.empty(sp_shape, dtype=torch.int32, device=dev) if n_out else None
    resid = torch.empty_like(x)
    code = _launcher()(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        None if sp_val is None else sp_val.data_ptr(),
        None if sp_idx is None else sp_idx.data_ptr(), resid.data_ptr(),
        N, nb, d, bits, group, int(per_channel), n_out, int(sd == "bfloat16"),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "gear_compress")
    gear_compress.launches += 1
    return packed, scale, zero, sp_val, sp_idx, resid


gear_compress.launches = 0
