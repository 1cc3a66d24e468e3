"""Fused GEAR decode attention: wrapper of ``csrc/gear_decode.cu``.

Port of ``repro.kernels.gear_decode.gear_decode`` (contract of
``ref.gear_decode_ref``).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  ``m`` and ``l`` come back as
``[BH, G]`` (the reference's 128-lane padding is a TPU layout artifact).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gear_decode_ref

__all__ = ["gear_decode"]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("gear_decode").gear_decode_launch
    fn.argtypes = [_P] * 22 + [_I] * 10 + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _expect(x, name, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"gear_decode: {name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"gear_decode: {name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"gear_decode: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"gear_decode: {name} must be contiguous")


def gear_decode(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp,
                k_a=None, k_b=None, v_a=None, v_b=None,
                k_sp_val=None, k_sp_idx=None, v_sp_val=None, v_sp_idx=None,
                *, bits: int, chunk: int, scale_factor: float):
    """Unnormalized decode attention over the compressed history.

    Returns (acc [BH, G, Dh] f32, m [BH, G] f32, l [BH, G] f32); see
    :func:`repro_torch.kernels.ref.gear_decode_ref` for the contract.
    """
    kw = dict(bits=bits, chunk=chunk, scale_factor=scale_factor, k_a=k_a, k_b=k_b,
              v_a=v_a, v_b=v_b, k_sp_val=k_sp_val, k_sp_idx=k_sp_idx,
              v_sp_val=v_sp_val, v_sp_idx=v_sp_idx)
    if q.device.type == "cpu":
        return gear_decode_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
                               n_comp, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"gear_decode: no kernel for device {q.device}")
    dev = q.device
    BH, G, Dh = q.shape
    S = k_packed.shape[1]
    per = 32 // bits
    if bits not in (2, 4, 8) or Dh % per or S % chunk:
        raise ValueError(f"gear_decode: bits={bits}, Dh={Dh}, S={S}, chunk={chunk} unsupported")
    C, L, gv = S // chunk, Dh // per, v_scale.shape[-1]
    if Dh % gv:
        raise ValueError(f"gear_decode: V stat groups {gv} do not divide Dh={Dh}")
    bf16, i32 = torch.bfloat16, torch.int32
    _expect(q, "q", torch.float32, (BH, G, Dh), dev)
    for name, x in (("k_packed", k_packed), ("v_packed", v_packed)):
        _expect(x, name, i32, (BH, S, L), dev)
    for name, x in (("k_scale", k_scale), ("k_zero", k_zero)):
        _expect(x, name, bf16, (BH, C, Dh), dev)
    for name, x in (("v_scale", v_scale), ("v_zero", v_zero)):
        _expect(x, name, bf16, (BH, S, gv), dev)
    if not isinstance(n_comp, torch.Tensor) or n_comp.dim() == 0:
        n_comp = torch.full((BH,), int(n_comp), dtype=i32, device=dev)
    _expect(n_comp, "n_comp", i32, (BH,), dev)
    lr = [k_a, k_b, v_a, v_b]
    sp = [k_sp_val, k_sp_idx, v_sp_val, v_sp_idx]
    if any(x is None for x in lr) and any(x is not None for x in lr):
        raise ValueError("gear_decode: pass all four low-rank factors or none")
    if any(x is None for x in sp) and any(x is not None for x in sp):
        raise ValueError("gear_decode: pass all four outlier arrays or none")
    r = k_a.shape[-1] if k_a is not None else 0
    if r:
        for name, x in (("k_a", k_a), ("v_a", v_a)):
            _expect(x, name, bf16, (BH, S, r), dev)
        for name, x in (("k_b", k_b), ("v_b", v_b)):
            _expect(x, name, bf16, (BH, C, Dh, r), dev)
    ks = k_sp_val.shape[-1] if k_sp_val is not None else 0
    kv = v_sp_val.shape[-1] if v_sp_val is not None else 0
    if ks:
        _expect(k_sp_val, "k_sp_val", bf16, (BH, C, Dh, ks), dev)
        _expect(k_sp_idx, "k_sp_idx", i32, (BH, C, Dh, ks), dev)
        _expect(v_sp_val, "v_sp_val", bf16, (BH, S, kv), dev)
        _expect(v_sp_idx, "v_sp_idx", i32, (BH, S, kv), dev)

    f32 = torch.float32
    part_acc = torch.empty((BH, C, G, Dh), dtype=f32, device=dev)
    part_m = torch.empty((BH, C, G), dtype=f32, device=dev)
    part_l = torch.empty((BH, C, G), dtype=f32, device=dev)
    acc = torch.empty((BH, G, Dh), dtype=f32, device=dev)
    m = torch.empty((BH, G), dtype=f32, device=dev)
    l = torch.empty((BH, G), dtype=f32, device=dev)

    def ptr(x):
        return None if x is None else x.data_ptr()

    code = _launcher()(
        ptr(q), ptr(k_packed), ptr(k_scale), ptr(k_zero), ptr(v_packed), ptr(v_scale),
        ptr(v_zero), *(ptr(x) for x in lr), *(ptr(x) for x in sp), ptr(n_comp),
        ptr(part_acc), ptr(part_m), ptr(part_l), ptr(acc), ptr(m), ptr(l),
        BH, G, S, chunk, Dh, bits, gv, r, ks, kv, float(scale_factor),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(code, "gear_decode")
    gear_decode.launches += 1
    return acc, m, l


gear_decode.launches = 0
