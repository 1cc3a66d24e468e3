"""Fused GEAR decode attention: wrappers of ``csrc/gear_decode.cu``.

Ports of ``repro.kernels.gear_decode.gear_decode`` and its paged twin
``gear_decode_paged`` (contracts of ``ref.gear_decode_ref`` and
``ref.gear_decode_paged_ref``).  A CPU tensor takes the plain version; a
CUDA tensor launches the kernel or raises.  ``m`` and ``l`` come back as
``[BH, G]`` (the reference's 128-lane padding is a TPU layout artifact).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gear_decode_paged_ref, gear_decode_ref

__all__ = ["gear_decode", "gear_decode_paged"]

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher(paged: bool):
    lib = _build.load("gear_decode")
    if paged:
        fn = lib.gear_decode_paged_launch
        fn.argtypes = [_P] * 23 + [_I] * 11 + [ctypes.c_float, _P]
    else:
        fn = lib.gear_decode_launch
        fn.argtypes = [_P] * 22 + [_I] * 10 + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def _expect(x, name, dtype, shape, device, who="gear_decode"):
    if x.device != device:
        raise ValueError(f"{who}: {name} on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{who}: {name} is {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{who}: {name} must be contiguous")


def _checked_operands(who, q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp,
                      lr, sp, *, bits, rows, tok_rows, chk_rows):
    """Validate the operands of either layout: ``rows`` operand rows (BH
    dense, P*H paged) of ``tok_rows`` tokens and ``chk_rows`` chunk rows
    each.  Returns (n_comp as an int32 [BH] tensor, r, ks, kv, gv)."""
    dev = q.device
    BH, G, Dh = q.shape
    per = 32 // bits
    if bits not in (2, 4, 8) or Dh % per:
        raise ValueError(f"{who}: bits={bits}, Dh={Dh} unsupported")
    L, gv = Dh // per, v_scale.shape[-1]
    if Dh % gv:
        raise ValueError(f"{who}: V stat groups {gv} do not divide Dh={Dh}")
    bf16, i32 = torch.bfloat16, torch.int32
    _expect(q, "q", torch.float32, (BH, G, Dh), dev, who)
    for name, x in (("k_packed", k_packed), ("v_packed", v_packed)):
        _expect(x, name, i32, (rows, tok_rows, L), dev, who)
    for name, x in (("k_scale", k_scale), ("k_zero", k_zero)):
        _expect(x, name, bf16, (rows, chk_rows, Dh), dev, who)
    for name, x in (("v_scale", v_scale), ("v_zero", v_zero)):
        _expect(x, name, bf16, (rows, tok_rows, gv), dev, who)
    if not isinstance(n_comp, torch.Tensor) or n_comp.dim() == 0:
        n_comp = torch.full((BH,), int(n_comp), dtype=i32, device=dev)
    _expect(n_comp, "n_comp", i32, (BH,), dev, who)
    if any(x is None for x in lr) and any(x is not None for x in lr):
        raise ValueError(f"{who}: pass all four low-rank factors or none")
    if any(x is None for x in sp) and any(x is not None for x in sp):
        raise ValueError(f"{who}: pass all four outlier arrays or none")
    k_a, k_b, v_a, v_b = lr
    k_sp_val, k_sp_idx, v_sp_val, v_sp_idx = sp
    r = k_a.shape[-1] if k_a is not None else 0
    if r:
        for name, x in (("k_a", k_a), ("v_a", v_a)):
            _expect(x, name, bf16, (rows, tok_rows, r), dev, who)
        for name, x in (("k_b", k_b), ("v_b", v_b)):
            _expect(x, name, bf16, (rows, chk_rows, Dh, r), dev, who)
    ks = k_sp_val.shape[-1] if k_sp_val is not None else 0
    kv = v_sp_val.shape[-1] if v_sp_val is not None else 0
    if ks:
        _expect(k_sp_val, "k_sp_val", bf16, (rows, chk_rows, Dh, ks), dev, who)
        _expect(k_sp_idx, "k_sp_idx", i32, (rows, chk_rows, Dh, ks), dev, who)
        _expect(v_sp_val, "v_sp_val", bf16, (rows, tok_rows, kv), dev, who)
        _expect(v_sp_idx, "v_sp_idx", i32, (rows, tok_rows, kv), dev, who)
    return n_comp, r, ks, kv, gv


def _outputs(BH, C, G, Dh, dev):
    f32 = torch.float32
    return [torch.empty(shape, dtype=f32, device=dev)
            for shape in ((BH, C, G, Dh), (BH, C, G), (BH, C, G), (BH, G, Dh), (BH, G), (BH, G))]


def _ptr(x):
    return None if x is None else x.data_ptr()


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
    BH, G, Dh = q.shape
    S = k_packed.shape[1]
    if S % chunk:
        raise ValueError(f"gear_decode: S={S} is not a multiple of chunk={chunk}")
    C = S // chunk
    lr, sp = [k_a, k_b, v_a, v_b], [k_sp_val, k_sp_idx, v_sp_val, v_sp_idx]
    n_comp, r, ks, kv, gv = _checked_operands(
        "gear_decode", q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp, lr, sp,
        bits=bits, rows=BH, tok_rows=S, chk_rows=C)
    outs = _outputs(BH, C, G, Dh, q.device)
    code = _launcher(False)(
        _ptr(q), _ptr(k_packed), _ptr(k_scale), _ptr(k_zero), _ptr(v_packed), _ptr(v_scale),
        _ptr(v_zero), *map(_ptr, lr), *map(_ptr, sp), _ptr(n_comp), *map(_ptr, outs),
        BH, G, S, chunk, Dh, bits, gv, r, ks, kv, float(scale_factor),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "gear_decode")
    gear_decode.launches += 1
    return outs[3], outs[4], outs[5]


gear_decode.launches = 0


def gear_decode_paged(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp,
                      block_tables, k_a=None, k_b=None, v_a=None, v_b=None,
                      k_sp_val=None, k_sp_idx=None, v_sp_val=None, v_sp_idx=None,
                      *, bits: int, chunk: int, scale_factor: float):
    """:func:`gear_decode` over head-flattened pool pages: every compressed
    operand is ``[P*H, one chunk's rows, ...]`` (page ``p``, head ``h`` at
    row ``p*H + h``) and ``block_tables [B, C]`` (int32) names each slot's
    page for logical chunk ``c``.  Same body as the dense kernel, so its
    triple equals ``gear_decode``'s on the gathered operands bit for bit."""
    kw = dict(bits=bits, chunk=chunk, scale_factor=scale_factor, k_a=k_a, k_b=k_b,
              v_a=v_a, v_b=v_b, k_sp_val=k_sp_val, k_sp_idx=k_sp_idx,
              v_sp_val=v_sp_val, v_sp_idx=v_sp_idx)
    if q.device.type == "cpu":
        return gear_decode_paged_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
                                     n_comp, block_tables, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"gear_decode_paged: no kernel for device {q.device}")
    BH, G, Dh = q.shape
    B, C = block_tables.shape
    if BH % B:
        raise ValueError(f"gear_decode_paged: {BH} rows for {B} block-table rows")
    H = BH // B
    PH = k_packed.shape[0]
    if PH % H:
        raise ValueError(f"gear_decode_paged: pool rows {PH} not a multiple of H={H}")
    _expect(block_tables, "block_tables", torch.int32, (B, C), q.device, "gear_decode_paged")
    lr, sp = [k_a, k_b, v_a, v_b], [k_sp_val, k_sp_idx, v_sp_val, v_sp_idx]
    n_comp, r, ks, kv, gv = _checked_operands(
        "gear_decode_paged", q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp,
        lr, sp, bits=bits, rows=PH, tok_rows=chunk, chk_rows=1)
    outs = _outputs(BH, C, G, Dh, q.device)
    code = _launcher(True)(
        _ptr(q), _ptr(k_packed), _ptr(k_scale), _ptr(k_zero), _ptr(v_packed), _ptr(v_scale),
        _ptr(v_zero), *map(_ptr, lr), *map(_ptr, sp), _ptr(n_comp), _ptr(block_tables),
        *map(_ptr, outs), BH, H, G, C, chunk, Dh, bits, gv, r, ks, kv, float(scale_factor),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "gear_decode_paged")
    gear_decode_paged.launches += 1
    return outs[3], outs[4], outs[5]


gear_decode_paged.launches = 0
