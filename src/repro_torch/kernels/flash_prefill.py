"""Causal flash attention for prefill: wrapper of ``csrc/flash_prefill.cu``.

Port of ``repro.kernels.flash_prefill.flash_prefill`` (contract of
``ref.flash_prefill_ref``).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  Any sequence length is legal: the
kernel masks the ragged tail itself, so the reference wrapper's block-size
snapping is not needed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_prefill_ref

__all__ = ["flash_prefill", "HEAD_DIMS"]

HEAD_DIMS = (64, 128)      # template instantiations in the .cu source

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.load("flash_prefill").flash_prefill_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, ctypes.c_float, _I, _I,
                   ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


def flash_prefill(q, k, v, *, window: int = 0, prefix_len: int = 0,
                  softcap: float = 0.0, kv_repeat: int = 1):
    """q [BHq, S, Dh]; k, v [BHq / kv_repeat, S, Dh] -> [BHq, S, Dh] in q's dtype."""
    kw = dict(window=window, prefix_len=prefix_len, softcap=softcap, kv_repeat=kv_repeat)
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    BH, S, Dh = q.shape
    if kv_repeat < 1 or BH % kv_repeat:
        raise ValueError(f"flash_prefill: kv_repeat={kv_repeat} does not divide {BH} rows")
    want = (BH // kv_repeat, S, Dh)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16 or not x.is_contiguous():
            raise ValueError(f"flash_prefill: {name} must be a contiguous bf16 tensor on "
                             f"{q.device} (got {x.dtype} on {x.device})")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_prefill: {name} is not 16-byte aligned")
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"flash_prefill: k/v shapes {tuple(k.shape)}/{tuple(v.shape)}, "
                         f"expected {want}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {Dh} not built (have {HEAD_DIMS})")
    o = torch.empty_like(q)
    code = _launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH, S, Dh,
                       kv_repeat, float(Dh**-0.5), int(window), int(prefix_len),
                       float(softcap), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_prefill")
    flash_prefill.launches += 1
    return o


flash_prefill.launches = 0
