"""Causal flash attention for prefill: wrappers of ``csrc/flash_prefill.cu``
and ``csrc/flash_prefill_block.cu``.

Ports of ``repro.kernels.flash_prefill.flash_prefill`` (contract of
``ref.flash_prefill_ref``) and ``flash_prefill_block`` (contract of
``ref.flash_block_ref``).  A CPU or meta tensor takes the plain version
(``_build.runs_plain``); a CUDA tensor launches the kernel or raises.
Any sequence length is legal: the kernel masks the ragged tail itself, so
the reference wrapper's block-size snapping is not needed.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_block_ref, flash_prefill_ref

__all__ = ["flash_prefill", "flash_prefill_block", "HEAD_DIMS", "BLOCK_HEAD_DIMS", "BLOCK_T"]

HEAD_DIMS = (64, 128, 256)       # template instantiations in flash_prefill.cu
BLOCK_HEAD_DIMS = (64, 128, 256)  # template instantiations in flash_prefill_block.cu
BLOCK_T = 64                     # most queries per row-group flash_prefill_block takes

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _block_launcher():
    fn = _build.load("flash_prefill_block").flash_block_launch
    fn.argtypes = [_P] * 7 + [_I] * 4 + [ctypes.c_float, ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


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
    if _build.runs_plain(q):
        return flash_prefill_ref(q, k, v, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: no kernel for device {q.device}")
    _build.refuse_grad("flash_prefill", (q, k, v),
                       "use repro_torch.models.attention.attention_train to train")
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


def flash_prefill_block(q, k, v, kv_len, *, scale: float, softcap: float = 0.0,
                        kv_repeat: int = 1):
    """Unnormalized causal attention of in-flight blocks.  q [N, T, Dh] f32;
    k, v [N / kv_repeat, T, Dh] f32; kv_len [N] int32 (query ``t`` of row
    ``n`` sees keys ``j <= t``, ``j < kv_len[n]``).  Returns (acc [N, T, Dh],
    m [N, T], l [N, T]) in f32."""
    kw = dict(scale=scale, softcap=softcap, kv_repeat=kv_repeat)
    if _build.runs_plain(q):
        return flash_block_ref(q, k, v, kv_len, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_block: no kernel for device {q.device}")
    _build.refuse_grad("flash_prefill_block", (q, k, v),
                       "use repro_torch.models.attention.attention_train to train")
    N, T, Dh = q.shape
    if kv_repeat < 1 or N % kv_repeat:
        raise ValueError(f"flash_prefill_block: kv_repeat={kv_repeat} does not divide {N} rows")
    if T > BLOCK_T:
        raise ValueError(f"flash_prefill_block: {T} queries per row exceed {BLOCK_T}")
    if Dh not in BLOCK_HEAD_DIMS:
        raise ValueError(f"flash_prefill_block: head_dim {Dh} not built (have {BLOCK_HEAD_DIMS})")
    want = (N // kv_repeat, T, Dh)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"flash_prefill_block: {name} must be a contiguous f32 tensor on "
                             f"{q.device} (got {x.dtype} on {x.device})")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_prefill_block: {name} is not 16-byte aligned")
    if tuple(k.shape) != want or tuple(v.shape) != want:
        raise ValueError(f"flash_prefill_block: k/v shapes {tuple(k.shape)}/"
                         f"{tuple(v.shape)}, expected {want}")
    if (not isinstance(kv_len, torch.Tensor) or kv_len.device != q.device
            or kv_len.dtype != torch.int32
            or tuple(kv_len.shape) != (N,) or not kv_len.is_contiguous()):
        raise ValueError(f"flash_prefill_block: kv_len must be a contiguous int32 [{N}] "
                         f"tensor on {q.device}")
    acc = torch.empty_like(q)
    m = torch.empty((N, T), dtype=torch.float32, device=q.device)
    l = torch.empty((N, T), dtype=torch.float32, device=q.device)
    code = _block_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_len.data_ptr(),
                             acc.data_ptr(), m.data_ptr(), l.data_ptr(), N, T, Dh, kv_repeat,
                             float(scale), float(softcap),
                             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "flash_prefill_block")
    flash_prefill_block.launches += 1
    return acc, m, l


flash_prefill_block.launches = 0
