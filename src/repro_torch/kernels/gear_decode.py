"""Fused GEAR decode attention: wrappers of ``csrc/gear_decode.cu`` and
``csrc/gear_decode_paged.cu`` (one body, ``csrc/gear_decode.cuh``).

Ports of ``repro.kernels.gear_decode.gear_decode`` and its paged twin
``gear_decode_paged`` (contracts of ``ref.gear_decode_ref`` and
``ref.gear_decode_paged_ref``), and ``gear_decode_history``: the same
function over every in-flight block of a streaming prefill layer in one
launch (contract of ``ref.gear_decode_history_ref``).  A CPU or meta tensor
takes the plain version (``_build.runs_plain``); a CUDA tensor launches
the kernel or raises.  ``m`` and
``l`` come back as ``[BH, G]`` (the reference's 128-lane padding is a TPU
layout artifact).

The kernel has two regimes: up to ``DECODE_ROWS`` query rows per row run
the byte-lean decode body (CUDA cores, chunks split across blocks so the
grid covers the card, the splits merged in the same launch; built for G = 1,
G <= 8 and 8 < G <= 16); more run the tensor-core history body, as does a
:func:`gear_decode` call with ``tensor_cores=True``.  Both are built at
head_dim 64, 128 and 256; the history body for the (head_dim, V stat
groups) pairs of ``HISTORY_BUILDS``.  All three entries count under
``gear_decode.launches`` and ``gear_decode_paged.launches``, one per launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (gear_decode_history_ref, gear_decode_paged_ref,
                                     gear_decode_ref)

__all__ = ["gear_decode", "gear_decode_paged", "gear_decode_history", "DECODE_ROWS",
           "HEAD_DIMS", "HISTORY_BUILDS"]

DECODE_ROWS = 16           # most query rows per row of the decode regime (GMAX in the source)
HEAD_DIMS = (64, 128, 256)
# (head_dim, V stat groups) of the history body's instantiations: gear_kcvt4's
# one group at every head_dim, gear_kivi2's 64-channel groups (Dh / 64)
HISTORY_BUILDS = ((64, 1), (128, 1), (128, 2), (256, 1), (256, 4))
BLOCKS_PER_SM = 32         # decode splits: aim for this many blocks per SM

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher(entry: str):
    """``gear_decode_launch`` / ``gear_history_launch`` of the dense library,
    or ``gear_decode_paged_launch`` of the paged one (same bodies,
    ``csrc/gear_decode.cuh``)."""
    if entry == "history":
        fn = _build.load("gear_decode").gear_history_launch
        fn.argtypes = [_P] * 16 + [_I] * 2 + [_P] * 3 + [_I] * 11 + [ctypes.c_float, _P]
    else:
        lib = _build.load("gear_decode_paged" if entry == "paged" else "gear_decode")
        fn = lib.gear_decode_paged_launch if entry == "paged" else lib.gear_decode_launch
        fn.argtypes = [_P] * 24 + [_I] * 12 + [ctypes.c_float, _P]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


_tickets: dict = {}


def _ticket_buffer(rows: int, device: torch.device) -> torch.Tensor:
    """Zeroed int32 counters, one per row, that the kernel's merging block
    returns to zero: allocated once per device (and when more rows come)."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < rows:
        buf = torch.zeros(max(rows, 1024), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


@functools.lru_cache(maxsize=64)
def device_extents(extents: tuple, device: torch.device) -> torch.Tensor:
    """The in-flight blocks' extents as an int32 tensor on ``device``, copied
    once per distinct tuple (not once per layer) from pinned memory without
    a host sync."""
    host = torch.tensor(extents, dtype=torch.int32).pin_memory()
    return host.to(device, non_blocking=True)


def _splits(BH: int, C: int, device: torch.device) -> int:
    """Chunks per block of the decode regime: enough blocks for
    ``BLOCKS_PER_SM`` per SM, at least one chunk each."""
    n_splits = min(C, max(1, -(-BLOCKS_PER_SM * _sm_count(device) // BH)))
    return -(-C // n_splits)


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
                      lr, sp, *, bits, rows, tok_rows, chk_rows, tensor_cores=None):
    """Validate the operands of either layout: ``rows`` operand rows (BH
    dense, P*H paged) of ``tok_rows`` tokens and ``chk_rows`` chunk rows
    each, and ``q [BH, G, Dh]`` (``G`` the query rows per row; more than
    ``DECODE_ROWS``, or ``tensor_cores``, take the history regime).  Returns
    (n_comp as an int32 [BH] tensor (None stays None), r, ks, kv, gv)."""
    dev = q.device
    BH, G, Dh = q.shape
    per = 32 // bits
    if bits not in (2, 4, 8) or Dh not in HEAD_DIMS:
        raise ValueError(f"{who}: bits={bits}, Dh={Dh} not built (bits 2/4/8, Dh {HEAD_DIMS})")
    L, gv = Dh // per, v_scale.shape[-1]
    if Dh % gv or (Dh // gv) % per:
        raise ValueError(f"{who}: {gv} V stat groups do not split Dh={Dh} into whole words")
    bf16, i32 = torch.bfloat16, torch.int32
    _expect(q, "q", torch.float32, (BH, G, Dh), dev, who)
    for name, x in (("k_packed", k_packed), ("v_packed", v_packed)):
        _expect(x, name, i32, (rows, tok_rows, L), dev, who)
    for name, x in (("k_scale", k_scale), ("k_zero", k_zero)):
        _expect(x, name, bf16, (rows, chk_rows, Dh), dev, who)
    for name, x in (("v_scale", v_scale), ("v_zero", v_zero)):
        _expect(x, name, bf16, (rows, tok_rows, gv), dev, who)
    if n_comp is not None:
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
    # the kernel stages each chunk's fields with 4- or 16-byte copies
    for x in (k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, *lr, *sp):
        if x is not None and x.data_ptr() % 4:
            raise ValueError(f"{who}: operands must be 4-byte aligned")
    if tensor_cores is None:
        tensor_cores = G > DECODE_ROWS
    if tensor_cores:
        nb = tok_rows // chk_rows
        if nb != 64 or r + 1 > 8 or r + gv > 8 or (Dh, gv) not in HISTORY_BUILDS:
            raise ValueError(f"{who}: {G} query rows take the history regime, built for "
                             f"64-token chunks, rank + V stat groups <= 8 and (Dh, groups) "
                             f"in {HISTORY_BUILDS} (got chunk {nb}, rank {r}, {gv} groups "
                             f"at Dh={Dh})")
    return n_comp, r, ks, kv, gv


def _ptr(x):
    return None if x is None else x.data_ptr()


def _decode_launch(who, q, arrays, n_comp, bt, lr, sp, *, H, C, chunk, bits, r, ks, kv, gv,
                   scale_factor, tensor_cores=False):
    """One ``gear_decode_launch`` (or, for ``tensor_cores`` on the dense
    layout, one ``gear_history_launch`` with one extent per row, what the
    C entry does for more than ``DECODE_ROWS`` rows): (acc [BH, G, Dh],
    m [BH, G], l [BH, G])."""
    BH, G, Dh = q.shape
    dev = q.device
    f32 = torch.float32
    if chunk % 2 or C < 1:
        raise ValueError(f"{who}: chunk {chunk} must be even and the cache hold a chunk")
    acc = torch.empty((BH, G, Dh), dtype=f32, device=dev)
    m = torch.empty((BH, G), dtype=f32, device=dev)
    l = torch.empty((BH, G), dtype=f32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if tensor_cores and bt is None:
        code = _launcher("history")(
            _ptr(q), *map(_ptr, arrays), *map(_ptr, lr), *map(_ptr, sp), _ptr(n_comp), 1, 0,
            _ptr(acc), _ptr(m), _ptr(l), BH, 1, G, C, chunk, Dh, bits, gv, r, ks, kv,
            float(scale_factor), stream)
        _build.check(code, who)
        return acc, m, l
    cps = _splits(BH, C, dev)
    n_splits = -(-C // cps)
    parts = [None, None, None]
    if G <= DECODE_ROWS and n_splits > 1:
        parts = [torch.empty((BH, n_splits, G, Dh), dtype=f32, device=dev),
                 torch.empty((BH, n_splits, G), dtype=f32, device=dev),
                 torch.empty((BH, n_splits, G), dtype=f32, device=dev)]
    tickets = _ticket_buffer(BH, dev)
    code = _launcher("dense" if bt is None else "paged")(
        _ptr(q), *map(_ptr, arrays), *map(_ptr, lr), *map(_ptr, sp), _ptr(n_comp), _ptr(bt),
        *map(_ptr, parts), _ptr(tickets), _ptr(acc), _ptr(m), _ptr(l),
        BH, H, G, C, chunk, Dh, bits, gv, r, ks, kv, cps, float(scale_factor), stream)
    _build.check(code, who)
    return acc, m, l


def gear_decode(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, n_comp,
                k_a=None, k_b=None, v_a=None, v_b=None,
                k_sp_val=None, k_sp_idx=None, v_sp_val=None, v_sp_idx=None,
                *, bits: int, chunk: int, scale_factor: float, tensor_cores: bool = False):
    """Unnormalized decode attention over the compressed history.

    Returns (acc [BH, G, Dh] f32, m [BH, G] f32, l [BH, G] f32); see
    :func:`repro_torch.kernels.ref.gear_decode_ref` for the contract.
    ``tensor_cores=True`` sends up to ``DECODE_ROWS`` query rows through
    the history body too (the same function; it times that body on decode
    operands), where they would take the decode body.
    """
    kw = dict(bits=bits, chunk=chunk, scale_factor=scale_factor, k_a=k_a, k_b=k_b,
              v_a=v_a, v_b=v_b, k_sp_val=k_sp_val, k_sp_idx=k_sp_idx,
              v_sp_val=v_sp_val, v_sp_idx=v_sp_idx)
    if _build.runs_plain(q):
        return gear_decode_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
                               n_comp, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"gear_decode: no kernel for device {q.device}")
    _build.refuse_grad("gear_decode", (q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
                                       k_a, k_b, v_a, v_b, k_sp_val, v_sp_val))
    BH = q.shape[0]
    S = k_packed.shape[1]
    if S % chunk:
        raise ValueError(f"gear_decode: S={S} is not a multiple of chunk={chunk}")
    C = S // chunk
    arrays = (k_packed, k_scale, k_zero, v_packed, v_scale, v_zero)
    lr, sp = [k_a, k_b, v_a, v_b], [k_sp_val, k_sp_idx, v_sp_val, v_sp_idx]
    tensor_cores = tensor_cores or q.shape[1] > DECODE_ROWS
    n_comp, r, ks, kv, gv = _checked_operands(
        "gear_decode", q, *arrays, n_comp, lr, sp, bits=bits, rows=BH, tok_rows=S, chk_rows=C,
        tensor_cores=tensor_cores)
    out = _decode_launch("gear_decode", q, arrays, n_comp, None, lr, sp, H=1, C=C, chunk=chunk,
                         bits=bits, r=r, ks=ks, kv=kv, gv=gv, scale_factor=scale_factor,
                         tensor_cores=tensor_cores)
    gear_decode.launches += 1
    return out


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
    if _build.runs_plain(q):
        return gear_decode_paged_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
                                     n_comp, block_tables, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"gear_decode_paged: no kernel for device {q.device}")
    _build.refuse_grad("gear_decode_paged", (q, k_packed, k_scale, k_zero, v_packed, v_scale,
                                             v_zero, k_a, k_b, v_a, v_b, k_sp_val, v_sp_val))
    BH = q.shape[0]
    B, C = block_tables.shape
    if BH % B:
        raise ValueError(f"gear_decode_paged: {BH} rows for {B} block-table rows")
    H = BH // B
    PH = k_packed.shape[0]
    if PH % H:
        raise ValueError(f"gear_decode_paged: pool rows {PH} not a multiple of H={H}")
    _expect(block_tables, "block_tables", torch.int32, (B, C), q.device, "gear_decode_paged")
    arrays = (k_packed, k_scale, k_zero, v_packed, v_scale, v_zero)
    lr, sp = [k_a, k_b, v_a, v_b], [k_sp_val, k_sp_idx, v_sp_val, v_sp_idx]
    n_comp, r, ks, kv, gv = _checked_operands(
        "gear_decode_paged", q, *arrays, n_comp, lr, sp, bits=bits, rows=PH, tok_rows=chunk,
        chk_rows=1)
    out = _decode_launch("gear_decode_paged", q, arrays, n_comp, block_tables, lr, sp, H=H, C=C,
                         chunk=chunk, bits=bits, r=r, ks=ks, kv=kv, gv=gv,
                         scale_factor=scale_factor)
    gear_decode_paged.launches += 1
    return out


gear_decode_paged.launches = 0


def gear_decode_history(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero, extents,
                        k_a=None, k_b=None, v_a=None, v_b=None,
                        k_sp_val=None, k_sp_idx=None, v_sp_val=None, v_sp_idx=None,
                        *, bits: int, chunk: int, scale_factor: float):
    """The streaming prefill's history scorer: :func:`gear_decode` of every
    in-flight block of a layer in one launch.

    q [BH, NB, R, Dh] f32 (block ``i``'s R query rows of each row);
    ``extents`` the NB blocks' compressed extents, ints known on the host:
    block ``i`` sees the first ``extents[i]`` tokens of the dense cache (they
    reach the device once per distinct tuple).  Returns (acc [BH, NB, R, Dh],
    m [BH, NB, R], l [BH, NB, R]) in f32; counts one ``gear_decode`` launch.
    """
    kw = dict(bits=bits, chunk=chunk, scale_factor=scale_factor, k_a=k_a, k_b=k_b,
              v_a=v_a, v_b=v_b, k_sp_val=k_sp_val, k_sp_idx=k_sp_idx,
              v_sp_val=v_sp_val, v_sp_idx=v_sp_idx)
    if _build.runs_plain(q):
        return gear_decode_history_ref(q, k_packed, k_scale, k_zero, v_packed, v_scale, v_zero,
                                       extents, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"gear_decode_history: no kernel for device {q.device}")
    _build.refuse_grad("gear_decode_history", (q, k_packed, k_scale, k_zero, v_packed, v_scale,
                                               v_zero, k_a, k_b, v_a, v_b, k_sp_val, v_sp_val))
    BH, NB, R, Dh = q.shape
    S = k_packed.shape[1]
    if S % chunk:
        raise ValueError(f"gear_decode_history: S={S} is not a multiple of chunk={chunk}")
    C = S // chunk
    if len(extents) != NB:
        raise ValueError(f"gear_decode_history: {len(extents)} extents for {NB} blocks")
    ext = device_extents(tuple(int(e) for e in extents), q.device)
    arrays = (k_packed, k_scale, k_zero, v_packed, v_scale, v_zero)
    lr, sp = [k_a, k_b, v_a, v_b], [k_sp_val, k_sp_idx, v_sp_val, v_sp_idx]
    _, r, ks, kv, gv = _checked_operands(
        "gear_decode_history", q.reshape(BH, NB * R, Dh), *arrays, None, lr, sp, bits=bits,
        rows=BH, tok_rows=S, chk_rows=C, tensor_cores=True)
    f32 = torch.float32
    acc = torch.empty((BH, NB, R, Dh), dtype=f32, device=q.device)
    m = torch.empty((BH, NB, R), dtype=f32, device=q.device)
    l = torch.empty((BH, NB, R), dtype=f32, device=q.device)
    code = _launcher("history")(
        _ptr(q), *map(_ptr, arrays), *map(_ptr, lr), *map(_ptr, sp), _ptr(ext), 0, 1,
        _ptr(acc), _ptr(m), _ptr(l), BH, NB, R, C, chunk, Dh, bits, gv, r, ks, kv,
        float(scale_factor), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "gear_decode_history")
    gear_decode.launches += 1
    return acc, m, l
