"""Chunked linear-recurrence scan (Mamba-2 SSD / RWKV6): wrapper of
``csrc/linear_scan.cu``, forward and backward.

Port of ``repro.kernels.linear_scan_kernel.linear_scan_chunked`` (contract
of ``ref.linear_scan_ref``, i.e. the reference's ``chunked_scan`` with the
leading dims flattened).  A CPU or meta tensor takes the plain version
(``_build.runs_plain``); a CUDA tensor launches the kernel or raises.
Any chunk that divides S is legal, chunk = S included.  The scan starts
from a zero state or from ``state0`` (RWKV6's decode step), as the
reference's ``chunked_scan`` does; its TPU kernel starts from zero only.

Forward, two regimes chosen by the chunk: chunk = 1 (RWKV6's decode step)
is one ``scan_step`` launch that streams the state once; a longer chunk is
three CUDA launches into a workspace this wrapper allocates
(``scan_factors``: the cumsum, the decay factors and each 128-row tile's
state increment; ``scan_states``: the increments summed in tile order,
chunk by chunk, into the chunk-start states and the final state;
``scan_tiles``: y per 64-row query tile, its products on the tensor cores
in 3xTF32).  One wrapper call counts one on ``.launches`` whatever the
regime.

Backward (RWKV6 and hymba training; the reference differentiates its XLA
``chunked_scan`` with ``jax.value_and_grad``): when grad mode is on and an
operand requires grad, :func:`linear_scan_chunked` runs through an
``autograd.Function`` whose backward is :func:`linear_scan_chunked_bwd`,
the vector-Jacobian product of the chunked form (``ref.linear_scan_bwd_ref``
on CPU tensors).  On the card it recomputes the forward's factors and
chunk-start states (``scan_factors``, ``scan_states``, which also form
q_facᵀ g and run the reverse state pass) rather than saving them, then the
intra-chunk terms one 64-token tile pair a block (``bwd_pair``, its products
on the tensor cores in 3xTF32; the off-diagonal pairs in a launch of their
own when a chunk has more than one tile) and the decay gradient's reverse
cumsum (``bwd_decay``): four or five launches, one count on
``linear_scan_chunked_bwd.launches``.  No float atomics: two calls give the
same bits.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import _build
from repro_torch.kernels.ref import linear_scan_bwd_ref, linear_scan_ref

__all__ = ["linear_scan_chunked", "linear_scan_chunked_bwd", "MAX_DK"]

MAX_DK = 64          # state rows a block holds (csrc/linear_scan.cu)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.lru_cache(maxsize=None)
def _launcher():
    lib = _build.load("linear_scan")
    fn = lib.linear_scan_launch
    fn.argtypes = [_P] * 9 + [_I] * 7 + [_P]
    fn.restype = ctypes.c_int
    ws = lib.linear_scan_workspace_bytes
    ws.argtypes = [_I] * 5
    ws.restype = ctypes.c_longlong
    return fn, ws


@functools.lru_cache(maxsize=None)
def _bwd_launcher():
    lib = _build.load("linear_scan")
    fn = lib.linear_scan_bwd_launch
    fn.argtypes = [_P] * 15 + [_I] * 7 + [_P]
    fn.restype = ctypes.c_int
    ws = lib.linear_scan_bwd_workspace_bytes
    ws.argtypes = [_I] * 6
    ws.restype = ctypes.c_longlong
    return fn, ws


def _validate(who: str, r, k, v, log_w, u, chunk: int, mode: str):
    if mode not in ("inclusive", "bonus"):
        raise ValueError(f"{who}: mode must be inclusive/bonus, got {mode!r}")
    S = r.shape[1]
    if chunk < 1 or S % chunk:
        raise ValueError(f"{who}: chunk={chunk} does not divide S={S}")
    if mode == "bonus" and u is None:
        raise ValueError(f"{who}: mode='bonus' needs u")
    if not (_build.runs_plain(r) or r.device.type == "cuda"):
        raise ValueError(f"{who}: no kernel for device {r.device}")


def _check_operands(who: str, named: dict, r) -> None:
    """Each operand a contiguous f32 tensor on r's device of its shape."""
    for name, (x, shape) in named.items():
        if x.device != r.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"{who}: {name} must be a contiguous f32 tensor on {r.device} "
                             f"(got {x.dtype} on {x.device})")
        if tuple(x.shape) != shape:
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, expected {shape}")


def _check_scan(who: str, r, k, v, log_w, u, mode: str, state0) -> None:
    """The scan's operands as the kernel takes them, or ValueError."""
    BH, S, Dk = r.shape
    Dv = v.shape[-1]
    lw_cols = log_w.shape[-1]
    wants = {"r": (r, (BH, S, Dk)), "k": (k, (BH, S, Dk)), "v": (v, (BH, S, Dv)),
             "log_w": (log_w, (BH, S, lw_cols))}
    if mode == "bonus":
        wants["u"] = (u, (BH, Dk))
    if state0 is not None:
        wants["state0"] = (state0, (BH, Dk, Dv))
    _check_operands(who, wants, r)
    if lw_cols not in (1, Dk):
        raise ValueError(f"{who}: log_w's last dim {lw_cols} is neither 1 nor {Dk}")
    if not 1 <= Dk <= MAX_DK or Dv < 1:
        raise ValueError(f"{who}: Dk={Dk}, Dv={Dv} unsupported (Dk <= {MAX_DK})")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _forward(r, k, v, log_w, u, chunk: int, mode: str, state0):
    if _build.runs_plain(r):
        return linear_scan_ref(r, k, v, log_w, u, chunk=chunk, mode=mode, state0=state0)
    _check_scan("linear_scan_chunked", r, k, v, log_w, u, mode, state0)
    BH, S, Dk = r.shape
    Dv = v.shape[-1]
    launch, workspace_bytes = _launcher()
    y = torch.empty_like(v)
    state = torch.empty((BH, Dk, Dv), dtype=torch.float32, device=r.device)
    nbytes = workspace_bytes(BH, S, Dk, Dv, chunk)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=r.device) if nbytes else None
    code = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), _ptr(u),
                  _ptr(state0), y.data_ptr(), state.data_ptr(), _ptr(ws),
                  BH, S, Dk, Dv, log_w.shape[-1], chunk, int(mode == "bonus"),
                  torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(code, "linear_scan_chunked")
    linear_scan_chunked.launches += 1
    return y, state


class _Scan(torch.autograd.Function):
    """The scan with its hand-derived backward.  The inputs are saved and
    the backward recomputes the factors from them.  An unused y or final
    state reaches the backward as a zero gradient (autograd materialises
    it); a gradient is returned for each input that needs one, and None for
    ``u`` in ``inclusive`` mode and for an absent ``state0``."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, state0, chunk, mode):
        ctx.chunk, ctx.mode = chunk, mode
        ctx.save_for_backward(r, k, v, log_w, u, state0)
        return _forward(r, k, v, log_w, u, chunk, mode, state0)

    @staticmethod
    @once_differentiable
    def backward(ctx, dy, dstate):
        r, k, v, log_w, u, state0 = ctx.saved_tensors
        grads = linear_scan_chunked_bwd(r, k, v, log_w, u, chunk=ctx.chunk, mode=ctx.mode,
                                        state0=state0, dy=dy.contiguous(),
                                        dstate=dstate.contiguous())
        out = [None if g is None or not need else g.to(x.dtype) for g, need, x in
               zip(grads, ctx.needs_input_grad, (r, k, v, log_w, u, state0))]
        return (*out, None, None)


def linear_scan_chunked(r, k, v, log_w, u=None, *, chunk: int = 64, mode: str = "inclusive",
                        state0=None):
    """r, k [BH, S, Dk]; v [BH, S, Dv]; log_w [BH, S, Dk] or [BH, S, 1] (one
    decay per row, broadcast over Dk); u [BH, Dk] for ``mode="bonus"``;
    state0 [BH, Dk, Dv] f32 or None (a zero state).  Returns (y [BH, S, Dv]
    in v's dtype, state [BH, Dk, Dv] f32).  Differentiable in every tensor
    operand (see :func:`linear_scan_chunked_bwd`)."""
    _validate("linear_scan_chunked", r, k, v, log_w, u, chunk, mode)
    operands = (r, k, v, log_w, u, state0)
    if torch.is_grad_enabled() and any(isinstance(x, torch.Tensor) and x.requires_grad
                                       for x in operands):
        return _Scan.apply(*operands, chunk, mode)
    return _forward(r, k, v, log_w, u, chunk, mode, state0)


def linear_scan_chunked_bwd(r, k, v, log_w, u=None, *, chunk: int, mode: str = "inclusive",
                            state0=None, dy, dstate=None):
    """The vector-Jacobian product of :func:`linear_scan_chunked` at these
    inputs: ``dy`` [BH, S, Dv] the gradient of y, ``dstate`` [BH, Dk, Dv]
    that of the final state (None: zero).  Returns (dr, dk, dv, dlog_w
    shaped as log_w, du [BH, Dk] or None for ``inclusive``, dstate0 or None
    without ``state0``), f32; the contract of ``ref.linear_scan_bwd_ref``."""
    _validate("linear_scan_chunked_bwd", r, k, v, log_w, u, chunk, mode)
    if _build.runs_plain(r):
        return linear_scan_bwd_ref(r, k, v, log_w, u, chunk=chunk, mode=mode, state0=state0,
                                   dy=dy, dstate=dstate)
    who = "linear_scan_chunked_bwd"
    _check_scan(who, r, k, v, log_w, u, mode, state0)
    BH, S, Dk = r.shape
    Dv = v.shape[-1]
    grads = {"dy": (dy, (BH, S, Dv))}
    if dstate is not None:
        grads["dstate"] = (dstate, (BH, Dk, Dv))
    _check_operands(who, grads, r)
    launch, workspace_bytes = _bwd_launcher()
    dr, dk, dv, dlw = (torch.empty_like(x) for x in (r, k, v, log_w))
    du = torch.empty_like(u) if mode == "bonus" else None
    ds0 = None if state0 is None else torch.empty_like(state0)
    nbytes = workspace_bytes(BH, S, Dk, Dv, log_w.shape[-1], chunk)
    ws = torch.empty(max(nbytes, 16), dtype=torch.uint8, device=r.device)
    code = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(), _ptr(u),
                  _ptr(state0), dy.data_ptr(), _ptr(dstate), dr.data_ptr(), dk.data_ptr(),
                  dv.data_ptr(), dlw.data_ptr(), _ptr(du), _ptr(ds0), ws.data_ptr(),
                  BH, S, Dk, Dv, log_w.shape[-1], chunk, int(mode == "bonus"),
                  torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(code, who)
    linear_scan_chunked_bwd.launches += 1
    return dr, dk, dv, dlw, du, ds0


linear_scan_chunked.launches = 0
linear_scan_chunked_bwd.launches = 0
