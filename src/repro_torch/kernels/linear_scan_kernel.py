"""Chunked linear-recurrence scan (Mamba-2 SSD / RWKV6): wrapper of
``csrc/linear_scan.cu``.

Port of ``repro.kernels.linear_scan_kernel.linear_scan_chunked`` (contract
of ``ref.linear_scan_ref``, i.e. the reference's ``chunked_scan`` with the
leading dims flattened).  A CPU tensor takes the plain version; a CUDA
tensor launches the kernel or raises.  Any chunk that divides S is legal,
chunk = S included.  The scan starts from a zero state or from ``state0``
(RWKV6's decode step), as the reference's ``chunked_scan`` does; its TPU
kernel starts from zero only.

Two regimes, chosen by the chunk: chunk = 1 (RWKV6's decode step) is one
``scan_step`` launch that streams the state once; a longer chunk is three
CUDA launches into a workspace this wrapper allocates (``scan_factors``:
the cumsum, the decay factors and each 128-row tile's state increment;
``scan_states``: the increments summed in tile order, chunk by chunk, into
the chunk-start states and the final state; ``scan_tiles``: y per 64-row
query tile, its products on the tensor cores in 3xTF32).  One wrapper call
counts one on ``.launches`` whatever the regime.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import linear_scan_ref

__all__ = ["linear_scan_chunked", "MAX_DK"]

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


def linear_scan_chunked(r, k, v, log_w, u=None, *, chunk: int = 64, mode: str = "inclusive",
                        state0=None):
    """r, k [BH, S, Dk]; v [BH, S, Dv]; log_w [BH, S, Dk] or [BH, S, 1] (one
    decay per row, broadcast over Dk); u [BH, Dk] for ``mode="bonus"``;
    state0 [BH, Dk, Dv] f32 or None (a zero state).  Returns (y [BH, S, Dv]
    in v's dtype, state [BH, Dk, Dv] f32)."""
    if mode not in ("inclusive", "bonus"):
        raise ValueError(f"linear_scan_chunked: mode must be inclusive/bonus, got {mode!r}")
    BH, S, Dk = r.shape
    if chunk < 1 or S % chunk:
        raise ValueError(f"linear_scan_chunked: chunk={chunk} does not divide S={S}")
    if mode == "bonus" and u is None:
        raise ValueError("linear_scan_chunked: mode='bonus' needs u")
    if r.device.type == "cpu":
        return linear_scan_ref(r, k, v, log_w, u, chunk=chunk, mode=mode, state0=state0)
    if r.device.type != "cuda":
        raise ValueError(f"linear_scan_chunked: no kernel for device {r.device}")
    Dv = v.shape[-1]
    lw_cols = log_w.shape[-1]
    wants = {"r": (r, (BH, S, Dk)), "k": (k, (BH, S, Dk)), "v": (v, (BH, S, Dv)),
             "log_w": (log_w, (BH, S, lw_cols))}
    if mode == "bonus":
        wants["u"] = (u, (BH, Dk))
    if state0 is not None:
        wants["state0"] = (state0, (BH, Dk, Dv))
    for name, (x, shape) in wants.items():
        if x.device != r.device or x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"linear_scan_chunked: {name} must be a contiguous f32 tensor on "
                             f"{r.device} (got {x.dtype} on {x.device})")
        if tuple(x.shape) != shape:
            raise ValueError(f"linear_scan_chunked: {name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
    if lw_cols not in (1, Dk):
        raise ValueError(f"linear_scan_chunked: log_w's last dim {lw_cols} is neither 1 nor {Dk}")
    if not 1 <= Dk <= MAX_DK or Dv < 1:
        raise ValueError(f"linear_scan_chunked: Dk={Dk}, Dv={Dv} unsupported (Dk <= {MAX_DK})")
    launch, workspace_bytes = _launcher()
    y = torch.empty_like(v)
    state = torch.empty((BH, Dk, Dv), dtype=torch.float32, device=r.device)
    nbytes = workspace_bytes(BH, S, Dk, Dv, chunk)
    ws = torch.empty(nbytes, dtype=torch.uint8, device=r.device) if nbytes else None
    code = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), log_w.data_ptr(),
                  None if u is None else u.data_ptr(),
                  None if state0 is None else state0.data_ptr(),
                  y.data_ptr(), state.data_ptr(), None if ws is None else ws.data_ptr(),
                  BH, S, Dk, Dv, lw_cols, chunk, int(mode == "bonus"),
                  torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(code, "linear_scan_chunked")
    linear_scan_chunked.launches += 1
    return y, state


linear_scan_chunked.launches = 0
