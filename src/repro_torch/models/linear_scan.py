"""Chunked linear-recurrence engine of the SSM heads (port of
``repro.models.linear_scan``).

For per-head state ``S ∈ R^{Dk×Dv}``:

    S_t = diag(w_t) · S_{t-1} + k_t v_tᵀ
    y_t = r_tᵀ · S_t                          (mode="inclusive", Mamba-style)
    y_t = r_tᵀ · (S_{t-1} + diag(u) k_t v_tᵀ) (mode="bonus", RWKV6 Finch)

:func:`chunked_scan` keeps the reference's ``[B, H, S, D]`` layout and
computes what it computes, clamps included (see ``ref.linear_scan_ref``):
on a CUDA tensor through the ``linear_scan_chunked`` kernel, on a CPU
tensor through its plain version.  :func:`decode_step` and
:func:`sequential_scan_ref` are plain PyTorch, as the reference has no
kernel for either.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.linear_scan_kernel import linear_scan_chunked

__all__ = ["chunked_scan", "decode_step", "sequential_scan_ref"]


def chunked_scan(r, k, v, log_w, chunk: int = 64, u=None, state0=None,
                 mode: str = "inclusive"):
    """r, k [B, H, S, Dk]; v [B, H, S, Dv]; log_w [B, H, S, Dk] (≤ 0) or
    broadcastable (hymba: [B, H, S, 1]); u [H, Dk] (``mode="bonus"``);
    state0 [B, H, Dk, Dv] or None (a zero state).  Returns (y [B, H, S, Dv]
    in v's dtype, final state [B, H, Dk, Dv] f32)."""
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    BH = B * H
    f32 = torch.float32
    lw = torch.broadcast_to(log_w, (B, H, S, log_w.shape[-1]))
    flat = [x.reshape(BH, S, x.shape[-1]).to(f32).contiguous() for x in (r, k, v, lw)]
    uf = (None if u is None
          else torch.broadcast_to(u.to(f32), (B, H, Dk)).reshape(BH, Dk).contiguous())
    s0 = None if state0 is None else state0.reshape(BH, Dk, Dv).to(f32).contiguous()
    y, state = linear_scan_chunked(*flat, uf, chunk=chunk, mode=mode, state0=s0)
    return y.reshape(B, H, S, Dv).to(v.dtype), state.reshape(B, H, Dk, Dv)


def decode_step(r_t, k_t, v_t, log_w_t, state, u=None, mode: str = "inclusive"):
    """Single-token recurrence (serving).  r_t, k_t [B, H, Dk]; v_t [B, H, Dv];
    state [B, H, Dk, Dv] f32.  Returns (y_t [B, H, Dv] in v_t's dtype, new
    state)."""
    f32 = torch.float32
    rf, kf, vf = r_t.to(f32), k_t.to(f32), v_t.to(f32)
    w = torch.exp(torch.broadcast_to(log_w_t.to(f32), kf.shape))
    kv = torch.einsum("bhk,bhv->bhkv", kf, vf)
    if mode == "bonus":
        read = state + u.to(f32)[None, :, :, None] * kv
        y = torch.einsum("bhk,bhkv->bhv", rf, read)
        state = state * w[..., None] + kv
    else:
        state = state * w[..., None] + kv
        y = torch.einsum("bhk,bhkv->bhv", rf, state)
    return y.to(v_t.dtype), state


def sequential_scan_ref(r, k, v, log_w, u=None, state0=None, mode: str = "inclusive"):
    """O(S) sequential oracle for tests: the exact recurrence, no clamp."""
    B, H, S, Dk = r.shape
    Dv = v.shape[-1]
    state = (torch.zeros((B, H, Dk, Dv), dtype=torch.float32, device=r.device)
             if state0 is None else state0.to(torch.float32))
    lw = torch.broadcast_to(log_w, (B, H, S, Dk))
    ys = []
    for t in range(S):
        y, state = decode_step(r[:, :, t], k[:, :, t], v[:, :, t], lw[:, :, t], state, u=u,
                               mode=mode)
        ys.append(y)
    return torch.stack(ys, dim=2).to(v.dtype), state
