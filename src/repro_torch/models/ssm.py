"""Selective SSM branch (Hymba's Mamba heads) in Mamba-2/SSD head form (port
of ``repro.models.ssm``).

Per head, a scalar data-dependent decay ``a_t = exp(−Δ_t·exp(A_h))`` and
per-head B/C of width ``ssm_state``: exactly what the chunked engine
(:mod:`repro_torch.models.linear_scan`) computes.  Hymba runs these heads
beside attention inside each block (:mod:`repro_torch.models.transformer`).

Precision follows the reference: the projections in bf16, the conv and the
gate in the activation dtype, the B/C/Δ split and the scan in f32, the skip
term added in f32, the decode conv as an f32 product over the rolling
window.  The weights are read from a :class:`~repro_torch.models.transformer.Block`
(``w_in``, ``conv_w``, ``w_bcdt``, ``w_out``, ``a_log``, ``dt_bias``,
``d_skip``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import linear_scan
from repro_torch.models.common import silu

__all__ = ["SSMState", "ssm_apply", "ssm_decode", "init_ssm_state"]


@dataclasses.dataclass
class SSMState:
    conv: torch.Tensor    # [B, conv_w - 1, d_inner] rolling conv inputs
    state: torch.Tensor   # [B, H, ssm_state, head_dim] f32

    def tensors(self) -> dict:
        """Leaves by field name (the cache protocol of ``core.cache``)."""
        return {"conv": self.conv, "state": self.state}


def _dims(cfg: ModelConfig):
    H, dh = cfg.num_heads, cfg.head_dim
    return H, dh, H * dh, cfg.ssm_state


def _conv_train(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Causal depthwise conv along S.  x [B, S, dinner]; w [cw, dinner]."""
    cw, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    out = xp[:, 0:S, :] * w[0]
    for i in range(1, cw):
        out = out + xp[:, i:i + S, :] * w[i]
    return out


def _bcdt(cfg: ModelConfig, layer, xc: torch.Tensor):
    """xc [..., dinner] -> (B̃ [..., H, ds], C̃ [..., H, ds], Δ [..., H],
    log_w [..., H]), f32 from the bf16 projection."""
    H, dh, dinner, ds = _dims(cfg)
    proj = xc @ layer.w_bcdt.to(xc.dtype)
    proj = proj.reshape(xc.shape[:-1] + (H, 2 * ds + 1)).to(torch.float32)
    b, c, dt_raw = proj[..., :ds], proj[..., ds:2 * ds], proj[..., -1]
    dt = F.softplus(dt_raw + layer.dt_bias)
    log_w = -dt * torch.exp(layer.a_log)
    return b, c, dt, log_w


def ssm_apply(cfg: ModelConfig, layer, x: torch.Tensor, chunk: int = 64):
    """Prefill path.  x [B, S, d] -> (y [B, S, d], final :class:`SSMState`).

    A prompt whose length is not a multiple of ``chunk`` is scanned as ONE
    chunk of S tokens, as the reference does (``eff_chunk``); the factored
    form's clamps then cut the decay past e^-30 (ROADMAP §3)."""
    H, dh, dinner, ds = _dims(cfg)
    B, S, _ = x.shape
    xi, z = (x @ layer.w_in.to(x.dtype)).chunk(2, dim=-1)
    xc = silu(_conv_train(xi, layer.conv_w.to(x.dtype)))
    b, c, dt, log_w = _bcdt(cfg, layer, xc)

    v = xc.reshape(B, S, H, dh).transpose(1, 2).to(torch.float32)      # [B, H, S, dh]
    r = c.transpose(1, 2)                                              # [B, H, S, ds]
    kk = (b * dt[..., None]).transpose(1, 2)                           # Δ folded into k
    lw = log_w.transpose(1, 2)[..., None]                              # [B, H, S, 1]
    eff_chunk = min(chunk, S) if S % min(chunk, S) == 0 else S
    y, state = linear_scan.chunked_scan(r, kk, v, lw, chunk=eff_chunk, mode="inclusive")
    y = y + layer.d_skip[None, :, None, None] * v
    y = y.transpose(1, 2).reshape(B, S, dinner).to(x.dtype)
    y = y * silu(z)
    out = y @ layer.w_out.to(x.dtype)
    tail = xi[:, max(0, S - (cfg.ssm_conv - 1)):, :]
    if tail.shape[1] < cfg.ssm_conv - 1:
        tail = F.pad(tail, (0, 0, cfg.ssm_conv - 1 - tail.shape[1], 0))
    return out, SSMState(conv=tail, state=state)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16, device=None) -> SSMState:
    H, dh, dinner, ds = _dims(cfg)
    return SSMState(
        conv=torch.zeros((batch, cfg.ssm_conv - 1, dinner), dtype=dtype, device=device),
        state=torch.zeros((batch, H, ds, dh), dtype=torch.float32, device=device))


def ssm_decode(cfg: ModelConfig, layer, x_t: torch.Tensor, st: SSMState):
    """One-token step.  x_t [B, 1, d] -> (y [B, 1, d], new :class:`SSMState`);
    ``st`` is left as it was."""
    H, dh, dinner, ds = _dims(cfg)
    B = x_t.shape[0]
    xi, z = (x_t[:, 0] @ layer.w_in.to(x_t.dtype)).chunk(2, dim=-1)                 # [B, dinner]
    window = torch.cat([st.conv, xi[:, None, :]], dim=1)                # [B, cw, dinner]
    xc = silu(torch.einsum("bcd,cd->bd", window.to(torch.float32),
                            layer.conv_w.to(torch.float32))).to(x_t.dtype)
    b, c, dt, log_w = _bcdt(cfg, layer, xc)
    v = xc.reshape(B, H, dh).to(torch.float32)
    y, state = linear_scan.decode_step(c, b * dt[..., None], v, log_w[..., None], st.state,
                                       mode="inclusive")
    y = y + layer.d_skip[None, :, None] * v
    y = (y.reshape(B, dinner) * silu(z.to(torch.float32))).to(x_t.dtype)
    out = (y @ layer.w_out.to(x_t.dtype))[:, None, :]
    return out, SSMState(conv=window[:, 1:, :], state=state)
