"""RWKV6 "Finch" block: data-dependent-decay linear recurrence, attention-free
(port of ``repro.models.rwkv``).

Data-dependent token shift (ddlerp with a 5-way LoRA), data-dependent decay
``w_t = exp(-exp(w0 + LoRA(x)))``, bonus ``u`` for the current token,
per-head GroupNorm on the recurrence output, silu-gated output projection,
and squared-ReLU channel mix.  The recurrence runs through the chunked
engine (:func:`repro_torch.models.linear_scan.chunked_scan`, i.e. the
``linear_scan_chunked`` kernel on a card) in "bonus" mode:

    y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ),   S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

and a decode step is the same code at S = 1 from the slot's state.  There is
no KV cache, so GEAR compresses nothing here, as in the reference.

Precision follows the reference step by step: activations and the cast
weight matrices in bf16, ``dec = w0 (f32) + LoRA (bf16)`` promoted to f32
before ``log w = -exp(dec)``, ``u`` and the recurrent state in f32, the
GroupNorm in f32.  :class:`TimeMix` / :class:`ChannelMix` hold the weights
(matrices in bf16, what the reference casts them to at use; the mixes,
``w0``, ``u`` and the GroupNorm's scale and bias in f32).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import linear_scan
from repro_torch.models.common import silu

__all__ = ["RWKVState", "TimeMix", "ChannelMix", "time_mix_apply", "channel_mix_apply",
           "time_mix_decode", "channel_mix_decode", "init_rwkv_state"]

LORA_MIX = 32
LORA_DECAY = 64


@dataclasses.dataclass
class RWKVState:
    shift_tm: torch.Tensor   # [B, d] previous token input (time mix)
    shift_cm: torch.Tensor   # [B, d] previous token input (channel mix)
    wkv: torch.Tensor        # [B, H, Dk, Dv] f32 recurrence state

    def tensors(self) -> dict:
        """Leaves by field name (the cache protocol of ``core.cache``)."""
        return {"shift_tm": self.shift_tm, "shift_cm": self.shift_cm, "wkv": self.wkv}


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class TimeMix(nn.Module):
    """Time-mix weights of one layer, at the reference's constant init where
    it has one (``mix_base`` 0.5, ``w0`` -2, ``u`` 0, GroupNorm scale 1 and
    bias 0); matrices are zero until loaded or drawn."""

    FIXED = ("mix_base", "u")      # 2-D, yet constants of the init, not draws

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, H, dh = cfg.d_model, cfg.num_heads, cfg.head_dim
        f32 = torch.float32

        def mat(*shape):
            return _param(torch.zeros(shape, dtype=dtype, device=device))

        def vec(shape, fill):
            return _param(torch.full(shape, fill, dtype=f32, device=device))

        self.mix_base = vec((5, d), 0.5)               # r, k, v, w, g static mixes
        self.mix_lora_a = mat(d, 5 * LORA_MIX)
        self.mix_lora_b = mat(5, LORA_MIX, d)
        self.w0 = vec((d,), -2.0)                      # decay base
        self.decay_lora_a = mat(d, LORA_DECAY)
        self.decay_lora_b = mat(LORA_DECAY, d)
        self.u = vec((H, dh), 0.0)                     # bonus
        self.wr, self.wk, self.wv, self.wg, self.wo = (mat(d, d) for _ in range(5))
        self.ln_scale = vec((d,), 1.0)                 # per-head GroupNorm
        self.ln_bias = vec((d,), 0.0)


class ChannelMix(nn.Module):
    """Channel-mix weights of one layer (``mix_k`` / ``mix_r`` at 0.5)."""

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.mix_k = _param(torch.full((d,), 0.5, dtype=torch.float32, device=device))
        self.mix_r = _param(torch.full((d,), 0.5, dtype=torch.float32, device=device))
        self.wk = _param(torch.zeros(d, ff, dtype=dtype, device=device))
        self.wv = _param(torch.zeros(ff, d, dtype=dtype, device=device))
        self.wr = _param(torch.zeros(d, d, dtype=dtype, device=device))


def _shifted(x: torch.Tensor, shift) -> torch.Tensor:
    """The previous token's input for every position: ``shift`` [B, d] (or
    zeros) before x[:, :-1]."""
    B, _, d = x.shape
    first = (shift[:, None, :] if shift is not None
             else torch.zeros((B, 1, d), dtype=x.dtype, device=x.device))
    return torch.cat([first, x[:, :-1, :]], dim=1)


def _ddlerp(tm: TimeMix, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """Data-dependent token shift -> the 5 mixed inputs [5, B, S, d]."""
    dx = x_prev - x
    base = tm.mix_base.to(x.dtype)
    xx = x + dx * base[0]                                   # coarse mix for the LoRA input
    lora = torch.tanh(xx @ tm.mix_lora_a)
    lora = lora.reshape(lora.shape[:-1] + (5, LORA_MIX))
    dyn = torch.einsum("bsfl,fld->fbsd", lora, tm.mix_lora_b)
    mixes = base[:, None, None, :] + dyn                    # [5, B, S, d]
    return x[None] + dx[None] * mixes


def _group_norm_heads(x: torch.Tensor, scale, bias, H: int, eps: float = 64e-5):
    """Per-head LayerNorm (RWKV's GroupNorm(H)) of x [B, S, d], in f32."""
    B, S, d = x.shape
    xh = x.reshape(B, S, H, d // H).to(torch.float32)
    mu = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, unbiased=False, keepdim=True)
    xn = (xh - mu) * torch.rsqrt(var + eps)
    return (xn.reshape(B, S, d) * scale + bias).to(x.dtype)


def time_mix_apply(cfg: ModelConfig, layer, x: torch.Tensor, state: RWKVState | None = None,
                   chunk: int = 64):
    """x [B, S, d] -> (y [B, S, d], (shift carry [B, d], wkv state [B, H, Dk,
    Dv] f32)); ``layer.tm`` holds the weights.  A prompt whose length is not
    a multiple of ``chunk`` is scanned as ONE chunk of S tokens, as the
    reference does (``eff_chunk``; ROADMAP §3)."""
    tm = layer.tm
    H, dh = cfg.num_heads, cfg.head_dim
    B, S, d = x.shape
    xr, xk, xv, xw, xg = _ddlerp(tm, x, _shifted(x, None if state is None else state.shift_tm))

    def heads(t):
        return t.reshape(B, S, H, dh).transpose(1, 2)

    r, k, v = heads(xr @ tm.wr), heads(xk @ tm.wk), heads(xv @ tm.wv)
    g = silu(xg @ tm.wg)
    dec = tm.w0 + torch.tanh(xw @ tm.decay_lora_a) @ tm.decay_lora_b    # f32 + bf16 -> f32
    log_w = heads(-torch.exp(dec.to(torch.float32)))                     # ≤ 0
    eff_chunk = chunk if S % chunk == 0 else S
    y, wkv = linear_scan.chunked_scan(r, k, v, log_w, chunk=eff_chunk, u=tm.u,
                                      state0=None if state is None else state.wkv,
                                      mode="bonus")
    y = y.transpose(1, 2).reshape(B, S, d)
    y = _group_norm_heads(y, tm.ln_scale, tm.ln_bias, H)
    return (y * g) @ tm.wo, (x[:, -1, :], wkv)


def channel_mix_apply(cfg: ModelConfig, layer, x: torch.Tensor,
                      state: RWKVState | None = None):
    """x [B, S, d] -> (y [B, S, d], shift carry [B, d]); ``layer.cm`` holds
    the weights."""
    cm = layer.cm
    dx = _shifted(x, None if state is None else state.shift_cm) - x
    xk = x + dx * cm.mix_k.to(x.dtype)
    xr = x + dx * cm.mix_r.to(x.dtype)
    kk = torch.square(torch.relu(xk @ cm.wk))
    return torch.sigmoid(xr @ cm.wr) * (kk @ cm.wv), x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                    device=None) -> RWKVState:
    H, dh = cfg.num_heads, cfg.head_dim
    return RWKVState(
        shift_tm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, cfg.d_model), dtype=dtype, device=device),
        wkv=torch.zeros((batch, H, dh, dh), dtype=torch.float32, device=device))


def time_mix_decode(cfg: ModelConfig, layer, x_t: torch.Tensor, state: RWKVState):
    """x_t [B, 1, d]: one token through the same code path (S = chunk = 1,
    from ``state``).  Returns (y, new state); ``state`` is left as it was."""
    out, (shift, wkv) = time_mix_apply(cfg, layer, x_t, state=state, chunk=1)
    return out, dataclasses.replace(state, shift_tm=shift, wkv=wkv)


def channel_mix_decode(cfg: ModelConfig, layer, x_t: torch.Tensor, state: RWKVState):
    out, shift = channel_mix_apply(cfg, layer, x_t, state=state)
    return out, dataclasses.replace(state, shift_cm=shift)
