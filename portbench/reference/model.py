"""Plain PyTorch reference of GEAR-compressed greedy generation.

A decoder-only transformer (RMSNorm or LayerNorm, rotary positions on the
halves of each head, grouped-query attention, a SwiGLU or tanh-GELU MLP,
the LM head tied to the embedding) run over a prompt and the tokens the
program served, teacher-forced, in float32 with TF32 off.  It gives the
logits the program's served tokens were chosen from: those of the prompt's
last position and of every decode step.

What the program's cache does to attention is worked out again here: the
prompt attends itself uncompressed (a monolithic prefill); every full
n_b-token chunk of the prompt is then compressed with the policy's prefill
rank, and every chunk that fills during decode is compressed, with the
decode rank, as soon as its last token is appended.  A decode query at
position p therefore sees the reconstruction (:func:`gear.reconstruct`) of
every chunk c with (c + 1) n_b <= p + 1, and the other keys up to p as they
are.  It reads the weights and tokens the benchmark made, and nothing the
program derived from them.

``precision="fp8"`` is the control: every matrix product with a weight
(projections, MLP, LM head) takes its operands rounded to float8 e4m3 with
one scale per tensor, the step below the bf16 the configurations serve in.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import gear

F32 = torch.float32
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    s = torch.clamp_min(x.abs().amax(), 1e-30) / FP8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


def _linear(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    w = w.to(F32)
    if precision == "fp8":
        return _fp8(x) @ _fp8(w)
    return x @ w


def _norm(x: torch.Tensor, scale: torch.Tensor, bias, model: dict) -> torch.Tensor:
    eps = model["norm_eps"]
    scale = scale.to(F32)
    if model["norm"] == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale)
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias.to(F32)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary positions 0.. on x [b, H, L, Dh], rotating the halves."""
    dh, length = x.shape[-1], x.shape[-2]
    freqs = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=F32, device=x.device) / dh))
    ang = torch.arange(length, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _closed_chunks(k: torch.Tensor, v: torch.Tensor, prompt: int, length: int,
                   policy: dict):
    """Reconstructed K and V [b, Hkv, C * n_b, Dh] of the C chunks that
    close before the last query: prompt chunks at the prefill rank, the
    others at the decode rank."""
    nb = policy["chunk"]
    n_closed = length // nb
    n_pre = min(prompt // nb, n_closed)
    out = []
    for x, kind in ((k, "k"), (v, "v")):
        b, h, _, dh = x.shape
        parts = []
        for c0, c1, rank in ((0, n_pre, policy["rank"]),
                             (n_pre, n_closed, policy["rank_decode"])):
            if c1 > c0:
                ch = x[:, :, c0 * nb:c1 * nb].reshape(b, h, c1 - c0, nb, dh)
                parts.append(gear.reconstruct(ch, kind, policy, rank).reshape(b, h, -1, dh))
        out.append(torch.cat(parts, dim=2) if parts else x[:, :, :0])
    return out


def _attention(q, k, v, prompt: int, policy: dict, q_block: int = 512) -> torch.Tensor:
    """q [b, Hq, L, Dh]; k, v [b, Hkv, L, Dh] -> [b, L, Hq * Dh]."""
    b, hq, length, dh = q.shape
    rep = hq // k.shape[1]
    scale = dh ** -0.5
    kr, vr = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
    pos = torch.arange(length, device=q.device)
    out = torch.empty_like(q)
    for i0 in range(0, prompt, q_block):                  # the prefill: uncompressed
        i1 = min(i0 + q_block, prompt)
        s = (q[:, :, i0:i1] @ kr[:, :, :i1].transpose(-1, -2)) * scale
        s = s.masked_fill(pos[i0:i1, None] < pos[None, :i1], float("-inf"))
        out[:, :, i0:i1] = torch.softmax(s, dim=-1) @ vr[:, :, :i1]
    if length > prompt:                                   # decode: closed chunks compressed
        k_hat, v_hat = _closed_chunks(k, v, prompt, length, policy)
        n_hat = k_hat.shape[2]
        kh, vh = k_hat.repeat_interleave(rep, 1), v_hat.repeat_interleave(rep, 1)
        qd = q[:, :, prompt:]
        p = pos[prompt:, None]
        nb = policy["chunk"]
        closed = (pos[None, :n_hat] // nb + 1) * nb <= p + 1          # [nd, n_hat]
        s = (qd @ kr.transpose(-1, -2)) * scale
        s_hat = (qd @ kh.transpose(-1, -2)) * scale
        s[..., :n_hat] = torch.where(closed, s_hat, s[..., :n_hat])
        s = s.masked_fill(p < pos[None, :], float("-inf"))
        w = torch.softmax(s, dim=-1)
        w_hat = torch.where(closed, w[..., :n_hat], torch.zeros_like(w[..., :n_hat]))
        w_raw = w.clone()
        w_raw[..., :n_hat] -= w_hat
        out[:, :, prompt:] = w_raw @ vr + w_hat @ vh
    return out.transpose(1, 2).reshape(b, length, hq * dh)


def logits(weights: dict, model: dict, policy: dict, tokens: torch.Tensor, prompt: int,
           precision: str = "f32") -> torch.Tensor:
    """Logits [b, L - prompt + 1, V] (float32) at positions prompt - 1 .. L - 1
    of ``tokens`` [b, L] (the prompt, then the served tokens but the last)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dh, hq, hkv = model["head_dim"], model["num_heads"], model["num_kv_heads"]
    b, length = tokens.shape
    x = weights["embed"][tokens.long()].to(F32)
    for i in range(model["num_layers"]):
        def w(name, i=i):
            t = weights[name]
            return None if t is None else t[i]

        h = _norm(x, w("ln1"), w("ln1_bias"), model)
        q = _linear(h, w("wq"), precision).reshape(b, length, hq, dh).transpose(1, 2)
        k = _linear(h, w("wk"), precision).reshape(b, length, hkv, dh).transpose(1, 2)
        v = _linear(h, w("wv"), precision).reshape(b, length, hkv, dh).transpose(1, 2)
        q, k = _rope(q, model["rope_theta"]), _rope(k, model["rope_theta"])
        x = x + _linear(_attention(q, k, v, prompt, policy), w("wo"), precision)
        h = _norm(x, w("ln2"), w("ln2_bias"), model)
        if model["mlp_kind"] == "swiglu":
            a = F.silu(_linear(h, w("w_gate"), precision)) * _linear(h, w("w_up"), precision)
        else:
            a = F.gelu(_linear(h, w("w_up"), precision), approximate="tanh")
        x = x + _linear(a, w("w_down"), precision)
    x = _norm(x[:, prompt - 1:], weights["final_norm"], weights["final_norm_bias"], model)
    return _linear(x, weights["embed"].transpose(0, 1), precision)
