"""Mixture-of-Experts with capacity-based index dispatch (port of
``repro.models.moe``): qwen3-moe (128 experts, top-8) and llama4-scout (16
experts, top-1, plus a shared expert).

The router's logits are computed in f32 from its f32 weights, gates are an
f32 softmax, each token keeps its top-k gates (ties to the lower expert id,
as ``jax.lax.top_k``), renormalised.  Each ``(token, k)`` pair takes the
next free slot of its expert in token-major order (a cumulative count over
the pairs); an expert holds ``capacity_for(cfg, T)`` slots, ``T = B * S``
being every row of the call (padded rows and idle decode slots included, as
in the reference), and pairs past it are dropped.  The kept rows are
gathered into ``[E, C, d]``, run through every expert as batched products
(``torch.bmm``), and gathered back weighted by their gates (cast to bf16).
So every expert's weights are read on every call, a decode step included.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import gelu_tanh
from repro_torch.models.mlp import GATED_KINDS, mlp_apply

__all__ = ["MoE", "Expert", "Routing", "capacity_for", "route", "moe_apply"]


def capacity_for(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for a call over ``tokens`` rows: ``tokens * k *
    capacity_factor / E``, rounded up to a multiple of 8, at least 8."""
    cap = int(tokens * cfg.moe_top_k * cfg.capacity_factor / cfg.num_experts)
    return max(8, (cap + 7) // 8 * 8)


def _param(x: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(x, requires_grad=False)


class Expert(nn.Module):
    """One MLP of width ``ff`` (llama4's shared expert): ``w_up`` [d, ff],
    ``w_down`` [ff, d] and, for the gated kinds, ``w_gate`` [d, ff]."""

    def __init__(self, cfg: ModelConfig, ff: int, device, dtype):
        super().__init__()
        d = cfg.d_model

        def mat(*shape):
            return _param(torch.zeros(shape, dtype=dtype, device=device))

        self.w_gate = mat(d, ff) if cfg.mlp_kind in GATED_KINDS else None
        self.w_up, self.w_down = mat(d, ff), mat(ff, d)


class MoE(nn.Module):
    """One MoE layer's weights: ``router`` [d, E] in f32 (the reference
    computes the router's logits in f32 from its f32 master, and a bf16
    router would move near-tie top-k choices), the experts' ``w_gate`` /
    ``w_up`` [E, d, ffe] and ``w_down`` [E, ffe, d] in ``dtype``, and the
    shared expert (``shared``, an :class:`Expert` of width ffe) or None."""

    # the reference's init draws w_up / w_gate with fan_in E (its dense_init
    # default, shape[0]) and w_down with fan_in ffe (shape[1])
    FAN_IN = {"w_down": 1}

    def __init__(self, cfg: ModelConfig, device, dtype):
        super().__init__()
        d, E, ffe = cfg.d_model, cfg.num_experts, cfg.expert_ff

        def mat(*shape):
            return _param(torch.zeros(shape, dtype=dtype, device=device))

        self.router = _param(torch.zeros(d, E, dtype=torch.float32, device=device))
        self.w_gate = mat(E, d, ffe) if cfg.mlp_kind in GATED_KINDS else None
        self.w_up, self.w_down = mat(E, d, ffe), mat(E, ffe, d)
        self.shared = Expert(cfg, ffe, device, dtype) if cfg.shared_expert else None


class Routing(NamedTuple):
    """One call's routing over its T rows: ``gates`` [T, E] f32 softmax,
    ``weights`` [T, k] f32 (renormalised top-k gates), ``experts`` [T, k]
    int64, ``pos`` [T * k] each pair's place in its expert's queue (token
    major), ``keep`` [T * k] (``pos < capacity``), ``slot`` [T * k] (``expert
    * capacity + pos``, ``E * capacity`` for a dropped pair) and
    ``capacity``."""
    gates: torch.Tensor
    weights: torch.Tensor
    experts: torch.Tensor
    pos: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    capacity: int


def route(cfg: ModelConfig, router: torch.Tensor, xt: torch.Tensor) -> Routing:
    """The reference's routing of ``xt`` [T, d]."""
    T = xt.shape[0]
    E, k = cfg.num_experts, cfg.moe_top_k
    gates = torch.softmax(xt.to(torch.float32) @ router.to(torch.float32), dim=-1)
    # the k largest, ties to the lower expert id (jax.lax.top_k's order;
    # torch.topk promises none): a stable descending sort
    w, experts = torch.sort(gates, dim=-1, descending=True, stable=True)
    w, experts = w[:, :k], experts[:, :k]
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    flat = experts.reshape(T * k)
    counts = torch.cumsum(F.one_hot(flat, E), dim=0) - 1          # [T * k, E]
    pos = counts.gather(1, flat[:, None])[:, 0]
    C = capacity_for(cfg, T)
    keep = pos < C
    slot = torch.where(keep, flat * C + pos, torch.full_like(pos, E * C))
    return Routing(gates, w, experts, pos, keep, slot, C)


def _experts(cfg: ModelConfig, layer: MoE, xe: torch.Tensor) -> torch.Tensor:
    """xe [E, C, d] -> [E, C, d] through each expert's MLP, batched."""
    up = torch.bmm(xe, layer.w_up.to(xe.dtype))
    if cfg.mlp_kind == "swiglu":
        h = F.silu(torch.bmm(xe, layer.w_gate.to(xe.dtype))) * up
    elif cfg.mlp_kind == "geglu":
        h = gelu_tanh(torch.bmm(xe, layer.w_gate.to(xe.dtype))) * up
    else:
        h = gelu_tanh(up)
    return torch.bmm(h, layer.w_down.to(xe.dtype))


def moe_apply(cfg: ModelConfig, layer: MoE, x: torch.Tensor):
    """x [B, S, d] -> (y [B, S, d], the Switch load-balance aux loss, an f32
    scalar).  Serving drops the aux loss (training, ROADMAP queue 1, item 10,
    will read it)."""
    B, S, d = x.shape
    T = B * S
    E, k = cfg.num_experts, cfg.moe_top_k
    xt = x.reshape(T, d)
    r = route(cfg, layer.router, xt)
    C = r.capacity
    # the token in each slot (the sentinel row E * C takes the dropped pairs)
    pair_tok = torch.arange(T * k, device=x.device) // k
    tok_of_slot = torch.zeros(E * C + 1, dtype=torch.int64, device=x.device).scatter_(
        0, r.slot, pair_tok)
    used = torch.zeros(E * C + 1, dtype=torch.bool, device=x.device).scatter_(0, r.slot, r.keep)
    xe = (xt[tok_of_slot[:E * C]] * used[:E * C, None].to(x.dtype)).reshape(E, C, d)
    ye = _experts(cfg, layer, xe).reshape(E * C, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])                     # dropped pairs read 0
    y = (ye[r.slot].reshape(T, k, d) * r.weights[..., None].to(x.dtype)).sum(dim=1)
    if layer.shared is not None:
        y = y + mlp_apply(layer.shared, xt, cfg.mlp_kind)
    me = r.gates.mean(dim=0)                                     # mean router probability
    ce = F.one_hot(r.experts[:, 0], E).to(torch.float32).mean(dim=0)   # top-1 dispatch share
    aux = cfg.router_aux_weight * E * torch.sum(me * ce)
    return y.reshape(B, S, d), aux
