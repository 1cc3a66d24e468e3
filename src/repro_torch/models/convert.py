"""Load the reference's parameter tree into the port's modules.

``params_from_reference`` takes the JAX package's parameters as a tree of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
:class:`~repro_torch.models.transformer.Transformer`.  The reference stacks
each pattern position's layers over repeats (``blocks[p][...][r]``); layer
``r * len(pattern) + p`` of the port is that slice (gemma3's 5 local + 1
global unit: layers ``r * 6`` to ``r * 6 + 4`` are local, ``r * 6 + 5``
global).  Matrices become ``dtype`` (bf16: what the reference casts them to
at use), norm scales and (LayerNorm) biases f32, QK-norm's ``attn.q_norm`` /
``attn.k_norm`` scales too; a non-gated MLP (``gelu_mlp``) has no ``w_gate``.
A hybrid block's ``ssm`` subtree comes across the same way: its matrices in
bf16, ``conv_w`` and the per-head ``a_log`` / ``dt_bias`` / ``d_skip`` in
f32 (see :mod:`repro_torch.models.transformer`).  An RWKV6 block's ``tm`` /
``cm`` subtrees land in its :class:`~repro_torch.models.rwkv.TimeMix` /
:class:`~repro_torch.models.rwkv.ChannelMix` by name (matrices, the 3-D
``mix_lora_b`` included, in bf16; mixes, ``w0``, ``u`` and the GroupNorm in
f32), and its LayerNorms' ``scale`` and ``bias`` in f32.  An MoE block's
``moe`` subtree lands in its :class:`~repro_torch.models.moe.MoE`: ``router``
in f32, the experts' matrices and the shared expert's in bf16.  An audio
model's ``embed`` [K, V, d] stays f32 (its K lookups sum in f32) and its
``lm_head`` [d, K * V] becomes bf16.  ``dtype=torch.float32`` carries the
reference's f32 master weights across whole, for training.

``opt_state_from_reference`` maps an ``AdamWState``'s ``mu`` and ``nu``
trees (numpy, shaped as the parameters) to the port's
:class:`~repro_torch.optim.adamw.AdamWState`, keyed by the same parameter
names, so that both packages can start a step from one state.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import COMPUTE_DTYPE, Transformer
from repro_torch.optim.adamw import AdamWState

__all__ = ["params_from_reference", "opt_state_from_reference"]

_ATTN = ("wq", "wk", "wv", "wo", "q_norm", "k_norm")
_MLP = ("w_gate", "w_up", "w_down")
_SSM = ("w_in", "conv_w", "w_bcdt", "w_out", "a_log", "dt_bias", "d_skip")


def params_from_reference(np_tree: dict, cfg: ModelConfig, device=None,
                          dtype=COMPUTE_DTYPE) -> Transformer:
    model = Transformer(cfg, device, dtype)
    unit = len(cfg.layer_pattern)

    def put(p: torch.nn.Parameter, arr) -> None:
        arr = np.asarray(arr)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"shape {arr.shape} does not fit parameter {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr, np.float32)).to(p.dtype))

    put(model.embed, np_tree["embed"])
    if model.lm_head is not None:
        put(model.lm_head, np_tree["lm_head"])
    put(model.final_norm, np_tree["final_norm"]["scale"])
    if model.final_norm_bias is not None:
        put(model.final_norm_bias, np_tree["final_norm"]["bias"])
    for i, blk in enumerate(model.blocks):
        stacked = np_tree["blocks"][i % unit]
        r = i // unit
        if cfg.rwkv:
            for n in (1, 2):
                put(getattr(blk, f"ln{n}_scale"), stacked[f"ln{n}"]["scale"][r])
                put(getattr(blk, f"ln{n}_bias"), stacked[f"ln{n}"]["bias"][r])
            for sub in ("tm", "cm"):
                for name, p in getattr(blk, sub).named_parameters():
                    put(p, stacked[sub][name][r])
            continue
        for n in ("ln1", "ln2"):
            put(getattr(blk, n), stacked[n]["scale"][r])
            if getattr(blk, f"{n}_bias") is not None:
                put(getattr(blk, f"{n}_bias"), stacked[n]["bias"][r])
        for name in _ATTN:
            if getattr(blk, name) is not None:
                put(getattr(blk, name), stacked["attn"][name][r])
        for name in _MLP:
            if getattr(blk, name) is not None:
                put(getattr(blk, name), stacked["mlp"][name][r])
        if blk.moe is not None:
            for name, p in blk.moe.named_parameters():      # "router", ..., "shared.w_up"
                leaf = stacked["moe"]
                for part in name.split("."):
                    leaf = leaf[part]
                put(p, leaf[r])
        if "ssm" in stacked:
            for name in _SSM:
                put(getattr(blk, name), stacked["ssm"][name][r])
    return model


def opt_state_from_reference(mu_tree: dict, nu_tree: dict, count: int, cfg: ModelConfig,
                             device=None) -> AdamWState:
    """The reference's AdamW moments (numpy trees shaped as its parameters)
    as f32 tensors keyed by the port's parameter names."""
    def named(tree):
        model = params_from_reference(tree, cfg, device, torch.float32)
        return {n: p.detach() for n, p in model.named_parameters()}
    return AdamWState(mu=named(mu_tree), nu=named(nu_tree), count=int(count))
