"""Load the reference's parameter tree into the port's modules.

``params_from_reference`` takes the JAX package's parameters as a tree of
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns a
:class:`~repro_torch.models.transformer.Transformer`.  The reference stacks
each pattern position's layers over repeats (``blocks[p][...][r]``); layer
``r * len(pattern) + p`` of the port is that slice.  Matrices become
``dtype`` (bf16: what the reference casts them to at use), norm scales f32.
A hybrid block's ``ssm`` subtree comes across the same way: its matrices in
bf16, ``conv_w`` and the per-head ``a_log`` / ``dt_bias`` / ``d_skip`` in
f32 (see :mod:`repro_torch.models.transformer`).  An RWKV6 block's ``tm`` /
``cm`` subtrees land in its :class:`~repro_torch.models.rwkv.TimeMix` /
:class:`~repro_torch.models.rwkv.ChannelMix` by name (matrices, the 3-D
``mix_lora_b`` included, in bf16; mixes, ``w0``, ``u`` and the GroupNorm in
f32), and its LayerNorms' ``scale`` and ``bias`` in f32.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import COMPUTE_DTYPE, Transformer

__all__ = ["params_from_reference"]

_ATTN = ("wq", "wk", "wv", "wo")
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
        put(blk.ln1, stacked["ln1"]["scale"][r])
        put(blk.ln2, stacked["ln2"]["scale"][r])
        for name in _ATTN:
            put(getattr(blk, name), stacked["attn"][name][r])
        for name in _MLP:
            put(getattr(blk, name), stacked["mlp"][name][r])
        if "ssm" in stacked:
            for name in _SSM:
                put(getattr(blk, name), stacked["ssm"][name][r])
    return model
