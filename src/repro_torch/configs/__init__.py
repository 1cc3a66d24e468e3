"""Config registry: ``get_config("llama2-7b")`` and reduced smoke variants.

Only the architectures the port serves are registered: the dense
llama2-7b, minicpm-2b, starcoder2-3b, gemma-2b and gemma3-12b (5:1
local:global attention with QK-norm), the VLM paligemma-3b (a bidirectional
image prefix), the hybrid hymba-1.5b and the attention-free rwkv6-3b; the
reference's other families arrive with ROADMAP queue 1, item 8.6 onward.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama2-7b": "llama2_7b",
    "hymba-1.5b": "hymba_1p5b",
    "rwkv6-3b": "rwkv6_3b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-3b": "starcoder2_3b",
    "gemma-2b": "gemma_2b",
    "gemma3-12b": "gemma3_12b",
    "paligemma-3b": "paligemma_3b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {name!r}; options: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def smoke_config(name: str) -> ModelConfig:
    """Tiny same-family variant for CPU smoke tests (same overrides as the
    reference's ``repro.configs.smoke_config``)."""
    cfg = get_config(name)
    unit = len(cfg.layer_pattern)
    overrides = dict(
        num_layers=unit * 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        max_seq_len=512,
    )
    if cfg.modality == "vlm":
        overrides.update(num_prefix_tokens=8)
    return dataclasses.replace(cfg, **overrides)


__all__ = ["ModelConfig", "get_config", "smoke_config"]
