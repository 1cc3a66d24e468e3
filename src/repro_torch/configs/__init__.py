"""Config registry: ``get_config("llama2-7b")`` and reduced smoke variants.

Only the architectures the port serves are registered (llama2-7b, the
hybrid hymba-1.5b and the attention-free rwkv6-3b); the reference's other
families arrive with ROADMAP queue item 10.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "llama2-7b": "llama2_7b",
    "hymba-1.5b": "hymba_1p5b",
    "rwkv6-3b": "rwkv6_3b",
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
    return dataclasses.replace(
        cfg,
        num_layers=unit * 2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        max_seq_len=512,
    )


__all__ = ["ModelConfig", "get_config", "smoke_config"]
