"""Config registry: ``get_config("llama2-7b")`` and reduced smoke variants.

Every architecture of the reference is registered: the dense llama2-7b,
minicpm-2b, starcoder2-3b, gemma-2b and gemma3-12b (5:1 local:global
attention with QK-norm), the VLM paligemma-3b (a bidirectional image
prefix), the audio musicgen-medium (4 EnCodec codebooks), the MoE
qwen3-moe-235b-a22b (128 experts, top-8) and llama4-scout-17b-a16e (16
experts, top-1, a shared expert), the hybrid hymba-1.5b and the
attention-free rwkv6-3b.
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
    "musicgen-medium": "musicgen_medium",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(_MODULES)}")
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
    if cfg.moe:
        overrides.update(num_experts=4, moe_top_k=min(cfg.moe_top_k, 2), moe_d_ff=64)
    if cfg.modality == "vlm":
        overrides.update(num_prefix_tokens=8)
    if cfg.rwkv:
        overrides.update(num_heads=4, num_kv_heads=4)
    return dataclasses.replace(cfg, **overrides)


__all__ = ["ModelConfig", "get_config", "smoke_config"]
