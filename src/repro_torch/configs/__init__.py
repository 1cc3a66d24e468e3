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

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

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

# the reference's registry order (``repro.configs``): llama2-7b, the paper's
# model, last, and outside the assigned architectures
ALL_ARCHS = ("gemma3-12b", "minicpm-2b", "gemma-2b", "starcoder2-3b", "paligemma-3b",
             "qwen3-moe-235b-a22b", "llama4-scout-17b-a16e", "musicgen-medium", "hymba-1.5b",
             "rwkv6-3b", "llama2-7b")
ARCHS = tuple(k for k in ALL_ARCHS if k != "llama2-7b")

# archs for which long_500k runs (the sub-quadratic families)
LONG_CONTEXT_ARCHS = ("gemma3-12b", "hymba-1.5b", "rwkv6-3b")


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


def shapes_for(name: str) -> tuple[ShapeConfig, ...]:
    """The assigned input shapes that apply to this arch: training, prefill
    and decode, and ``long_500k`` for :data:`LONG_CONTEXT_ARCHS`."""
    get_config(name)
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if name in LONG_CONTEXT_ARCHS:
        out.append(SHAPES["long_500k"])
    return tuple(out)


__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "ALL_ARCHS", "LONG_CONTEXT_ARCHS",
    "get_config", "smoke_config", "shapes_for",
]
