"""Model configuration dataclass (copy of ``repro.configs.base``).

Only the fields the ported decoder reads change behaviour here; the rest are
kept so a config round-trips field for field against the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

__all__ = ["ModelConfig"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | hybrid | ssm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- attention ---
    mlp_kind: str = "swiglu"       # swiglu | geglu | gelu_mlp
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    attn_pattern: str = "global"   # global | local_global
    local_window: int = 1024
    pattern_locals: int = 5
    # --- moe ---
    moe: bool = False
    num_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- ssm / hybrid / rwkv ---
    ssm: bool = False
    ssm_state: int = 16
    ssm_conv: int = 4
    hybrid_parallel: bool = False
    rwkv: bool = False
    # --- modality stubs ---
    modality: str = "text"
    num_prefix_tokens: int = 0
    num_codebooks: int = 0
    # --- training ---
    tie_embeddings: bool = True
    lr_schedule: str = "cosine"
    max_seq_len: int = 131072

    def __post_init__(self):
        if self.moe and not self.num_experts:
            raise ValueError("moe requires num_experts")
        if self.rwkv and self.ssm:
            raise ValueError("rwkv and ssm are exclusive")

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def layer_pattern(self) -> Tuple[str, ...]:
        """Per-layer attention kinds within one repeating pattern unit."""
        if self.rwkv:
            return ("rwkv",)
        if self.attn_pattern == "local_global":
            return ("local",) * self.pattern_locals + ("global",)
        return ("global",)

    @property
    def pattern_repeats(self) -> int:
        unit = len(self.layer_pattern)
        if self.num_layers % unit:
            raise ValueError(f"{self.name}: {self.num_layers} layers not divisible by pattern {unit}")
        return self.num_layers // unit

    def param_count(self) -> int:
        """Analytic parameter count of a dense decoder (embeddings + blocks)."""
        d, dff, L = self.d_model, self.d_ff, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        up_gate = 2 if self.mlp_kind in ("swiglu", "geglu") else 1
        return emb + L * (attn + (up_gate + 1) * d * dff)
