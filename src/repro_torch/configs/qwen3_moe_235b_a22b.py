"""qwen3-moe-235b-a22b — MoE 128 experts top-8, QK-norm.
[hf:Qwen/Qwen3-235B-A22B family; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    num_layers=94, d_model=4096, num_heads=64, num_kv_heads=4, head_dim=128,
    d_ff=1536, vocab_size=151_936,
    mlp_kind="swiglu", qk_norm=True,
    moe=True, num_experts=128, moe_top_k=8, moe_d_ff=1536,
    tie_embeddings=False,
)
