"""llama4-scout-17b-16e — MoE 16 experts top-1 + shared expert, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202_048,
    mlp_kind="swiglu",
    moe=True, num_experts=16, moe_top_k=1, moe_d_ff=8192, shared_expert=True,
    tie_embeddings=False,
)
