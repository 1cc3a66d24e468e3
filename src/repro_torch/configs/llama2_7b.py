"""llama2-7b — the paper's primary evaluation model (Section 4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama2-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
    d_ff=11008, vocab_size=32_000,
    mlp_kind="swiglu", tie_embeddings=False,
)
