"""starcoder2-3b — dense GQA kv=2, LayerNorm + non-gated GELU MLP, RoPE.
[arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    num_layers=30, d_model=3072, num_heads=24, num_kv_heads=2, head_dim=128,
    d_ff=12288, vocab_size=49_152,
    mlp_kind="gelu_mlp", norm="layernorm",
)
