"""gemma-2b — dense GeGLU, MQA (kv=1), head_dim=256. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256_000,
    mlp_kind="geglu",
)
