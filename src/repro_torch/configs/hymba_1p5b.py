"""hymba-1.5b — hybrid: parallel attention + Mamba heads in each block,
ssm_state=16. [arXiv:2411.13676; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64,
    d_ff=5504, vocab_size=32_001,
    mlp_kind="swiglu",
    ssm=True, ssm_state=16, hybrid_parallel=True,
    max_seq_len=524_288,
)
