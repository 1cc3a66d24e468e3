"""rwkv6-3b (Finch) — attention-free, data-dependent decay linear recurrence.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40, head_dim=64,
    d_ff=8960, vocab_size=65_536,
    mlp_kind="rwkv_cm", rwkv=True,
    max_seq_len=524_288,
)
