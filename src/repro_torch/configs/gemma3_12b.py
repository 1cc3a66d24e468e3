"""gemma3-12b — dense, 5:1 local:global attention, 128k context.
[hf:google/gemma-3-12b-pt family; assignment tier: unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b", family="dense",
    num_layers=48, d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=15360, vocab_size=262_144,
    mlp_kind="geglu", norm="rmsnorm", rope_theta=1_000_000.0,
    qk_norm=True, attn_pattern="local_global", local_window=1024, pattern_locals=5,
    max_seq_len=524_288,
)
