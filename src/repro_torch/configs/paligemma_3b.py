"""paligemma-3b — SigLIP stub + gemma-2b backbone, prefix-LM over 256 image
tokens. [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257_216,
    mlp_kind="geglu", modality="vlm", num_prefix_tokens=256,
)
