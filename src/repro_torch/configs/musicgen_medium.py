"""musicgen-medium — decoder-only over EnCodec tokens (4 codebooks, delay
pattern); the frontend is a stub providing frame tokens. [arXiv:2306.05284; hf]

As in the reference: LayerNorm kept, RoPE for position in place of the
original's learned positional embeddings."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    mlp_kind="gelu_mlp", norm="layernorm",
    modality="audio", num_codebooks=4, tie_embeddings=False,
)
