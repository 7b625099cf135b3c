"""qwen3-0.6b — dense, GQA kv=8, qk_norm, explicit head_dim=128
[hf:Qwen/Qwen3-8B family card]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8,
    head_dim=128, d_ff=3072, vocab_size=151936,
    activation="silu", qk_norm=True, rope_theta=1e6,
    norm="rmsnorm", tie_embeddings=True,
    source="Qwen3 [hf:Qwen/Qwen3-8B]",
)
