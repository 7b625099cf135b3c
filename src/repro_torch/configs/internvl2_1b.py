"""internvl2-1b — VLM: InternViT frontend (stub) + Qwen2-0.5B-style LM
[arXiv:2404.16821]. input_specs feeds 256 precomputed patch embeddings."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2,
    d_ff=4864, vocab_size=151655, num_patches=256,
    activation="silu", attn_bias=True, rope_theta=1e6,
    norm="rmsnorm", tie_embeddings=True,
    source="InternVL2 [arXiv:2404.16821]; LM tower = Qwen2-0.5B",
)
