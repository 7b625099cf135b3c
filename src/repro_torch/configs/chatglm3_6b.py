"""chatglm3-6b — dense, 2d (half-rotary) RoPE, extreme GQA kv=2
[arXiv:2406.12793]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    head_dim=128, d_ff=13696, vocab_size=65024,
    activation="silu", attn_bias=True, rope_style="half",
    norm="rmsnorm", tie_embeddings=False,
    source="ChatGLM [arXiv:2406.12793], chatglm3-6b card",
)
