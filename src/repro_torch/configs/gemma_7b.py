"""gemma-7b — dense, GeGLU, head_dim=256, embed scaling [arXiv:2403.08295]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16,
    head_dim=256, d_ff=24576, vocab_size=256000,
    activation="geglu", embed_scale=True, rope_theta=1e4,
    norm="rmsnorm", tie_embeddings=True,
    source="Gemma [arXiv:2403.08295] (7B; the 2B sibling uses MQA)",
)
