"""granite-8b — llama-arch dense code model [arXiv:2405.04324]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b", family="dense",
    num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
    head_dim=128, d_ff=14336, vocab_size=49152,
    activation="silu", rope_theta=1e4,
    norm="rmsnorm", tie_embeddings=False,
    source="Granite Code Models [arXiv:2405.04324]",
)
