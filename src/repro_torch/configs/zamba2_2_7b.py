"""zamba2-2.7b — hybrid: Mamba2 backbone + SHARED attention block every 6th
layer [arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
    d_ff=10240, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    attn_every=6, shared_attention=True,
    activation="gelu", norm="rmsnorm", tie_embeddings=True,
    source="Zamba2 [arXiv:2411.15242]",
)
