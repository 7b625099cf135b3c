"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 (paper-table)
[arXiv:2501.kimi2]. Spec'd here with GQA kv=8 per the assignment (the real
model uses MLA; the assignment pins GQA)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    head_dim=128, d_ff=2048, vocab_size=163840,
    num_experts=384, experts_per_token=8,
    activation="silu", rope_theta=5e4,
    norm="rmsnorm", tie_embeddings=False,
    source="Kimi K2 [arXiv:2501.kimi2] (paper-table trillion-param MoE)",
)
