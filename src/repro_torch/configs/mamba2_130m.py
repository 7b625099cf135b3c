"""mamba2-130m — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    num_layers=24, d_model=768, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_chunk=256,
    ssm_conv=4, ssm_ngroups=1,
    norm="rmsnorm", tie_embeddings=True,
    source="Mamba-2: Transformers are SSMs [arXiv:2405.21060], 130m card",
)
