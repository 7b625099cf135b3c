"""whisper-large-v3 — enc-dec audio; conv/mel frontend is a stub
[arXiv:2212.04356]. 32 encoder + 32 decoder layers, d=1280, 20 heads (MHA),
d_ff=5120, vocab 51866, 1500 encoder frames (30 s audio)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="encdec",
    num_layers=32, num_encoder_layers=32, encoder_seq=1500,
    d_model=1280, num_heads=20, num_kv_heads=20, d_ff=5120,
    vocab_size=51866, activation="gelu", attn_bias=True,
    rope_style="none", norm="layernorm", tie_embeddings=True,
    source="Robust Speech Recognition via Large-Scale Weak Supervision "
           "[arXiv:2212.04356], large-v3 card",
)
