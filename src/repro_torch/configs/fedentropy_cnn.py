"""The paper's own model: LeNet-style CNN (FedEntropy Appendix Table 5)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="fedentropy-cnn", family="cnn",
    num_layers=2, d_model=84, d_ff=120, vocab_size=10,
    param_dtype="float32", dtype="float32", remat="none",
    source="FedEntropy (Ling et al., 2022), Appendix Table 5",
)
