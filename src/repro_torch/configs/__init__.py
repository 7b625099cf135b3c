"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

Holds all 11 of the reference's configs, one for each family the port
runs: dense, moe, ssm, hybrid, vlm (``internvl2-1b``), encdec
(``whisper-large-v3``) and the paper's cnn.
"""
from .base import SHAPES, ModelConfig, ShapeConfig

from . import (
    chatglm3_6b,
    fedentropy_cnn,
    gemma_7b,
    granite_8b,
    internvl2_1b,
    kimi_k2_1t_a32b,
    mamba2_130m,
    qwen3_0_6b,
    qwen3_moe_235b_a22b,
    whisper_large_v3,
    zamba2_2_7b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        mamba2_130m, whisper_large_v3, qwen3_0_6b, granite_8b,
        internvl2_1b, gemma_7b, zamba2_2_7b, qwen3_moe_235b_a22b,
        chatglm3_6b, kimi_k2_1t_a32b, fedentropy_cnn,
    )
}

# the 10 assigned architectures (excludes the paper's own CNN)
ASSIGNED = [n for n in ARCHS if n != "fedentropy-cnn"]


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]
