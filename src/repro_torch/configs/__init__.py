"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

Holds the configurations whose families the port runs (dense, moe,
ssm, hybrid, and the paper's cnn): 9 of the reference's 11 configs;
``internvl2-1b`` (vlm) and ``whisper-large-v3`` (encdec) come with their
families.
"""
from .base import SHAPES, ModelConfig, ShapeConfig

from . import (
    chatglm3_6b,
    fedentropy_cnn,
    gemma_7b,
    granite_8b,
    kimi_k2_1t_a32b,
    mamba2_130m,
    qwen3_0_6b,
    qwen3_moe_235b_a22b,
    zamba2_2_7b,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        mamba2_130m, qwen3_0_6b, granite_8b, gemma_7b, zamba2_2_7b,
        qwen3_moe_235b_a22b, chatglm3_6b, kimi_k2_1t_a32b, fedentropy_cnn,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]
