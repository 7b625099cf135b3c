"""Architecture registry of the port: ``get_config(name)`` / ``ARCHS``.

Holds the configurations whose families the port runs (dense, ssm,
hybrid, and the paper's cnn); the others come with their families.
"""
from .base import SHAPES, ModelConfig, ShapeConfig

from . import fedentropy_cnn, mamba2_130m, qwen3_0_6b, zamba2_2_7b

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (mamba2_130m, qwen3_0_6b, zamba2_2_7b, fedentropy_cnn)
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]
