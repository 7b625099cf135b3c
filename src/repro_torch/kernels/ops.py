"""Kernel entry points with backend dispatch.

backend="torch" — the plain PyTorch versions in :mod:`.ref` (any device).
backend="cuda"  — the hand-written CUDA kernels; on a CUDA tensor the
                  kernel launches or raises, and only a CPU tensor takes
                  the plain version.
"""
from __future__ import annotations

from . import ref

BACKENDS = ("torch", "cuda")


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {BACKENDS}")


def entropy_judge_sweep(soft_labels, sizes, mask, *, backend="torch"):
    _check(backend)
    if backend == "cuda":
        from .entropy_judge import entropy_judge_sweep
        return entropy_judge_sweep(soft_labels, sizes, mask)
    return ref.entropy_judge_sweep_reference(soft_labels, sizes, mask)


def masked_weighted_sum(flat, weights, *, backend="torch"):
    _check(backend)
    if backend == "cuda":
        from .fused_aggregate import masked_weighted_sum
        return masked_weighted_sum(flat, weights)
    return ref.masked_weighted_sum_reference(flat, weights)
