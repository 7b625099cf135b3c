"""Aggregator implementations: merging admitted updates (Alg. 2 line 21).

``WeightedAverageAggregator`` — size-weighted FedAvg over the admitted
                                mask (``core.aggregation.aggregate``), one
                                reduction per leaf.
``FusedAverageAggregator``    — the same mean as ONE flat reduction
                                (``core.aggregation.fused_aggregate``):
                                every leaf flattened into a single (M, P)
                                buffer and reduced in one call — the plain
                                version or the fused_aggregate CUDA kernel.
                                Float32-tolerance equal to ``weighted``,
                                not bitwise.
``ScaffoldAggregator``        — the same average as ``weighted``, then the
                                SCAFFOLD damped server step
                                w_g <- w_g + eta_g*(avg - w_g).
"""
from __future__ import annotations

from torch.utils import _pytree as pytree

from ..core.aggregation import aggregate, fused_aggregate
from .registry import register


@register("aggregator", "weighted")
class WeightedAverageAggregator:
    """w_g = sum_{i in A} L_i W_i / sum_{i in A} L_i."""

    @classmethod
    def from_config(cls, config, local):
        return cls()

    def __call__(self, global_params, out, sizes, mask):
        return aggregate(out["params"], sizes, mask)


@register("aggregator", "fused")
class FusedAverageAggregator:
    """``weighted``'s mean as one flat (M, P) reduction.

    ``backend="cuda"`` reduces through the fused_aggregate kernel;
    ``"torch"`` through its plain version.
    """

    def __init__(self, backend: str = "torch"):
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown aggregation backend {backend!r}")
        self.backend = backend

    @classmethod
    def from_config(cls, config, local):
        return cls()

    def __call__(self, global_params, out, sizes, mask):
        return fused_aggregate(out["params"], sizes, mask,
                               backend=self.backend)


@register("aggregator", "scaffold")
class ScaffoldAggregator:
    """Weighted average followed by a global step of size ``lr_g``.

    The step is ``wg + eta * (avg - wg)`` as the reference writes it: at
    ``eta = 1`` that is not bit-equal to ``avg``.
    """

    def __init__(self, lr_g: float = 1.0):
        self.lr_g = float(lr_g)

    @classmethod
    def from_config(cls, config, local):
        return cls(local.scaffold_lr_g)

    def __call__(self, global_params, out, sizes, mask):
        avg = aggregate(out["params"], sizes, mask)
        eta = self.lr_g
        return pytree.tree_map(
            lambda wg, ag: wg + eta * (ag.to(wg.dtype) - wg),
            global_params, avg)
