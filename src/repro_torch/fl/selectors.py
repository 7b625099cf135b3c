"""Selector implementations: who is asked to train this round.

``PoolSelector``    — the paper's epsilon-greedy positive/negative pools
                      (Alg. 2 lines 4-8/22), delegating to
                      ``core.pools.DevicePools``.
``UniformSelector`` — uniform sampling without replacement. Seeded with
                      ``seed + 1`` by the registry, as in the JAX package,
                      so both draw the same cohorts.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.pools import DevicePools
from .registry import register


@register("selector", "pools")
class PoolSelector:
    """Epsilon-greedy over the paper's positive/negative device pools."""

    def __init__(self, num_clients: int, eps: float = 0.8, seed: int = 0):
        self.pools = DevicePools(num_clients, eps, seed)

    @classmethod
    def from_config(cls, config, local):
        return cls(config.num_clients, config.eps, config.seed)

    def select(self, num: int) -> list[int]:
        return self.pools.select(min(num, self.pools.num_devices))

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        self.pools.update(list(positives), list(negatives))

    def stats(self) -> dict:
        return self.pools.stats()


@register("selector", "uniform")
class UniformSelector:
    """Uniform sampling without replacement; ignores judgment feedback."""

    def __init__(self, num_clients: int, seed: int = 0):
        self.num_clients = num_clients
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, config, local):
        return cls(config.num_clients, config.seed + 1)

    def select(self, num: int) -> list[int]:
        num = min(num, self.num_clients)
        return [int(i) for i in
                self._rng.choice(self.num_clients, num, replace=False)]

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        pass

    def stats(self) -> dict:
        return {"selector": "uniform", "num_clients": self.num_clients}
