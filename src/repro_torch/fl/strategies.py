"""ClientStrategy implementations around ``core.strategies.client_update``.

The local-update math lives in ``core.strategies.client_update`` (one
function per client, mapped over the cohort); these classes name the
rule and own its cross-round state — none for the strategies here.
"""
from __future__ import annotations

from dataclasses import replace

from ..core.strategies import LocalSpec
from .registry import register


class _StatelessStrategy:
    """Shared base for strategies with no cross-round state."""

    name = "fedavg"
    doubles_uplink = False

    def __init__(self, spec: LocalSpec | None = None):
        spec = spec or LocalSpec()
        # the class picks the update rule; refuse a spec that names a
        # *different* rule rather than silently running the wrong method
        if spec.strategy not in (self.name, "fedavg"):
            raise ValueError(
                f"LocalSpec(strategy={spec.strategy!r}) conflicts with the "
                f"{self.name!r} strategy class; build the "
                f"{spec.strategy!r} composition instead or drop the field")
        self.spec = replace(spec, strategy=self.name)

    @classmethod
    def from_config(cls, config, local):
        return cls(local)

    def init_state(self, global_params, num_clients: int):
        return None

    def update_state(self, state, global_params, out, idx, num_clients):
        return state


@register("strategy", "fedavg")
class FedAvgStrategy(_StatelessStrategy):
    """Plain local SGD(+momentum) [McMahan et al. 2017]."""
    name = "fedavg"


@register("strategy", "fedprox")
class FedProxStrategy(_StatelessStrategy):
    """FedAvg + proximal term to the global model [Li et al. 2020]."""
    name = "fedprox"
