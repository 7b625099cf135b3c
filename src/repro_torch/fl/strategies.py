"""ClientStrategy implementations around ``core.strategies.client_update``.

The local-update math lives in ``core.strategies.client_update`` (one
function per client, mapped over the cohort); these classes name the
rule and own its cross-round state as an explicit tree of tensors
(``init_state``, threaded through ``update_state``), and describe how
that state is sliced onto the cohort's client axis (``client_inputs``,
``client_in_axes``) and folded back.
"""
from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..core.strategies import LocalSpec
from .registry import register


def _rows(idx, like: torch.Tensor) -> torch.Tensor:
    """Host client ids as an int64 index on ``like``'s device."""
    return torch.as_tensor(np.asarray(idx, np.int64), device=like.device)


def _stacked(tree, num_clients: int):
    """Every leaf repeated on a new leading (num_clients,) axis."""
    return pytree.tree_map(
        lambda x: x.expand((num_clients,) + x.shape).clone(), tree)


def _take(stacked, idx):
    """The rows ``idx`` of every leaf of a (N, ...) tree."""
    return pytree.tree_map(lambda x: x.index_select(0, _rows(idx, x)),
                           stacked)


def _put(stacked, idx, rows):
    """A copy of the (N, ...) tree with rows ``idx`` replaced by ``rows``."""
    return pytree.tree_map(
        lambda full, new: full.index_copy(0, _rows(idx, full),
                                          new.to(full.dtype)),
        stacked, rows)


class _Strategy:
    """Shared base of the strategies: no cross-round state and no state
    slices unless a subclass (moon, scaffold) adds them."""

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

    def client_inputs(self, state, idx):
        return None, None, None

    def client_in_axes(self) -> tuple:
        return (None, 0, None, None, None)

    def update_state(self, state, global_params, out, idx, num_clients):
        return state


@register("strategy", "fedavg")
class FedAvgStrategy(_Strategy):
    """Plain local SGD(+momentum) [McMahan et al. 2017]."""
    name = "fedavg"


@register("strategy", "fedprox")
class FedProxStrategy(_Strategy):
    """FedAvg + proximal term to the global model [Li et al. 2020]."""
    name = "fedprox"


@register("strategy", "moon")
class MoonStrategy(_Strategy):
    """Model-contrastive learning [Li et al. 2021].

    State: ``prev_params`` — every client's last local model, stacked on a
    leading (num_clients,) axis.
    """
    name = "moon"

    def init_state(self, global_params, num_clients: int):
        return {"prev_params": _stacked(global_params, num_clients)}

    def client_inputs(self, state, idx):
        return _take(state["prev_params"], idx), None, None

    def client_in_axes(self) -> tuple:
        return (None, 0, 0, None, None)

    def update_state(self, state, global_params, out, idx, num_clients):
        return {"prev_params": _put(state["prev_params"], idx,
                                    out["params"])}


@register("strategy", "scaffold")
class ScaffoldStrategy(_Strategy):
    """Control-variate-corrected SGD [Karimireddy et al. 2020].

    State: server variate ``c_global`` plus per-client variates
    ``c_local`` stacked on a leading (num_clients,) axis. Pair with
    ``aggregator="scaffold"`` for the damped server step.
    """
    name = "scaffold"
    doubles_uplink = True           # uplink carries model + control variate

    def init_state(self, global_params, num_clients: int):
        return {
            "c_global": pytree.tree_map(torch.zeros_like, global_params),
            "c_local": pytree.tree_map(
                lambda x: x.new_zeros((num_clients,) + x.shape),
                global_params),
        }

    def client_inputs(self, state, idx):
        return None, _take(state["c_local"], idx), state["c_global"]

    def client_in_axes(self) -> tuple:
        return (None, 0, None, 0, None)

    def update_state(self, state, global_params, out, idx, num_clients):
        # c <- c + |S_t|/N * mean_i dc_i over the whole cohort, admitted
        # or not; the cohort's c_i rows are replaced
        frac = len(idx) / num_clients
        return {
            "c_global": pytree.tree_map(lambda c, d: c + frac * d.mean(0),
                                        state["c_global"], out["c_delta"]),
            "c_local": _put(state["c_local"], idx, out["c_local"]),
        }
