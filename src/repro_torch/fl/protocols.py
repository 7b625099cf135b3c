"""Protocol classes for the four pluggable axes of an FL round (Alg. 2).

FedEntropy's judgment is a composable add-on (paper Sec. 3.4 / Table 3):
related methods swap exactly one axis of the round — who is asked
(``Selector``), how each client trains (``ClientStrategy``), whose update
is admitted (``Judge``), and how admitted updates merge (``Aggregator``).
Any object with the right methods plugs in; register implementations
with :func:`repro_torch.fl.register` to name them.

Data plane vs control plane: ``ClientStrategy``/``Aggregator`` run tensor
code on the stacked client axis on the server's device; ``Selector`` runs
host-side numpy. A ``Judge`` receives the round's soft labels and sizes
as tensors on the server's device — the numpy judge copies them to the
host in float64, the torch and CUDA judges judge them where they are.
"""
from __future__ import annotations

from typing import Any, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

Params = Any           # nested dict of tensors
StrategyState = Any    # owned by a ClientStrategy (or None)


@runtime_checkable
class Selector(Protocol):
    """Chooses the round's device set S_t (Alg. 2 lines 4-8).

    Optional: ``bind_data(corpus)`` takes the corpus's stats once, and
    ``data_schedule(sel)`` gives each selected client's released sample
    count for the gather. A selector holds host state only, so the
    pipelined engine's ``copy.deepcopy`` of it replays its draws.
    """

    def select(self, num: int) -> list[int]:
        """Draw ``num`` distinct device ids for this round."""
        ...

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        """Feed back the judgment verdict (Alg. 2 line 22)."""
        ...

    def stats(self) -> dict:
        """Introspection counters (pool sizes etc.) for logging."""
        ...


@runtime_checkable
class ClientStrategy(Protocol):
    """Owns the local-update rule and all of its cross-round state.

    State lives in an explicit tree returned by :meth:`init_state` and
    threaded through :meth:`update_state`; ``client_inputs`` and
    ``client_in_axes`` describe how it is sliced onto the vmapped
    per-client update.

    Optional chain hooks (FedCAT's ``CatChainStrategy``), used by the
    server as the reference's does:

    * ``make_client_fn(apply_fn)`` returns the strategy's own client
      program ``(global_params, gdata, prev_p, c_loc, c_glob, valid)``,
      which replaces the vmapped ``client_update`` (and, on the card, is
      the program captured as a CUDA graph);
    * ``prepare_round(data, selector) -> (gdata, aux)`` lays the gathered
      cohort out in groups read off ``selector`` (the one that made the
      selection); ``aux["valid"]`` is the program's last argument;
    * ``finish_round(out, aux)`` returns the program's outputs in cohort
      order, with any annotations the aggregator reads (``group_id``,
      ``chain_pos``).
    """

    spec: Any                      # hyperparameters (LocalSpec)
    doubles_uplink: bool           # True if uplink carries control variates

    def init_state(self, global_params: Params,
                   num_clients: int) -> StrategyState:
        """Build the strategy's state (None if stateless)."""
        ...

    def client_inputs(self, state: StrategyState, idx
                      ) -> tuple[Params | None, Params | None, Params | None]:
        """Slice state for the selected clients: (prev_params, c_local,
        c_global) as consumed by ``core.strategies.client_update``."""
        ...

    def client_in_axes(self) -> tuple:
        """vmap in_dims for (global_params, data, prev_p, c_loc, c_glob)."""
        ...

    def update_state(self, state: StrategyState, global_params: Params,
                     out: dict, idx, num_clients: int) -> StrategyState:
        """Fold the round's client outputs back into the state."""
        ...


@runtime_checkable
class Judge(Protocol):
    """Decides which selected devices' models aggregate (Alg. 1).

    Optional, read by the pipelined engine: ``traced()`` returns a
    ``(soft, sizes) -> core.judgment.JudgmentResult`` function that stays
    on the device (without it the engine runs the round sequentially),
    and ``on_host`` is true where the judge computes from a host copy of
    its inputs (the engine then hands it the round's host copy).
    """

    def __call__(self, soft_labels: torch.Tensor, sizes: torch.Tensor
                 ) -> tuple[list[int], list[int], float]:
        """Return (accepted, rejected, entropy) — positions are *relative*
        indices into the round's selection, entropy is the final group
        entropy over the accepted set (NaN if not entropy-based)."""
        ...


@runtime_checkable
class ClusterAssigner(Protocol):
    """Optional fifth axis: maps selected clients to model-bank centers.

    When a composition names a ``cluster`` assigner (and
    ``ServerConfig.num_clusters > 1``) the server carries a K-center
    :class:`repro_torch.fl.clusters.ModelBank` instead of one param tree,
    clients train from their assigned center, and judgment and
    aggregation run per cluster. ``assign`` returns host numpy ids and
    must be *verdict-independent given the bank* (the pipelined engine
    assigns round t+1 against the speculatively aggregated bank and keeps
    that only on an oracle hit).
    """

    num_clusters: int

    def bind(self, server) -> None:
        """Attach the server whose corpus, bank and apply fn drive the
        assignment; called once at construction."""
        ...

    def assign(self, sel: Sequence[int], bank=None) -> np.ndarray:
        """Cluster id per selected client, drawn against ``bank`` (the
        server's current bank when ``None``)."""
        ...

    def update(self, sel: Sequence[int], cluster_ids: np.ndarray,
               out: dict, bank) -> None:
        """Fold the round's client outputs back into the assignment state
        (FeSEM's sticky re-filing; a no-op for stateless assigners), run
        against the round's *pre-aggregation* bank."""
        ...

    def stats(self) -> dict:
        """Introspection counters (cluster occupancy etc.) for logging."""
        ...


@runtime_checkable
class Aggregator(Protocol):
    """Merges admitted client models into the next global model."""

    def __call__(self, global_params: Params, out: dict,
                 sizes: torch.Tensor, mask: torch.Tensor) -> Params:
        """``out`` is the stacked client-update dict (leading axis = |S_t|);
        ``mask`` is the judge's 0/1 admission mask over that axis."""
        ...
