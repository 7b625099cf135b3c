"""Legacy FedEntropy trainer — a thin shim over :mod:`repro_torch.fl`.

``FedEntropyTrainer`` keeps the JAX package's legacy surface and
reproduces its round histories on fixed seeds
(tests/test_torch_simulator.py holds it against the recorded golden
histories): the ablation booleans map onto component choices —

* ``use_judgment=False`` -> ``PassThroughJudge`` (FedAvg-of-selected),
* ``use_pools=False``    -> ``UniformSelector`` seeded ``seed + 1``
  (the legacy uniform RNG stream); the pools are still kept and updated
  by verdict, for observability, as the legacy trainer did.

New code should compose ``repro_torch.fl.build(...)`` directly.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..fl import registry as _registry
from ..device import resolve_device
from ..fl.aggregators import (FusedAverageAggregator, ScaffoldAggregator,
                              WeightedAverageAggregator)
from ..fl.judges import MaxEntropyJudge, PassThroughJudge
from ..fl.selectors import PoolSelector, UniformSelector
from ..fl.server import Server, ServerConfig, total_uplink_bytes
from .pools import DevicePools
from .strategies import ApplyFn, LocalSpec

__all__ = ["FLConfig", "FedEntropyTrainer", "total_uplink_bytes"]


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 100          # paper N
    participation: float = 0.1      # paper C
    rounds: int = 1000              # paper T
    eps: float = 0.8                # paper epsilon
    use_judgment: bool = True       # False -> FedAvg-of-selected (ablation)
    use_pools: bool = True          # False -> uniform selection (ablation)
    seed: int = 0


class FedEntropyTrainer:
    """Back-compat facade: one ``round()`` = paper Alg. 2 lines 4-22.

    ``device`` is where the params, the corpus and the round's tensor
    work live; it defaults to the card and raises when there is none. On
    the card the judgment runs K1's loop kernel and, except for
    scaffold, the average runs K2.
    """

    def __init__(self, apply_fn: ApplyFn, init_params, client_data,
                 fl: FLConfig, local: LocalSpec, *, device="cuda"):
        self.fl = fl
        self.local = local
        cfg = ServerConfig(num_clients=fl.num_clients,
                           participation=fl.participation,
                           eps=fl.eps, seed=fl.seed)
        if fl.use_pools:
            selector = PoolSelector(fl.num_clients, fl.eps, fl.seed)
            self.pools = selector.pools
            self._shadow_pools = None
        else:
            selector = UniformSelector(fl.num_clients, fl.seed + 1)
            self.pools = DevicePools(fl.num_clients, fl.eps, fl.seed)
            self._shadow_pools = self.pools
        strategy = _registry.get("strategy", local.strategy)(local)
        # on the card Alg. 1 runs in K1's loop kernel and the average in
        # K2; on the CPU the float64 judge and the leaf-wise average, the
        # reference's own, against which the golden histories are held
        on_card = resolve_device(device).type == "cuda"
        if local.strategy == "scaffold":
            aggregator = ScaffoldAggregator(local.scaffold_lr_g)
        elif on_card:
            aggregator = FusedAverageAggregator(backend="cuda")
        else:
            aggregator = WeightedAverageAggregator()
        judge = (MaxEntropyJudge(backend="cuda" if on_card else "numpy")
                 if fl.use_judgment else PassThroughJudge())
        self._server = Server(apply_fn, init_params, client_data, cfg,
                              selector=selector, strategy=strategy,
                              judge=judge, aggregator=aggregator,
                              device=device)

    # ---- delegated state --------------------------------------------------
    @property
    def apply_fn(self) -> ApplyFn:
        return self._server.apply_fn

    @property
    def data(self):
        return self._server.corpus

    @property
    def global_params(self):
        return self._server.global_params

    @global_params.setter
    def global_params(self, value):
        self._server.global_params = value

    @property
    def history(self) -> list[dict]:
        return self._server.history

    @property
    def round_idx(self) -> int:
        return self._server.round_idx

    @property
    def c_global(self):                     # legacy scaffold attribute
        return self._server.state["c_global"]

    @property
    def c_local(self):                      # legacy scaffold attribute
        return self._server.state["c_local"]

    @property
    def prev_params(self):                  # legacy moon attribute
        return self._server.state["prev_params"]

    # ---- delegated behaviour ---------------------------------------------
    def round(self) -> dict:
        rec = self._server.round()
        if self._shadow_pools is not None:
            self._shadow_pools.update(rec["positive"], rec["negative"])
        return rec

    def evaluate(self, x, y, batch: int = 512) -> dict:
        return self._server.evaluate(x, y, batch=batch)

    def run(self, rounds: int, eval_every: int = 0, eval_data=None) -> list:
        """Run ``rounds`` rounds; returns periodic eval metrics (if any)."""
        evals = []
        for r in range(rounds):
            self.round()
            if eval_every and eval_data is not None and \
                    (r + 1) % eval_every == 0:
                m = self.evaluate(*eval_data)
                m["round"] = self.round_idx
                evals.append(m)
        return evals
