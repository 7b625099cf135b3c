"""``repro_torch.fl`` — the pluggable federated-learning server API.

Paper Alg. 2 decomposed into four swappable axes (see
:mod:`repro_torch.fl.protocols`):

=============  ==================================  =====================
axis           question it answers                 built-ins
=============  ==================================  =====================
``Selector``   who is asked to train this round    ``pools``, ``uniform``
``ClientStrategy``  how each client trains         ``fedavg``, ``fedprox``,
                                                   ``moon``, ``scaffold``
``Judge``      whose update is admitted            ``maxent``, ``none``,
                                                   ``budget``
``Aggregator`` how admitted updates merge          ``weighted``, ``fused``,
                                                   ``scaffold``
=============  ==================================  =====================

::

    import repro_torch.fl as fl

    server = fl.build("fedentropy", cnn.apply, params, corpus,
                      fl.ServerConfig(num_clients=100, participation=0.1),
                      judge=fl.MaxEntropyJudge(backend="cuda"),
                      aggregator=fl.FusedAverageAggregator(backend="cuda"))
    server.fit(rounds=3)

On the card the vmapped client program runs as a captured CUDA graph
(``fl.graph_cache``); ``with fl.disable_capture():`` runs it eagerly.
"""
from ..core.strategies import LocalSpec
from ..data.corpus import ClientCorpus, Normalize
from .aggregators import (FusedAverageAggregator, ScaffoldAggregator,
                          WeightedAverageAggregator)
from .graph_cache import BoundedGraphCache, disable_capture
from .judges import BudgetedJudge, MaxEntropyJudge, PassThroughJudge
from .protocols import Aggregator, ClientStrategy, Judge, Selector
from .registry import Composition, build, get, names, register
from .selectors import PoolSelector, UniformSelector
from .server import Server, ServerConfig, total_uplink_bytes
from .strategies import (FedAvgStrategy, FedProxStrategy, MoonStrategy,
                         ScaffoldStrategy)

__all__ = [
    "Aggregator", "BoundedGraphCache", "BudgetedJudge", "ClientCorpus",
    "ClientStrategy", "Composition", "FedAvgStrategy", "FedProxStrategy",
    "FusedAverageAggregator", "Judge", "LocalSpec", "MaxEntropyJudge",
    "MoonStrategy", "Normalize", "PassThroughJudge", "PoolSelector",
    "ScaffoldAggregator", "ScaffoldStrategy", "Selector", "Server",
    "ServerConfig", "UniformSelector", "WeightedAverageAggregator", "build",
    "disable_capture", "get", "names", "register", "total_uplink_bytes",
]
