"""``repro_torch.fl`` — the pluggable federated-learning server API.

Paper Alg. 2 decomposed into four swappable axes (see
:mod:`repro_torch.fl.protocols`):

=============  ==================================  =====================
axis           question it answers                 built-ins
=============  ==================================  =====================
``Selector``   who is asked to train this round    ``pools``, ``uniform``
``ClientStrategy``  how each client trains         ``fedavg``, ``fedprox``
``Judge``      whose update is admitted            ``maxent``, ``none``
``Aggregator`` how admitted updates merge          ``weighted``, ``fused``
=============  ==================================  =====================

::

    import repro_torch.fl as fl

    server = fl.build("fedentropy", cnn.apply, params, corpus,
                      fl.ServerConfig(num_clients=100, participation=0.1),
                      judge=fl.MaxEntropyJudge(backend="cuda"),
                      aggregator=fl.FusedAverageAggregator(backend="cuda"))
    server.fit(rounds=3)
"""
from ..core.strategies import LocalSpec
from ..data.corpus import ClientCorpus, Normalize
from .aggregators import FusedAverageAggregator, WeightedAverageAggregator
from .judges import MaxEntropyJudge, PassThroughJudge
from .protocols import Aggregator, ClientStrategy, Judge, Selector
from .registry import Composition, build, get, names, register
from .selectors import PoolSelector, UniformSelector
from .server import Server, ServerConfig
from .strategies import FedAvgStrategy, FedProxStrategy

__all__ = [
    "Aggregator", "ClientCorpus", "ClientStrategy", "Composition",
    "FedAvgStrategy", "FedProxStrategy", "FusedAverageAggregator", "Judge",
    "LocalSpec", "MaxEntropyJudge", "Normalize", "PassThroughJudge",
    "PoolSelector", "Selector", "Server", "ServerConfig", "UniformSelector",
    "WeightedAverageAggregator", "build", "get", "names", "register",
]
