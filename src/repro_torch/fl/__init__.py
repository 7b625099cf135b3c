"""``repro_torch.fl`` — the pluggable federated-learning server API.

Paper Alg. 2 decomposed into four swappable axes (see
:mod:`repro_torch.fl.protocols`):

=============  ==================================  =====================
axis           question it answers                 built-ins
=============  ==================================  =====================
``Selector``   who is asked to train this round    ``pools``, ``uniform``,
                                                   ``pools-traced``,
                                                   ``queue``, ``catgroups``,
                                                   ``catgroups-pools``
``ClientStrategy``  how each client trains         ``fedavg``, ``fedprox``,
                                                   ``moon``, ``scaffold``,
                                                   ``catchain``, ``lmstep``
``Judge``      whose update is admitted            ``maxent``, ``none``,
                                                   ``budget``
``Aggregator`` how admitted updates merge          ``weighted``, ``fused``,
                                                   ``scaffold``, ``devconcat``,
                                                   ``perclstr``
=============  ==================================  =====================

An optional fifth axis, ``cluster`` (:mod:`repro_torch.fl.clusters`),
swaps the single global model for a K-center ``ModelBank``
(``ServerConfig.num_clusters``): clients train from their assigned center
(``ifca`` loss-based or ``fesem`` weight-distance assignment) and
judgment and aggregation run per cluster — compositions ``ifca``,
``ifca+maxent`` and ``fesem``.

::

    import repro_torch.fl as fl

    server = fl.build("fedentropy", cnn.apply, params, corpus,
                      fl.ServerConfig(num_clients=100, participation=0.1),
                      judge=fl.MaxEntropyJudge(backend="cuda"),
                      aggregator=fl.FusedAverageAggregator(backend="cuda"))
    server.fit(rounds=3)

On the card the vmapped client program runs as a captured CUDA graph
(``fl.graph_cache``); ``with fl.disable_capture():`` runs it eagerly.
``engine="pipelined"`` with ``runtime=fl.RuntimeConfig(speculate=True)``
speculates each round's verdict on the card (``fl.runtime``);
``fl.build("fedcat+maxent", ...)`` trains entropy-grouped device chains
(FedCAT) and judges chain members before concatenation;
``runtime=fl.AsyncConfig(...)`` streams arrivals through the async
buffered engine; ``fl.build("fedentropy-traced", ...,
runtime=fl.ScanConfig(rounds_per_scan=4))`` runs blocks of 4 rounds, each
one CUDA graph on the card; ``drift=fl.drift_schedule(...)`` re-partitions clients
mid-run. ``data_plane="streaming"`` (or ``"auto"`` past 1 GiB) keeps the
corpus on the host as an ``fl.HostCorpus`` and uploads one cohort a round;
the pipelined engine stages its speculated next cohort on a prefetch
thread (``fl.as_data_plane`` resolves a plane).
"""
from ..core.strategies import LocalSpec
from ..data.corpus import ClientCorpus, DataQueue, Normalize
from ..data.partition import DriftEvent, drift_schedule
from ..data.stream import HostCorpus, as_data_plane
from .aggregators import (DeviceConcatAggregator, FusedAverageAggregator,
                          PerClusterAggregator, ScaffoldAggregator,
                          WeightedAverageAggregator)
from .clusters import FeSEMAssigner, IFCAAssigner, ModelBank, argmin_assign
from .graph_cache import BoundedGraphCache, disable_capture
from .judges import BudgetedJudge, MaxEntropyJudge, PassThroughJudge
from .protocols import (Aggregator, ClientStrategy, ClusterAssigner, Judge,
                        Selector)
from .registry import Composition, build, get, names, register
from .selectors import (CatGrouper, PoolCatGrouper, PoolSelector,
                        QueueSelector, TracedPoolSelector, UniformSelector)
from .server import Server, ServerConfig, total_uplink_bytes
from .strategies import (CatChainStrategy, FedAvgStrategy, FedProxStrategy,
                         LMWindowStrategy, MoonStrategy, ScaffoldStrategy)
from .runtime import (AsyncBufferedServer, AsyncConfig, ClientMesh,
                      PipelinedServer, ProcessCompileCache, RuntimeConfig,
                      ScanConfig, ScanServer, SequentialEngine,
                      disable_process_cache, enable_process_cache,
                      make_client_mesh, process_cache)

__all__ = [
    "Aggregator", "AsyncBufferedServer", "AsyncConfig", "BoundedGraphCache",
    "BudgetedJudge", "CatChainStrategy", "CatGrouper", "ClientCorpus",
    "ClientMesh",
    "ClientStrategy", "ClusterAssigner", "Composition", "DataQueue",
    "DeviceConcatAggregator", "DriftEvent", "FeSEMAssigner", "FedAvgStrategy",
    "FedProxStrategy", "FusedAverageAggregator", "HostCorpus", "IFCAAssigner",
    "Judge", "LMWindowStrategy", "LocalSpec", "MaxEntropyJudge", "ModelBank",
    "MoonStrategy", "Normalize", "PassThroughJudge", "PerClusterAggregator",
    "PipelinedServer", "PoolCatGrouper", "PoolSelector", "ProcessCompileCache",
    "QueueSelector", "RuntimeConfig", "ScaffoldAggregator", "ScaffoldStrategy",
    "ScanConfig", "ScanServer", "Selector", "SequentialEngine", "Server",
    "ServerConfig", "TracedPoolSelector", "UniformSelector",
    "WeightedAverageAggregator", "argmin_assign", "as_data_plane", "build",
    "disable_capture", "disable_process_cache", "drift_schedule",
    "enable_process_cache", "get", "make_client_mesh", "names",
    "process_cache", "register",
    "total_uplink_bytes",
]
