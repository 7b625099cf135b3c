"""``repro_torch.fl.runtime`` — the round engines beyond the sequential
``Server``, and the client axis over several devices.

The same four composition axes as :class:`repro_torch.fl.Server`, driven
by (a) the pipelined engine, which overlaps the host-side float64
judgment oracle with the next round's client compute by speculating the
verdict on the device (K1's loop with ``spec_backend="cuda"``), (b) the
async buffered engine, which drops the round barrier: clients stream
updates under a deterministic simulated arrival clock, max-entropy
judgment admits or rejects each arrival batch against the buffered group
(K1's loop over protected rows), and flushes aggregate with
staleness-damped weights (:mod:`.async_engine`), (c) the scan engine,
which runs blocks of R speculative rounds, each one captured CUDA graph
on the card with K1's loop and K2 inside it, and replays the float64
oracle once a block (:mod:`.scan_engine`), and (d) an opt-in process-wide
cache that shares captured client programs across servers. The pipelined
and async engines fan the cohort out over a client mesh with
``shard=True`` (:mod:`.sharding`: one block a shard position, each on its
own device, gathered on the server's).

Build through the registry::

    import repro_torch.fl as fl
    from repro_torch.fl.runtime import AsyncConfig, RuntimeConfig, ScanConfig

    server = fl.build("fedentropy", cnn.apply, params, corpus, config,
                      engine="pipelined",
                      runtime=RuntimeConfig(speculate=True),
                      aggregator=fl.FusedAverageAggregator(backend="cuda"))
    streaming = fl.build("fedentropy", cnn.apply, params, corpus, config,
                         runtime=AsyncConfig(clock="straggler",
                                             staleness_alpha=0.5))
    blocks = fl.build("fedentropy-traced", cnn.apply, params, corpus,
                      config, runtime=ScanConfig(rounds_per_scan=4))

With ``RuntimeConfig()`` defaults (no speculation) the pipelined engine is
the sequential ``Server``; with speculation on its history and params
still equal the sequential server's bit for bit
(tests/test_torch_engine.py). With ``AsyncConfig()`` defaults (K =
|cohort|, the zero clock, no damping) so does the async engine
(tests/test_torch_async.py), and so does the scan engine's, with blocks
of any R (tests/test_torch_scan.py).
"""
from .compile_cache import (
    ProcessCompileCache, disable_process_cache, enable_process_cache,
    process_cache,
)
from .engine import PipelinedServer, RuntimeConfig, SequentialEngine
from .async_engine import (
    ArrivalClock, AsyncBufferedServer, AsyncConfig, staleness_weights,
)
from .scan_engine import ScanConfig, ScanServer
from .sharding import (
    CLIENT_AXIS, ClientMesh, client_mesh_from, make_client_mesh,
    make_sharded_client_fn, pad_to_multiple,
)

__all__ = [
    "ArrivalClock", "AsyncBufferedServer", "AsyncConfig", "CLIENT_AXIS",
    "ClientMesh", "PipelinedServer", "ProcessCompileCache", "RuntimeConfig",
    "ScanConfig", "ScanServer", "SequentialEngine", "client_mesh_from",
    "disable_process_cache", "enable_process_cache", "make_client_mesh",
    "make_sharded_client_fn", "pad_to_multiple", "process_cache",
    "staleness_weights",
]
