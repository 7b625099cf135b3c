"""``repro_torch.fl.runtime`` — the round engines beyond the sequential
``Server``, on one card.

The same four composition axes as :class:`repro_torch.fl.Server`, driven
by (a) the pipelined engine, which overlaps the host-side float64
judgment oracle with the next round's client compute by speculating the
verdict on the device (K1's loop with ``spec_backend="cuda"``), and (b)
an opt-in process-wide cache that shares captured client programs across
servers.

Build through the registry::

    import repro_torch.fl as fl
    from repro_torch.fl.runtime import RuntimeConfig

    server = fl.build("fedentropy", cnn.apply, params, corpus, config,
                      engine="pipelined",
                      runtime=RuntimeConfig(speculate=True),
                      aggregator=fl.FusedAverageAggregator(backend="cuda"))

With ``RuntimeConfig()`` defaults (no speculation) the pipelined engine is
the sequential ``Server``; with speculation on its history and params
still equal the sequential server's bit for bit
(tests/test_torch_engine.py).
"""
from .compile_cache import (
    ProcessCompileCache, disable_process_cache, enable_process_cache,
    process_cache,
)
from .engine import PipelinedServer, RuntimeConfig, SequentialEngine

__all__ = [
    "PipelinedServer", "ProcessCompileCache", "RuntimeConfig",
    "SequentialEngine", "disable_process_cache", "enable_process_cache",
    "process_cache",
]
