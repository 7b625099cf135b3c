"""String registry for FL components and named compositions.

Compositions name one component per axis of the round::

    server = repro_torch.fl.build("fedentropy", cnn.apply, params, corpus,
                                  ServerConfig(num_clients=100))

Built-in component classes expose ``from_config(config, local)``; entries
without it are constructed with no arguments. Passing an
already-constructed instance to :func:`build` bypasses the registry for
that axis. This package registers the ``fedentropy``,
``fedentropy-traced``, ``fedavg``, ``fedprox``, ``moon``, ``scaffold``,
``fedcat``, ``fedcat+maxent``, ``fedentropy+queue``, ``ifca``,
``ifca+maxent`` and ``fesem`` compositions and the ``sequential``,
``pipelined``, ``async`` and ``scan`` engines; any other name raises
``KeyError``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

KINDS = ("selector", "strategy", "judge", "aggregator", "cluster",
         "composition", "engine")

_REGISTRY: dict[str, dict[str, Any]] = {k: {} for k in KINDS}


@dataclass(frozen=True)
class Composition:
    """One component name per axis of the round. ``cluster`` (optional,
    a fifth axis) names a :mod:`repro_torch.fl.clusters` assigner: the
    composition then runs a K-center ``ModelBank``
    (``ServerConfig.num_clusters``) with judgment and aggregation per
    cluster; ``None`` keeps the single global model."""
    strategy: str = "fedavg"
    selector: str = "uniform"
    judge: str = "none"
    aggregator: str = "weighted"
    cluster: str | None = None


def register(kind: str, name: str, obj: Any = None):
    """Register ``obj`` under (kind, name); usable as a decorator."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")

    def _do(o):
        _REGISTRY[kind][name] = o
        return o

    return _do if obj is None else _do(obj)


def get(kind: str, name: str) -> Any:
    try:
        return _REGISTRY[kind][name]
    except KeyError:
        known = ", ".join(sorted(_REGISTRY.get(kind, ()))) or "<none>"
        raise KeyError(
            f"no {kind} registered under {name!r}; known: {known}") from None


def names(kind: str) -> list[str]:
    return sorted(_REGISTRY[kind])


def _instantiate(kind: str, spec: Any, config, local):
    """Resolve a component: instance pass-through, or name -> class -> obj."""
    if not isinstance(spec, str):
        return spec
    entry = get(kind, spec)
    if hasattr(entry, "from_config"):
        return entry.from_config(config=config, local=local)
    return entry()


def build(name: str, apply_fn, init_params, client_data, config,
          local=None, *, selector=None, strategy=None, judge=None,
          aggregator=None, cluster=None, engine=None, runtime=None,
          data_plane="auto", drift=None, device="cuda", mesh=None):
    """Construct a server (an *engine*) from a composition name.

    ``selector``/``strategy``/``judge``/``aggregator`` override single
    axes of the named recipe — each takes a registered name or a
    ready-made instance::

        build("fedentropy", ..., judge=MaxEntropyJudge(backend="cuda"),
              aggregator=FusedAverageAggregator(backend="cuda"))

    ``engine`` picks the round driver: the sequential
    :class:`repro_torch.fl.Server` by default, ``"sequential"`` (the same
    under the engine registry), ``"pipelined"``
    (:class:`repro_torch.fl.runtime.PipelinedServer`, on-device verdict
    speculation), ``"async"``
    (:class:`repro_torch.fl.runtime.AsyncBufferedServer`, streaming
    buffered rounds) or ``"scan"``
    (:class:`repro_torch.fl.runtime.ScanServer`, blocks of R rounds, one
    CUDA graph each); ``runtime`` passes it its config, a
    :class:`repro_torch.fl.runtime.RuntimeConfig` for sequential and
    pipelined, an :class:`repro_torch.fl.runtime.AsyncConfig` for async,
    a :class:`repro_torch.fl.runtime.ScanConfig` for scan. A ``runtime``
    without an ``engine`` implies the engine the config belongs to
    (RuntimeConfig: ``"pipelined"``, AsyncConfig: ``"async"``,
    ScanConfig: ``"scan"``); an unknown engine name raises
    ``ValueError`` listing the registered names, and a runtime of the
    wrong type for the engine raises here::

        build("fedentropy", ..., engine="pipelined",
              runtime=RuntimeConfig(speculate=True))
        build("fedentropy", ..., runtime=AsyncConfig(clock="straggler"))
        build("fedentropy-traced", ..., runtime=ScanConfig(rounds_per_scan=4))

    ``cluster`` overrides the composition's cluster assigner (a name or
    an instance); with ``ServerConfig.num_clusters`` > 1 the engine then
    carries a K-center ``ModelBank``.

    ``data_plane`` picks where the client data lives
    (:func:`repro_torch.data.stream.as_data_plane`): ``"resident"`` (a
    ``ClientCorpus`` on the device), ``"streaming"`` (a ``HostCorpus`` on
    the host, one cohort uploaded a round, staged ahead by the pipelined
    engine's speculation) or ``"auto"`` (the default: a built corpus keeps
    its plane, a stacked dict streams once its storage bytes exceed 1 GiB,
    as in the reference). ``drift`` is a list of
    :class:`repro_torch.data.partition.DriftEvent`. ``device`` is where
    the params, the corpus and the round's tensor work live; it defaults
    to the card and raises when there is none. ``mesh`` (pipelined and
    async engines) is the client mesh ``shard=True`` fans the cohort out
    over (:class:`repro_torch.fl.runtime.ClientMesh` or a sequence of
    devices; default every visible card); its first device is ``device``.
    """
    from ..core.strategies import LocalSpec
    from . import runtime as _runtime  # registers engines
    from .server import Server

    comp = get("composition", name)
    local = local if local is not None else LocalSpec()
    strat = _instantiate("strategy", strategy or comp.strategy, config, local)
    if engine is None:
        # a runtime config without a named engine must not silently drop
        # its knobs: route to the engine it configures
        if runtime is None:
            engine_cls = Server
        elif isinstance(runtime, _runtime.AsyncConfig):
            engine_cls = get("engine", "async")
        elif isinstance(runtime, _runtime.ScanConfig):
            engine_cls = get("engine", "scan")
        else:
            engine_cls = get("engine", "pipelined")
    elif isinstance(engine, str):
        try:
            engine_cls = get("engine", engine)
        except KeyError:
            raise ValueError(
                f"unknown engine {engine!r}; registered engines: "
                f"{', '.join(names('engine'))}") from None
    else:
        engine_cls = engine
    expected = getattr(engine_cls, "runtime_cls", None)
    if runtime is not None and expected is not None \
            and not isinstance(runtime, expected):
        raise ValueError(
            f"engine {engine_cls.__name__} takes runtime="
            f"{expected.__name__}, got {type(runtime).__name__} "
            "(RuntimeConfig drives sequential/pipelined, AsyncConfig "
            "drives async, ScanConfig drives scan)")
    kwargs = {}
    if runtime is not None:
        kwargs["runtime"] = runtime
    if data_plane != "auto":
        kwargs["data_plane"] = data_plane
    # the optional cluster axis: a named or given ClusterAssigner makes
    # the engine carry a K-center ModelBank (K = config.num_clusters;
    # K = 1 is the single-model path exactly)
    cl = cluster if cluster is not None else comp.cluster
    if cl is not None:
        kwargs["cluster"] = _instantiate("cluster", cl, config, local)
    if drift is not None:
        kwargs["drift"] = drift
    if mesh is not None:
        kwargs["mesh"] = mesh
    return engine_cls(
        apply_fn, init_params, client_data, config,
        selector=_instantiate("selector", selector or comp.selector,
                              config, local),
        strategy=strat,
        judge=_instantiate("judge", judge or comp.judge, config, local),
        aggregator=_instantiate("aggregator", aggregator or comp.aggregator,
                                config, strat.spec),
        device=device, **kwargs,
    )


# ---- built-in composition recipes (paper Tables 1-3) --------------------
register("composition", "fedentropy",
         Composition(strategy="fedavg", selector="pools", judge="maxent"))
# fedentropy with the pools drawn on JAX's threefry stream: the same Alg. 2
# semantics, drawn by a tensor function the scan engine folds into its
# block (engine="scan" runs R > 1 rounds per graph); the same cohorts as
# the reference's "fedentropy-traced", not as the numpy "pools" stream
register("composition", "fedentropy-traced",
         Composition(strategy="fedavg", selector="pools-traced",
                     judge="maxent"))
register("composition", "fedavg", Composition(strategy="fedavg"))
register("composition", "fedprox", Composition(strategy="fedprox"))
register("composition", "moon", Composition(strategy="moon"))
register("composition", "scaffold",
         Composition(strategy="scaffold", aggregator="scaffold"))
# FedCAT (arXiv 2202.12751): entropy-grouped device chains, concatenation
# merge; "+maxent" filters chain membership with the paper's judgment
# before concatenation (the FedEntropy-synergy variant).
register("composition", "fedcat",
         Composition(strategy="catchain", selector="catgroups",
                     judge="none", aggregator="devconcat"))
register("composition", "fedcat+maxent",
         Composition(strategy="catchain", selector="catgroups-pools",
                     judge="maxent", aggregator="devconcat"))
# Dynamic-data-queue participant selection (arXiv 2410.17792): clients
# ranked by label entropy off the corpus stats, each round releasing a
# growing prefix of the local dataset; judgment stays the paper's maxent.
register("composition", "fedentropy+queue",
         Composition(strategy="fedavg", selector="queue", judge="maxent"))
# Clustered FL (the K-center ModelBank axis; K = ServerConfig.num_clusters):
# "ifca" is the loss-based assignment baseline (every update admitted),
# "fesem" the weight-distance alternation, and "ifca+maxent" runs the
# paper's max-entropy judgment WITHIN each cluster; at K=1 it is exactly
# "fedentropy" (perclstr passes through to weighted).
register("composition", "ifca",
         Composition(strategy="fedavg", selector="uniform", judge="none",
                     aggregator="perclstr", cluster="ifca"))
register("composition", "ifca+maxent",
         Composition(strategy="fedavg", selector="pools", judge="maxent",
                     aggregator="perclstr", cluster="ifca"))
register("composition", "fesem",
         Composition(strategy="fedavg", selector="uniform", judge="none",
                     aggregator="perclstr", cluster="fesem"))
