"""The port's pipelined engine (``repro_torch.fl.runtime``).

On the ``tiny`` fixture of ``tests/test_fl_api.py`` (8 clients, 4 classes,
16x16 images) with the reference's params converted, on the CPU:

* ``PipelinedServer`` equals the port's sequential ``Server`` exactly
  (records, entropy and params to the bit) with speculation off and on,
  on both speculation backends (``"cuda"`` takes K1's plain version on
  CPU tensors, as every kernel wrapper does), on a forced miss, with
  ``BudgetedJudge``, with the queue and across a drift event;
* its ``spec_hit``/``redispatched`` flags equal those of the live
  reference's ``PipelinedServer(speculate=True, spec_backend="xla")``,
  whose integer records equal the port's;
* the engine registry and the process cache behave as the reference's.

The ``test_card_*`` cases need a card and skip without one: under
capture, round t+1's replay overwrites the graph's outputs, so the
speculative route must keep round t's before it dispatches; they hold it
bit for bit against the sequential server, with and without a forced
miss, and count K1's loop launches. They take the port's own init params
and import nothing of JAX (the reference is imported inside the CPU
cases), so they run where JAX is not installed::

    PYTHONPATH=src python -m pytest -q tests/test_torch_engine.py -k card
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.data.partition import (drift_schedule, partition,
                                        stack_clients)
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.runtime import (RuntimeConfig, disable_process_cache,
                                    enable_process_cache, process_cache)
from repro_torch.kernels.entropy_judge import (entropy_judge_loop,
                                               entropy_judge_sweep)
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.models import cnn as tcnn

ROUNDS = 4


def _split():
    """tests/test_fl_api.py's data (the port's numpy transcriptions draw
    the same arrays as repro's), with the raw split."""
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    return (xtr, ytr), stack_clients(xtr, ytr, parts, batch_multiple=20)


@pytest.fixture(scope="module")
def tiny():
    """The fixture with the reference's init params, converted."""
    jax = pytest.importorskip("jax")
    from repro.models import cnn as jcnn
    params = jcnn.init(jax.random.PRNGKey(0), image_hw=16, num_classes=4)
    return (*_split(), cnn_params_from_numpy(jax.tree.map(np.asarray,
                                                          params)))


@pytest.fixture(scope="module")
def tiny_card():
    """The fixture with the port's own init params (no JAX)."""
    return (*_split(), tcnn.init(torch.Generator().manual_seed(0),
                                 image_hw=16, num_classes=4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


def _build(tiny, name="fedentropy", device="cpu", **kw):
    _, data, params = tiny
    strategy = tfl.get("composition", name).strategy
    return tfl.build(name, tcnn.apply, params, data,
                     tfl.ServerConfig(num_clients=8, participation=0.5),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     device=device, **kw)


def _run(server, rounds=ROUNDS):
    for _ in range(rounds):
        server.round()
    return server


def _assert_equal(seq, pip, flags=False):
    """Records equal to the bit (apart from the speculation flags, which
    a speculative record must carry) and params and state equal."""
    assert len(seq.history) == len(pip.history)
    for a, b in zip(seq.history, pip.history):
        extra = {"spec_hit", "redispatched"} if flags else set()
        assert set(b) == set(a) | extra
        for key in a:
            if key == "entropy" and np.isnan(a[key]):
                assert np.isnan(b[key])
            else:
                assert b[key] == a[key], (a["round"], key)
        if flags:
            assert isinstance(b["spec_hit"], bool)
            assert isinstance(b["redispatched"], bool)
    assert (seq.state is None) == (pip.state is None)
    trees = [(seq.global_params, pip.global_params)]
    if seq.state is not None:
        trees.append((seq.state, pip.state))
    for a, b in trees:
        for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b),
                        strict=True):
            assert torch.equal(x, y)


class _WrongSpeculation(tfl.MaxEntropyJudge):
    """The oracle is the real maxent; the traced form admits everyone, so
    every round that rejects a device misses (the counterpart of
    tests/test_runtime_engine.py's ``_WrongSpeculationJudge``)."""

    def traced(self, backend=None):
        return tfl.PassThroughJudge().traced()


# ------------------------------------------------------- CPU, vs Server

@pytest.mark.parametrize("name", ["fedentropy", "moon", "scaffold"])
def test_speculation_off_equals_server(tiny, name):
    seq = _run(_build(tiny, name))
    pip = _run(_build(tiny, name, engine="pipelined"))
    _assert_equal(seq, pip)
    assert "spec_hit" not in pip.history[0]


@pytest.mark.parametrize("aggregator", ["weighted", "fused"])
@pytest.mark.parametrize("spec_backend", ["torch", "cuda"])
def test_speculation_on_equals_server_and_reference_flags(
        tiny, spec_backend, aggregator):
    agg = (tfl.FusedAverageAggregator(backend=spec_backend)
           if aggregator == "fused" else "weighted")
    seq = _run(_build(tiny, aggregator=agg))
    pip = _run(_build(tiny, aggregator=agg, runtime=RuntimeConfig(
        speculate=True, spec_backend=spec_backend)))
    _assert_equal(seq, pip, flags=True)
    assert any(r["negative"] for r in pip.history)      # judgment bites

    import jax
    import repro.fl as rfl
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
    from repro.models import cnn as jcnn
    _, data, _ = tiny
    params = jcnn.init(jax.random.PRNGKey(0), image_hw=16, num_classes=4)
    ref = rfl.build("fedentropy", jcnn.apply, params, data,
                    rfl.ServerConfig(num_clients=8, participation=0.5),
                    JLocalSpec(epochs=1, batch_size=20), engine="pipelined",
                    runtime=JRuntimeConfig(speculate=True,
                                           spec_backend="xla"))
    _run(ref)
    for want, got in zip(ref.history, pip.history, strict=True):
        for key in ("selected", "positive", "negative", "comm", "spec_hit",
                    "redispatched"):
            assert got[key] == want[key], (want["round"], key)


@pytest.mark.parametrize("name", ["fedentropy", "moon", "scaffold"])
def test_forced_miss_redispatches_and_equals_server(tiny, name):
    seq = _run(_build(tiny, name, judge=tfl.MaxEntropyJudge()))
    pip = _run(_build(tiny, name, judge=_WrongSpeculation(),
                      runtime=RuntimeConfig(speculate=True)))
    _assert_equal(seq, pip, flags=True)
    assert not all(r["spec_hit"] for r in pip.history)
    assert not pip.history[0]["redispatched"]
    for prev, rec in zip(pip.history, pip.history[1:]):
        assert rec["redispatched"] == (not prev["spec_hit"])
        assert prev["spec_hit"] == (not prev["negative"])


def test_budgeted_judge_keeps_the_pool_population(tiny):
    """An order-less traced judge re-files its rejects on a hit: every
    device not held by the pending selection is back in a pool."""
    seq = _run(_build(tiny, judge=tfl.BudgetedJudge(budget=2)), 3)
    pip = _run(_build(tiny, judge=tfl.BudgetedJudge(budget=2),
                      runtime=RuntimeConfig(speculate=True)), 3)
    _assert_equal(seq, pip, flags=True)
    for rec in pip.history:
        assert len(rec["positive"]) == 2 and len(rec["negative"]) == 2
    stats = pip.selector.stats()
    assert stats["positive"] + stats["negative"] == 8 - 4


def test_judge_without_traced_form_runs_sequentially(tiny):
    class Plain:
        on_host = True

        def __call__(self, soft, sizes):
            return list(range(len(sizes))), [], float("nan")

    seq = _run(_build(tiny, judge=Plain()), 2)
    pip = _run(_build(tiny, judge=Plain(),
                      runtime=RuntimeConfig(speculate=True)), 2)
    _assert_equal(seq, pip)
    assert pip._pending is None


@pytest.mark.parametrize("spec_backend", ["torch", "cuda"])
def test_queue_under_speculation_equals_server(tiny, spec_backend):
    seq = _run(_build(tiny, "fedentropy+queue"), 3)
    pip = _run(_build(tiny, "fedentropy+queue", runtime=RuntimeConfig(
        speculate=True, spec_backend=spec_backend)), 3)
    _assert_equal(seq, pip, flags=True)
    # the selector the server adopted is the copy that made the pending
    # selection: one select ahead of the sequential server's
    assert pip.selector.stats()["round"] == seq.selector.stats()["round"] + 1


@pytest.mark.parametrize("wrong", [False, True])
def test_drift_under_speculation_equals_server(tiny, wrong):
    (xtr, ytr), data, _ = tiny
    events = drift_schedule(xtr, ytr, 8, 4, at=2,
                            samples_per_client=int(data["y"].shape[1]))
    judge = _WrongSpeculation() if wrong else "maxent"
    seq = _build(tiny, drift=events, judge=judge)
    pip = _build(tiny, drift=events, judge=judge,
                 runtime=RuntimeConfig(speculate=True))
    for r in range(ROUNDS):
        seq.round()
        rec = pip.round()
        if r == 1:          # must not dispatch round 2 across the drift
            assert pip._pending is None and not pip._redispatch_next
        if r == 2:
            assert not rec["redispatched"]
    _assert_equal(seq, pip, flags=True)
    assert pip._drift == [] and pip.corpus is not seq.corpus
    for k, v in seq.corpus.as_numpy().items():
        np.testing.assert_array_equal(pip.corpus.as_numpy()[k], v)


# ------------------------------------------------------------ registry

def test_engine_registry(tiny):
    from repro_torch.fl.runtime import PipelinedServer, SequentialEngine
    assert tfl.get("engine", "pipelined") is PipelinedServer
    assert tfl.get("engine", "sequential") is SequentialEngine
    assert tfl.names("engine") == ["async", "pipelined", "scan",
                                   "sequential"]
    with pytest.raises(ValueError, match="unknown engine 'warp'.*"
                                         "pipelined.*scan.*sequential"):
        _build(tiny, engine="warp")
    assert isinstance(_build(tiny, engine="pipelined"), PipelinedServer)
    assert type(_build(tiny)) is tfl.Server
    s = _build(tiny, runtime=RuntimeConfig(speculate=True))
    assert isinstance(s, PipelinedServer) and s.runtime.speculate
    s2 = _build(tiny, engine="sequential", runtime=RuntimeConfig())
    assert isinstance(s2, SequentialEngine)
    with pytest.raises(ValueError, match="takes runtime=RuntimeConfig, "
                                         "got dict"):
        _build(tiny, engine="pipelined", runtime={"speculate": True})
    from repro.fl.runtime import RuntimeConfig as JRuntimeConfig
    with pytest.raises(ValueError, match="takes runtime=RuntimeConfig"):
        _build(tiny, runtime=JRuntimeConfig(speculate=True))
    with pytest.raises(ValueError, match="takes runtime=RuntimeConfig"):
        PipelinedServer(tcnn.apply, s.global_params, s.corpus, s.config,
                        selector=s.selector, strategy=s.strategy,
                        judge=s.judge, aggregator=s.aggregator,
                        runtime=JRuntimeConfig(), device="cpu")


def test_runtime_config_checks():
    assert RuntimeConfig().spec_backend == "cuda"
    assert RuntimeConfig(shard=False, donate_data=False).shard is False
    assert RuntimeConfig(shard=True).shard is True     # the client fan-out
    with pytest.raises(ValueError, match="shard must be"):
        RuntimeConfig(shard="yes")
    with pytest.raises(ValueError, match="shard must be"):
        RuntimeConfig(shard="everywhere")
    with pytest.raises(ValueError, match="unknown spec_backend 'xla'"):
        RuntimeConfig(spec_backend="xla")


@pytest.mark.parametrize("plane", ["stream", "streaming", "mmap"])
def test_data_plane(tiny, plane):
    """The reference's planes: "streaming" builds a ``HostCorpus``; any
    name outside ``PLANES`` raises."""
    from repro_torch.data.stream import HostCorpus
    assert _build(tiny, data_plane="resident").corpus.num_clients == 8
    if plane == "streaming":
        corpus = _build(tiny, data_plane=plane).corpus
        assert isinstance(corpus, HostCorpus) and corpus.num_clients == 8
    else:
        with pytest.raises(ValueError, match="unknown data plane"):
            _build(tiny, data_plane=plane)


# -------------------------------------------------------- process cache

def test_process_cache_shares_the_program_across_servers(tiny):
    assert process_cache() is None
    cache = enable_process_cache(maxsize=8)
    try:
        s1, s2 = _build(tiny), _build(tiny)
        s1.round()
        assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 0
        s2.round()
        assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 1
        assert len(s1._graphs) == 0 == len(s2._graphs)
        # another cohort size is another key
        s3 = _build(tiny)
        s3.config = tfl.ServerConfig(num_clients=8, participation=0.25)
        s3.round()
        assert cache.stats()["misses"] == 2
        # the speculative judge is cached there too
        p = _build(tiny, runtime=RuntimeConfig(speculate=True))
        p.round()
        assert ("spec-judge", p.judge, "cuda") in cache._entries
    finally:
        disable_process_cache()
    assert process_cache() is None
    s4 = _run(_build(tiny, runtime=RuntimeConfig(speculate=True)), 1)
    assert len(s4._graphs) == 1        # the judge, in its own LRU again


def test_process_cache_rebound_trims():
    cache = enable_process_cache(maxsize=4)
    try:
        for i in range(4):
            cache.get(("k", i), lambda i=i: i)
        assert len(cache) == 4
        cache2 = enable_process_cache(maxsize=2)
        assert cache2 is cache and len(cache) == 2
        assert list(cache._entries) == [("k", 2), ("k", 3)]
    finally:
        disable_process_cache()


# ------------------------------------------------------------- card only

def _launches():
    return {fn.__name__: fn.launches for fn in
            (entropy_judge_loop, entropy_judge_sweep, masked_weighted_sum)}


def _reset():
    for fn in (entropy_judge_loop, entropy_judge_sweep, masked_weighted_sum):
        fn.launches = 0


@pytest.mark.parametrize("wrong", [False, True])
@pytest.mark.parametrize("name", ["fedentropy", "moon", "scaffold"])
def test_card_speculation_under_capture_equals_sequential(cuda, tiny_card,
                                                          name, wrong):
    """Round t+1's replay overwrites the graph's outputs; a forced miss
    re-aggregates round t's client params after it, and moon and scaffold
    fold their state from them before the dispatch. Bit for bit with the
    sequential server on the same route (params and state), K1's loop
    once a speculated round and K2 once a round plus once a miss (scaffold
    keeps its leaf-wise average and server step: no K2)."""
    kw = dict(device="cuda")
    if name != "scaffold":
        kw["aggregator"] = tfl.FusedAverageAggregator(backend="cuda")
    judge = _WrongSpeculation if wrong else tfl.MaxEntropyJudge
    seq = _build(tiny_card, name, judge=judge(), **kw)
    pip = _build(tiny_card, name, judge=judge(),
                 runtime=RuntimeConfig(speculate=True), **kw)
    _run(seq)
    _reset()
    _run(pip)
    launches = _launches()
    _assert_equal(seq, pip, flags=True)
    misses = sum(not r["spec_hit"] for r in pip.history)
    k2 = 0 if name == "scaffold" else ROUNDS + misses
    assert launches == {"entropy_judge_loop": 0 if wrong else ROUNDS,
                        "entropy_judge_sweep": 0,
                        "masked_weighted_sum": k2}
    if wrong:
        assert misses > 0
    assert seq.graphs_captured == 1 == pip.graphs_captured


def test_card_queue_and_drift_under_capture(cuda, tiny_card):
    (xtr, ytr), data, _ = tiny_card
    events = drift_schedule(xtr, ytr, 8, 4, at=2,
                            samples_per_client=int(data["y"].shape[1]))
    for name, kw in (("fedentropy+queue", {}), ("fedentropy",
                                                {"drift": events})):
        seq = _run(_build(tiny_card, name, device="cuda", **kw))
        pip = _run(_build(tiny_card, name, device="cuda",
                          runtime=RuntimeConfig(speculate=True), **kw))
        _assert_equal(seq, pip, flags=True)
        assert pip.graphs_captured == 1      # drift keeps the signature


def test_card_process_cache_shares_one_graph(cuda, tiny_card):
    cache = enable_process_cache()
    try:
        s1 = _run(_build(tiny_card, device="cuda"), 2)
        s2 = _run(_build(tiny_card, device="cuda"), 2)
        assert (s1.graphs_captured, s2.graphs_captured) == (1, 0)
        assert cache.stats()["misses"] == 1
        _assert_equal(s1, s2)
    finally:
        disable_process_cache()
