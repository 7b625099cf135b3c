"""The async buffered engine in the port (``repro_torch.fl.runtime``
``AsyncBufferedServer``), with ``MaxEntropyJudge.admit`` and
``admit_candidates``, against the JAX package.

The ``tiny`` fixture of ``tests/test_async_engine.py`` (8 clients,
participation 0.5, 16x16 images, 4 classes, ``LocalSpec(epochs=1,
batch_size=20)``), on the CPU. The data comes from the port's numpy
transcriptions (the same arrays as the reference's); the params from
``repro``'s ``cnn.init``, converted.

Tolerances (the port's policy):

* ``staleness_weights``, ``ArrivalClock`` and ``admit_candidates``:
  exact (numpy in both packages);
* ``admit`` on ``"numpy"``: exact against the reference's numpy route;
  on the float32 routes (``"torch"``, and ``"cuda"``, which takes K1's
  plain version on the CPU): the same integers as the reference's xla
  route and its numpy route, entropy within 1e-6;
* the zero-clock reduction: equal to the port's ``Server`` bit for bit
  (records, entropy, params);
* the goldens (``tests/golden/async_history.json``, recorded with the
  pre-partitionable threefry, so the init params are drawn under
  ``jax.threefry_partitionable(False)``; ROADMAP F1): integer records,
  staleness, seq and flush times exact, entropy within 1e-6, params
  digest within a relative 1e-6;
* the live reference: integer records, staleness and seq exact, entropy
  within 1e-6, digest within a relative 1e-5.

The staleness property draws α from ``{0} ∪ [1e-3, 8]``: at α = 1.5e-151
``(1 + τ)^-α`` rounds to 1.0 for every τ, so the reference's own
property (strictly decreasing for any α > 0) is falsified at float64
resolution (ROADMAP F2).

The ``test_card_*`` case needs a card and skips without one; it takes the
port's own init params and imports nothing of JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_async.py -k card
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.data.partition import (drift_schedule, partition,
                                        stack_clients)
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.judges import admit_candidates
from repro_torch.fl.runtime import (ArrivalClock, AsyncBufferedServer,
                                    AsyncConfig, RuntimeConfig,
                                    staleness_weights)
from repro_torch.kernels.entropy_judge import (entropy_judge_loop,
                                               entropy_judge_sweep)
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.models import cnn as tcnn

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # the property cases skip without hypothesis
    given = None

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "async_history.json")
_VARIANTS = {"fedentropy": ("fedentropy", AsyncConfig()),
             "fedavg_uniform": ("fedavg", AsyncConfig()),
             "fedentropy_straggler": ("fedentropy", AsyncConfig(
                 clock="straggler", latency_scale=1.0, straggler_frac=0.25,
                 straggler_factor=8.0, staleness_alpha=0.5, seed=0))}
STRAGGLER = _VARIANTS["fedentropy_straggler"][1]
ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-6
LIVE_DIGEST_RTOL = 1e-5
FLUSHES = 3


def _split():
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    return (xtr, ytr), stack_clients(xtr, ytr, parts, batch_multiple=20)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (imported here, so the card case runs
    where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import repro.fl as rfl
    import repro.fl.judges as rjudges
    import repro.fl.runtime as rrt
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.models import cnn as jcnn
    return SimpleNamespace(jax=jax, fl=rfl, judges=rjudges, rt=rrt,
                           cnn=jcnn, LocalSpec=JLocalSpec)


@pytest.fixture(scope="module")
def tiny(ref):
    """The data and the reference's init params as the installed JAX
    draws them (numpy), for the live-reference cases."""
    params = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                          num_classes=4)
    return _split(), ref.jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_golden(ref):
    """The data and the init params the goldens were recorded with (F1:
    drawn under the pre-partitionable threefry)."""
    with ref.jax.threefry_partitionable(False):
        params = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                              num_classes=4)
    return _split(), ref.jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_card():
    """The data with the port's own init params (no JAX)."""
    return _split(), tcnn.init(torch.Generator().manual_seed(0),
                               image_hw=16, num_classes=4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


def _params(tree):
    if isinstance(tree["conv1"]["w"], torch.Tensor):
        return tree
    return cnn_params_from_numpy(tree)


def _build(case, name="fedentropy", device="cpu", seed=0, **kw):
    (_, data), params = case
    return tfl.build(name, tcnn.apply, _params(params), data,
                     tfl.ServerConfig(num_clients=8, participation=0.5,
                                      seed=seed),
                     tfl.LocalSpec(epochs=1, batch_size=20), device=device,
                     **kw)


def _run(server, rounds=FLUSHES):
    for _ in range(rounds):
        server.round()
    return server


def _digest(params) -> float:
    return sum(float(x.abs().sum()) for x in pytree.tree_leaves(params))


def _same(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and np.isnan(a) and np.isnan(b))


def _assert_equal(a, b, keys=None):
    """Servers ``a`` and ``b``: records equal to the bit on ``keys`` (by
    default every key of ``a``'s records) and params equal bit for bit."""
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        for key in (keys or x):
            assert _same(x[key], y[key]), (x["round"], key)
    for p, q in zip(pytree.tree_leaves(a.global_params),
                    pytree.tree_leaves(b.global_params), strict=True):
        assert torch.equal(p, q)


def _assert_ent(got, want):
    want = float(want)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(want, abs=ENT_ATOL)


# ------------------------------------------------- numpy transcriptions

@pytest.mark.parametrize("alpha", [0.0, 1e-3, 0.5, 1.0, 3.7])
def test_staleness_weights_match_reference(ref, alpha):
    tau = np.asarray([0, 1, 1, 2, 5, 9, 50])
    np.testing.assert_array_equal(staleness_weights(tau, alpha),
                                  ref.rt.staleness_weights(tau, alpha))
    with pytest.raises(ValueError, match=">= 0"):
        staleness_weights([-1], alpha)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("clock", ["zero", "uniform", "straggler"])
def test_arrival_clock_matches_reference(ref, clock, seed):
    kw = dict(clock=clock, latency_scale=2.0, straggler_frac=0.25,
              straggler_factor=16.0, seed=seed)
    got = ArrivalClock(AsyncConfig(**kw), 8)
    want = ref.rt.ArrivalClock(ref.rt.AsyncConfig(**kw), 8)
    np.testing.assert_array_equal(got.latency, want.latency)
    for client in range(8):
        assert got.arrival(client, 5.0) == want.arrival(client, 5.0)


def test_async_config_validation():
    for bad in (dict(clock="warp"), dict(buffer_size=-1),
                dict(staleness_alpha=-0.1), dict(latency_scale=-1.0),
                dict(straggler_frac=1.5), dict(straggler_factor=0.5),
                dict(concurrency=-2), dict(shard="everywhere")):
        with pytest.raises(ValueError):
            AsyncConfig(**bad)
    for bad in ("yes", "everywhere"):
        with pytest.raises(ValueError, match="shard must be"):
            AsyncConfig(shard=bad)
    assert AsyncConfig(shard=True).shard is True       # the client fan-out
    AsyncConfig(shard=False, donate_data=False)


# ------------------------------------------------------ admission layer

def _skewed_soft(seed=0):
    """4 near-one-hot class signatures and sizes: a class-0-heavy group
    (the reference's own admission fixture)."""
    rng = np.random.default_rng(seed)
    eye = np.eye(4)
    soft = 0.9 * eye[[0, 0, 0, 1]] + 0.1 * rng.dirichlet(np.ones(4), 4)
    return soft, np.full(4, 10.0)


def _admission_case(seed: int):
    """A random buffer of 0-4 rows and 2-6 candidates over 10 classes:
    Dirichlet(0.3) rows, a few duplicated outliers, integer sizes."""
    rng = np.random.default_rng(1000 + seed)
    nb, nc = seed % 5, 2 + seed % 5
    soft = rng.dirichlet(np.full(10, 0.3), size=nb + nc)
    soft[-1] = soft[0]
    sizes = rng.integers(20, 500, nb + nc).astype(np.float64)
    return soft[:nb], sizes[:nb], soft[nb:], sizes[nb:]


@pytest.mark.parametrize("seed", range(10))
def test_admit_matches_reference(ref, seed):
    """``admit`` on every backend against the reference's numpy and xla
    ``admit`` on the same random buffers with protected rows."""
    args = _admission_case(seed)
    want_np = ref.fl.MaxEntropyJudge("numpy").admit(*args)
    want_xla = ref.fl.MaxEntropyJudge("xla").admit(*args)
    assert want_np[:2] == want_xla[:2]
    got = tfl.MaxEntropyJudge("numpy").admit(*args)
    assert got[:2] == want_np[:2]
    assert _same(got[2], want_np[2])
    for backend in ("torch", "cuda"):
        got = tfl.MaxEntropyJudge(backend).admit(*args)
        assert got[:2] == want_xla[:2], backend
        assert got[2] == pytest.approx(want_np[2], abs=ENT_ATOL)
        assert got[2] == pytest.approx(want_xla[2], abs=ENT_ATOL)


def test_admit_protects_buffered_rows(ref):
    """A buffer row the plain joint judgment would remove stays: only
    candidates are judged, as in the reference."""
    soft, sizes = _skewed_soft()
    judge = tfl.MaxEntropyJudge()
    plain_a, plain_r, _ = judge(torch.from_numpy(soft),
                                torch.from_numpy(sizes))
    assert plain_r
    buf = [plain_r[0], plain_a[0]]
    cand = [i for i in range(4) if i not in buf]
    for backend in ("numpy", "torch", "cuda"):
        a, r, ent = tfl.MaxEntropyJudge(backend).admit(
            soft[buf], sizes[buf], soft[cand], sizes[cand])
        assert sorted(a + r) == [0, 1]
        want = ref.fl.MaxEntropyJudge().admit(soft[buf], sizes[buf],
                                              soft[cand], sizes[cand])
        assert (a, r) == want[:2]
        assert np.isfinite(ent)


@pytest.mark.parametrize("backend", ["numpy", "torch", "cuda"])
def test_admit_empty_buffer_is_round_judgment(backend):
    soft, sizes = _skewed_soft()
    judge = tfl.MaxEntropyJudge(backend)
    want = judge(torch.from_numpy(soft).float(),
                 torch.from_numpy(sizes).float()) \
        if backend != "numpy" else judge(torch.from_numpy(soft),
                                         torch.from_numpy(sizes))
    got = judge.admit(np.zeros((0, 4)), np.zeros((0,)), soft, sizes)
    assert got == want


@pytest.mark.parametrize("nb", [0, 2])
@pytest.mark.parametrize("judge", ["none", "maxent"])
def test_admit_candidates_matches_reference(ref, judge, nb):
    soft, sizes = _skewed_soft()
    args = (soft[:nb], sizes[:nb], soft[nb:], sizes[nb:])
    got = admit_candidates(tfl.get("judge", judge)(), *args)
    want = ref.judges.admit_candidates(ref.fl.get("judge", judge)(), *args)
    assert got[:2] == want[:2]
    assert _same(got[2], want[2])


# ----------------------------------------------------------- reduction

@pytest.mark.parametrize("route", ["kernels", "leafwise"])
@pytest.mark.parametrize("name", ["fedentropy", "fedavg"])
def test_zero_clock_reduces_to_server(tiny, name, route):
    """``AsyncConfig()`` defaults: the port's ``Server`` bit for bit, on
    the leaf-wise route and on K1's loop and K2 (their plain versions on
    the CPU)."""
    kw = {}
    if route == "kernels":
        kw = {"aggregator": tfl.FusedAverageAggregator(backend="cuda")}
        if name == "fedentropy":
            kw["judge"] = tfl.MaxEntropyJudge(backend="cuda")
    seq = _run(_build(tiny, name, **kw))
    asy = _build(tiny, name, runtime=AsyncConfig(), **kw)
    assert isinstance(asy, AsyncBufferedServer)
    _run(asy)
    _assert_equal(seq, asy)
    for rec in asy.history:
        assert rec["staleness"] == [0] * len(rec["selected"])
        assert rec["flush_time"] == 0.0
        assert rec["buffer_occupancy"] == len(rec["positive"])


@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_reproduces_async_golden(tiny_golden, variant):
    with open(GOLDEN) as f:
        golden = json.load(f)[variant]
    name, runtime = _VARIANTS[variant]
    server = _run(_build(tiny_golden, name, runtime=runtime),
                  len(golden["history"]))
    for got, want in zip(server.history, golden["history"], strict=True):
        for key in ("selected", "positive", "negative", "staleness", "seq",
                    "admitted_seq"):
            assert got[key] == want[key], (want["round"], key)
        assert got["comm"]["total_bytes"] == want["total_bytes"]
        assert got["flush_time"] == float(want["flush_time"])
        _assert_ent(got["entropy"], want["entropy"])
    assert _digest(server.global_params) == pytest.approx(
        float(golden["params_digest"]), rel=DIGEST_RTOL)
    if variant == "fedentropy_straggler":
        assert any(max(r["staleness"]) > 0 for r in server.history)


def test_straggler_matches_live_reference(ref, tiny):
    (_, data), params = tiny
    live = ref.fl.build("fedentropy", ref.cnn.apply, params, data,
                        ref.fl.ServerConfig(num_clients=8, participation=0.5,
                                            seed=0),
                        ref.LocalSpec(epochs=1, batch_size=20),
                        engine="async", runtime=ref.rt.AsyncConfig(
                            clock="straggler", latency_scale=1.0,
                            straggler_frac=0.25, straggler_factor=8.0,
                            staleness_alpha=0.5, seed=0))
    port = _build(tiny, runtime=STRAGGLER)
    for _ in range(FLUSHES):
        want, got = live.round(), port.round()
        for key in ("selected", "positive", "negative", "comm", "staleness",
                    "seq", "admitted_seq", "flush_time",
                    "buffer_occupancy", "inflight"):
            assert got[key] == want[key], (want["round"], key)
        _assert_ent(got["entropy"], want["entropy"])
    want_digest = sum(float(np.abs(np.asarray(x)).sum())
                      for x in ref.jax.tree.leaves(live.global_params))
    assert _digest(port.global_params) == pytest.approx(
        want_digest, rel=LIVE_DIGEST_RTOL)


# ------------------------------------------------------ stream behaviour

def test_flushes_partition_admitted_updates(tiny):
    server = _run(_build(tiny, runtime=STRAGGLER), 4)
    seen: set = set()
    for rec in server.history:
        batch = set(rec["seq"])
        assert len(batch) == len(rec["seq"])
        assert not (batch & seen)
        assert set(rec["admitted_seq"]) <= batch
        assert len(rec["admitted_seq"]) == len(rec["positive"])
        assert len(rec["selected"]) >= server.buffer_size
        seen |= batch


def test_straggler_run_is_deterministic(tiny_card):
    """No wall clock anywhere: two identical builds stream identically,
    bit for bit."""
    _assert_equal(_run(_build(tiny_card, runtime=STRAGGLER), 2),
                  _run(_build(tiny_card, runtime=STRAGGLER), 2))


class _StalenessAwareSelector(tfl.PoolSelector):
    """A selector that opts into the per-arrival staleness feed."""

    def __init__(self, num_clients, eps=0.8, seed=0):
        super().__init__(num_clients, eps, seed)
        self.seen: list = []

    def observe_staleness(self, arrivals):
        self.seen.append(arrivals)


def test_selector_staleness_feedback(tiny):
    hook = _StalenessAwareSelector(8)
    server = _run(_build(tiny, runtime=STRAGGLER, selector=hook))
    plain = _run(_build(tiny, runtime=STRAGGLER))
    assert len(hook.seen) == FLUSHES
    for batch, rec in zip(hook.seen, server.history):
        assert [e["client"] for e in batch] == rec["selected"]
        assert [e["staleness"] for e in batch] == rec["staleness"]
        admitted = [e["client"] for e in batch if e["admitted"]]
        assert sorted(admitted) == sorted(rec["positive"])
    _assert_equal(plain, server)


def test_buffer_size_knob_and_passthrough(tiny):
    zero = _build(tiny, runtime=AsyncConfig(buffer_size=2))
    assert zero.buffer_size == 2
    assert len(zero.round()["selected"]) == 4     # a whole cohort ties
    strag = _build(tiny, runtime=AsyncConfig(
        buffer_size=2, clock="straggler", latency_scale=1.0,
        straggler_frac=0.25, straggler_factor=8.0, seed=0))
    assert len(strag.round()["selected"]) == 2
    rec = _build(tiny, "fedavg", runtime=STRAGGLER).round()
    assert rec["positive"] == rec["selected"] and rec["negative"] == []
    assert np.isnan(rec["entropy"])


# ------------------------------------------------------------- refusals

def test_refusals(tiny):
    (split, data), params = tiny
    with pytest.raises(ValueError, match="prepare_round"):
        _build(tiny, "fedcat+maxent", runtime=AsyncConfig())
    with pytest.raises(ValueError, match="ModelBank"):
        tfl.build("ifca+maxent", tcnn.apply, _params(params), data,
                  tfl.ServerConfig(num_clients=8, participation=0.5,
                                   num_clusters=3),
                  tfl.LocalSpec(epochs=1, batch_size=20), device="cpu",
                  runtime=AsyncConfig())
    events = drift_schedule(*split, 8, 4, at=2, seed=0,
                            samples_per_client=int(data["y"].shape[1]))
    with pytest.raises(ValueError, match="drift"):
        _build(tiny, runtime=AsyncConfig(), drift=events)


def test_engine_runtime_mismatches_error_loudly(tiny):
    assert "async" in tfl.names("engine")
    assert tfl.get("engine", "async") is AsyncBufferedServer
    with pytest.raises(ValueError, match="unknown engine 'warp'"):
        _build(tiny, engine="warp")
    with pytest.raises(ValueError, match="AsyncBufferedServer takes"):
        _build(tiny, engine="async", runtime=RuntimeConfig())
    with pytest.raises(ValueError, match="PipelinedServer takes"):
        _build(tiny, engine="pipelined", runtime=AsyncConfig())
    with pytest.raises(ValueError, match="SequentialEngine takes"):
        _build(tiny, engine="sequential", runtime=AsyncConfig())
    (_, data), params = tiny
    with pytest.raises(ValueError, match="runtime=AsyncConfig"):
        AsyncBufferedServer(
            tcnn.apply, _params(params), data,
            tfl.ServerConfig(num_clients=8, participation=0.5),
            runtime=RuntimeConfig(), selector=tfl.PoolSelector(8),
            strategy=tfl.FedAvgStrategy(tfl.LocalSpec(epochs=1,
                                                      batch_size=20)),
            judge=tfl.MaxEntropyJudge(),
            aggregator=tfl.WeightedAverageAggregator(), device="cpu")
    routed = _build(tiny, runtime=AsyncConfig(buffer_size=3))
    assert isinstance(routed, AsyncBufferedServer)
    assert routed.buffer_size == 3


# ------------------------------------------------------------ properties

if given is not None:
    @given(tau=st.lists(st.integers(min_value=0, max_value=50), min_size=1,
                        max_size=16),
           alpha=st.one_of(st.just(0.0),
                           st.floats(min_value=1e-3, max_value=8.0)))
    @settings(max_examples=100, deadline=None, database=None)
    def test_staleness_weights_monotone_and_uniform_at_zero(ref, tau,
                                                            alpha):
        order = np.sort(np.asarray(tau))
        w = staleness_weights(order, alpha)
        np.testing.assert_array_equal(w, ref.rt.staleness_weights(order,
                                                                  alpha))
        assert np.all(w > 0) and np.all(w <= 1.0)
        assert np.all(np.diff(w) <= 0)
        np.testing.assert_array_equal(staleness_weights(order, 0.0), 1.0)
        if alpha > 0:
            inc = np.diff(order) > 0
            assert np.all(np.diff(w)[inc] < 0)

    @given(seed=st.integers(min_value=0, max_value=10_000),
           clock=st.sampled_from(["uniform", "straggler"]),
           buffer_size=st.sampled_from([0, 2, 3]))
    @settings(max_examples=4, deadline=None, database=None)
    def test_each_admitted_update_in_exactly_one_flush(tiny_card,
                                                       seed, clock,
                                                       buffer_size):
        server = _run(_build(tiny_card, seed=seed, runtime=AsyncConfig(
            buffer_size=buffer_size, clock=clock, latency_scale=1.0,
            straggler_frac=0.25, straggler_factor=8.0, staleness_alpha=0.5,
            seed=seed)))
        seen: set = set()
        for rec in server.history:
            batch = set(rec["seq"])
            assert len(batch) == len(rec["seq"])
            assert not (batch & seen)
            assert set(rec["admitted_seq"]) <= batch
            assert len(rec["admitted_seq"]) == len(rec["positive"])
            assert len(rec["selected"]) >= server.buffer_size
            seen |= batch

    @given(seed=st.integers(min_value=0, max_value=10_000))
    @settings(max_examples=4, deadline=None, database=None)
    def test_zero_staleness_reduction_across_seeds(tiny_card, seed):
        seq = _run(_build(tiny_card, seed=seed), 2)
        asy = _run(_build(tiny_card, seed=seed,
                          runtime=AsyncConfig()), 2)
        _assert_equal(seq, asy)
else:
    @pytest.mark.skip(reason="hypothesis is not installed")
    def test_staleness_weights_monotone_and_uniform_at_zero():
        pass

    @pytest.mark.skip(reason="hypothesis is not installed")
    def test_each_admitted_update_in_exactly_one_flush():
        pass

    @pytest.mark.skip(reason="hypothesis is not installed")
    def test_zero_staleness_reduction_across_seeds():
        pass


# ------------------------------------------------------------------ card

_WRAPPERS = (entropy_judge_loop, entropy_judge_sweep, masked_weighted_sum)


def _launches():
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def test_card_straggler_captured_equals_eager(cuda, tiny_card):
    """The straggler run with the client program captured equals the same
    run under ``disable_capture()`` bit for bit: every dispatch's outputs
    are cloned before a later dispatch's replay overwrites them. K1's
    loop judges every screened batch, over a protected buffer on all but
    a flush's first; K2 aggregates each flush once."""
    kw = dict(judge=tfl.MaxEntropyJudge(backend="cuda"),
              aggregator=tfl.FusedAverageAggregator(backend="cuda"),
              runtime=STRAGGLER, device="cuda")
    cap = _build(tiny_card, **kw)
    screens = []
    inner = cap._screen

    def screen(batch):
        screens.append(len(cap._buffer))
        inner(batch)

    cap._screen = screen
    for fn in _WRAPPERS:
        fn.launches = 0
    _run(cap)
    assert _launches() == {"entropy_judge_loop": len(screens),
                           "entropy_judge_sweep": 0,
                           "masked_weighted_sum": FLUSHES}
    assert sum(n > 0 for n in screens) > 0     # K1 over protected rows
    with tfl.disable_capture():
        eager = _run(_build(tiny_card, **kw))
    _assert_equal(eager, cap)
    assert any(max(r["staleness"]) > 0 for r in cap.history)
    assert (cap.graphs_captured, eager.graphs_captured) == (1, 0)
