"""Clustered FL in the port: the K-center ``ModelBank`` axis
(``repro_torch.fl.clusters``), the ``perclstr`` aggregator and the
clustered rounds of the sequential and pipelined servers, against the JAX
package.

The ``tiny`` fixture of ``tests/test_cluster_engine.py`` (8 clients,
participation 0.5, 16x16 images, 4 classes, ``LocalSpec(epochs=1,
batch_size=20)``), on the CPU. The data comes from the port's numpy
transcriptions (the same arrays as the reference's); the params from
``repro``'s ``cnn.init``, converted.

The bank's jitter is the port's own stream (a seeded ``torch.Generator``:
``jax.random.fold_in`` cannot be matched), so every comparison with the
reference draws the bank with the reference and assigns it to the port's
server before round 0 (``_adopt_bank``: ``server.bank = ...``,
``server.global_params = server.bank.stacked``). That is a test seam, not
a knob.

Tolerances (the port's policy):

* ``argmin_assign``, ``ModelBank.gather`` and ``center`` on the
  reference's bank, and FeSEM's seeded init: exact;
* IFCA's (K, m) losses within 1e-5 of the reference's on the reference's
  bank (the smallest margin between the best and the second-best center
  is printed: a margin below the float32 gap between the two frameworks
  would flip an assignment);
* ``perclstr`` within 1e-6 of the reference's (float32 sums over the
  client axis in another order); an empty cluster keeps its center bit
  for bit; without a ``"cluster"`` key it is its base aggregator exactly;
* ``ifca+maxent`` at K = 1: the port's ``fedentropy`` bit for bit;
* the golden (``tests/golden/cluster_history.json``,
  ``ifca_maxent_k3_drift``, recorded with the pre-partitionable threefry:
  init params and bank drawn under ``jax.threefry_partitionable(False)``;
  ROADMAP F1): integer records, cluster ids, per-cluster verdicts and the
  ``"drift"`` field exact, entropy within 1e-6, bank digest within a
  relative 1e-6;
* the live reference: the same integers exact, entropy within 1e-6,
  digest within a relative 1e-5;
* pipelined against sequential in the port: bit for bit.

The ``test_card_*`` cases need a card and skip without one; they take the
port's own init params and bank and import nothing of JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_clusters.py -k card
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
from repro_torch.fl.runtime import AsyncConfig, RuntimeConfig
from repro_torch.kernels.entropy_judge import (entropy_judge_loop,
                                               entropy_judge_sweep)
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.models import cnn as tcnn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "cluster_history.json")
LOSS_ATOL = 1e-5
AGG_ATOL = 1e-6
ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-6
LIVE_DIGEST_RTOL = 1e-5
ROUNDS = 4


def _split():
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    return (xtr, ytr), stack_clients(xtr, ytr, parts, batch_multiple=20)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (imported here, so the card cases run
    where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import repro.fl as rfl
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.models import cnn as jcnn
    return SimpleNamespace(jax=jax, fl=rfl, cnn=jcnn, LocalSpec=JLocalSpec)


def _ref_case(ref, partitionable: bool):
    """The data, the reference's init params and its K = 3 bank (seed 0),
    drawn with the installed threefry or the pre-partitionable one."""
    def draw():
        params = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                              num_classes=4)
        return params, ref.fl.ModelBank.init(params, 3, seed=0)
    if partitionable:
        params, bank = draw()
    else:
        with ref.jax.threefry_partitionable(False):
            params, bank = draw()
    return SimpleNamespace(split=_split(), params=params, bank=bank)


@pytest.fixture(scope="module")
def tiny(ref):
    """For the live-reference cases: the installed JAX's draws."""
    return _ref_case(ref, True)


@pytest.fixture(scope="module")
def tiny_golden(ref):
    """For the golden: the draws the golden was recorded with (F1)."""
    return _ref_case(ref, False)


@pytest.fixture(scope="module")
def tiny_card():
    """The data with the port's own init params (no JAX); the port draws
    its own bank."""
    return SimpleNamespace(split=_split(), bank=None,
                           params=tcnn.init(torch.Generator().manual_seed(0),
                                            image_hw=16, num_classes=4))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


def _port_params(params):
    if isinstance(params["conv1"]["w"], torch.Tensor):
        return params
    return cnn_params_from_numpy({k: {kk: np.asarray(vv)
                                      for kk, vv in v.items()}
                                  for k, v in params.items()})


def _port_bank(ref, bank, device="cpu") -> tfl.ModelBank:
    """The reference's bank in the port's layout, center by center."""
    centers = [_port_params(ref.jax.tree.map(
        lambda s, i=i: np.asarray(s[i]), bank.stacked))
        for i in range(bank.k)]
    stacked = pytree.tree_map(lambda *xs: torch.stack(xs).to(device),
                              *centers)
    return tfl.ModelBank(stacked=stacked, k=bank.k)


def _adopt_bank(server, bank: tfl.ModelBank):
    """The test seam: the reference's bank on the port's server before
    round 0."""
    assert server.round_idx == 0
    server.bank = bank
    server.global_params = bank.stacked
    return server


def _drift(case, at=2, seed=0):
    (xtr, ytr), data = case.split
    return drift_schedule(xtr, ytr, 8, 4, at=at, seed=seed,
                          samples_per_client=int(data["y"].shape[1]))


def _build(case, name="ifca+maxent", k=3, device="cpu", ref=None, **kw):
    """The composition on the port; with ``ref`` the reference's bank is
    adopted before round 0."""
    _, data = case.split
    server = tfl.build(name, tcnn.apply, _port_params(case.params), data,
                       tfl.ServerConfig(num_clients=8, participation=0.5,
                                        seed=0, num_clusters=k),
                       tfl.LocalSpec(epochs=1, batch_size=20),
                       device=device, **kw)
    if ref is not None and k > 1:
        _adopt_bank(server, _port_bank(ref, case.bank, device))
    return server


def _build_ref(ref, case, name="ifca+maxent", k=3, **kw):
    _, data = case.split
    return ref.fl.build(name, ref.cnn.apply, case.params, data,
                        ref.fl.ServerConfig(num_clients=8, participation=0.5,
                                            seed=0, num_clusters=k),
                        ref.LocalSpec(epochs=1, batch_size=20), **kw)


def _run(server, rounds=ROUNDS):
    for _ in range(rounds):
        server.round()
    return server


def _digest(tree) -> float:
    """Sum of |x| over the leaves (the port's tensors or the reference's
    arrays)."""
    return sum(float(x.abs().sum()) if isinstance(x, torch.Tensor)
               else float(np.abs(np.asarray(x)).sum())
               for x in pytree.tree_leaves(tree))


def _same(a, b) -> bool:
    return a == b or (isinstance(a, float) and isinstance(b, float)
                      and np.isnan(a) and np.isnan(b))


def _assert_equal(a, b, flags=False):
    """Records equal to the bit (the speculation flags apart) and the
    bank or params equal bit for bit."""
    assert len(a.history) == len(b.history)
    extra = {"spec_hit", "redispatched"} if flags else set()
    for x, y in zip(a.history, b.history):
        assert set(y) == set(x) | extra
        for key in x:
            assert _same(x[key], y[key]), (x["round"], key)
    for p, q in zip(pytree.tree_leaves(a.global_params),
                    pytree.tree_leaves(b.global_params), strict=True):
        assert torch.equal(p, q)


def _assert_records(got, want):
    """Integer records, cluster ids and per-cluster verdicts exact,
    entropies within ENT_ATOL (``want``: a golden or live record)."""
    for key in ("selected", "positive", "negative", "cluster"):
        assert got[key] == want[key], (want["round"], key)
    total = (want["total_bytes"] if "total_bytes" in want
             else want["comm"]["total_bytes"])
    assert got["comm"]["total_bytes"] == total
    assert sorted(got["clusters"]) == sorted(want["clusters"])
    for c, v in want["clusters"].items():
        for key in ("members", "positive", "negative"):
            assert got["clusters"][c][key] == v[key], (want["round"], c)
        _assert_ent(got["clusters"][c]["entropy"], v["entropy"])
    _assert_ent(got["entropy"], want["entropy"])


def _assert_ent(got, want):
    want = float(want)
    if np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(want, abs=ENT_ATOL)


# ------------------------------------------------------- the bank itself

@pytest.mark.parametrize("seed", range(4))
def test_argmin_assign_matches_reference(ref, seed):
    rng = np.random.default_rng(seed)
    k = 1 + seed
    scores = rng.normal(size=(k, 9)).astype(np.float32)
    scores[:, 3] = scores[0, 3]               # a tie: the lowest index
    want = ref.fl.argmin_assign(scores)
    np.testing.assert_array_equal(tfl.argmin_assign(scores), want)
    np.testing.assert_array_equal(
        tfl.argmin_assign(torch.from_numpy(scores)), want)
    assert tfl.argmin_assign(scores).dtype == np.int64
    with pytest.raises(ValueError, match=r"\(K, m\)"):
        tfl.argmin_assign(np.zeros(3))


def test_bank_gather_and_center_match_reference(ref, tiny):
    bank = _port_bank(ref, tiny.bank)
    ids = np.asarray([2, 0, 1, 1, 2])
    got, want = bank.gather(ids), tiny.bank.gather(ids)
    for i in range(len(ids)):
        row = _port_params(ref.jax.tree.map(lambda s, i=i: np.asarray(s[i]),
                                            want))
        for name, sub in row.items():
            for leaf, t in sub.items():
                assert torch.equal(got[name][leaf][i], t)
    for c in range(3):
        center = _port_params(ref.jax.tree.map(np.asarray,
                                               tiny.bank.center(c)))
        for name, sub in center.items():
            for leaf, t in sub.items():
                assert torch.equal(bank.center(c)[name][leaf], t)


def test_bank_init_center0_is_params(tiny_card):
    params = tiny_card.params
    bank = tfl.ModelBank.init(params, 3, seed=0)
    assert bank.k == 3
    for name, sub in params.items():
        for leaf, t in sub.items():
            assert torch.equal(bank.center(0)[name][leaf], t)
            assert not torch.equal(bank.center(1)[name][leaf], t)
            assert not torch.equal(bank.center(1)[name][leaf],
                                   bank.center(2)[name][leaf])
    again = tfl.ModelBank.init(params, 3, seed=0)
    other = tfl.ModelBank.init(params, 3, seed=1)
    for a, b, c in zip(pytree.tree_leaves(bank.stacked),
                       pytree.tree_leaves(again.stacked),
                       pytree.tree_leaves(other.stacked)):
        assert torch.equal(a, b)
        assert not torch.equal(a[1], c[1])
    one = tfl.ModelBank.init(params, 1)
    for a, b in zip(pytree.tree_leaves(one.center(0)),
                    pytree.tree_leaves(params)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="k >= 1"):
        tfl.ModelBank.init(params, 0)


@pytest.mark.parametrize("k,n,seed", [(1, 8, 0), (3, 8, 0), (3, 100, 7),
                                      (5, 33, 2)])
def test_fesem_init_matches_reference(ref, k, n, seed):
    got = tfl.FeSEMAssigner(k, n, seed)
    want = ref.fl.FeSEMAssigner(k, n, seed)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    sel = [0, 3, 5, 7]
    np.testing.assert_array_equal(got.assign(sel), want.assign(sel))
    assert got.stats() == want.stats()


def test_ifca_losses_match_reference(ref, tiny):
    """The (K, m) loss matrix on the reference's bank, within LOSS_ATOL;
    prints the smallest margin between the best and the second-best
    center of any client."""
    port = _build(tiny, ref=ref)
    live = _build_ref(ref, tiny)
    margins, gap = [], 0.0
    for sel in ([1, 6, 0, 2], [0, 1, 2, 3, 4, 5, 6, 7], [7, 3]):
        got = port.cluster.losses(sel).numpy()
        data = live.corpus.cohort(np.asarray(sel))
        want = np.asarray(live.cluster._loss_fn()(live.bank.stacked, data))
        np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_ATOL)
        np.testing.assert_array_equal(tfl.argmin_assign(got),
                                      ref.fl.argmin_assign(want))
        two = np.sort(want.astype(np.float64), axis=0)[:2]
        margins.append(float((two[1] - two[0]).min()))
        gap = max(gap, float(np.abs(got.astype(np.float64) - want).max()))
    print(f"IFCA: smallest best/second-best margin {min(margins):.3e}; "
          f"largest port/reference loss gap {gap:.3e}")
    assert min(margins) > gap


# ------------------------------------------------------------ perclstr

_CIDS = {"mixed": [0, 2, 2, 0, 1, 2], "empty-1": [0, 0, 2, 0, 2, 2],
         "one": [1, 1, 1, 1, 1, 1]}


@pytest.mark.parametrize("base", ["weighted", "fused"])
@pytest.mark.parametrize("cids", sorted(_CIDS))
def test_perclstr_matches_reference(ref, cids, base):
    rng = np.random.default_rng(len(cids))
    stacked = {"a": {"w": rng.normal(size=(3, 4, 5)).astype(np.float32),
                     "b": rng.normal(size=(3, 5)).astype(np.float32)}}
    rows = {"a": {"w": rng.normal(size=(6, 4, 5)).astype(np.float32),
                  "b": rng.normal(size=(6, 5)).astype(np.float32)}}
    sizes = rng.integers(20, 200, 6).astype(np.float32)
    mask = np.asarray([1, 0, 1, 1, 0, 1], np.float32)
    ids = np.asarray(_CIDS[cids], np.int32)
    t = lambda tree: pytree.tree_map(torch.from_numpy, tree)  # noqa: E731
    port_base = (tfl.FusedAverageAggregator() if base == "fused"
                 else tfl.WeightedAverageAggregator())
    got = tfl.PerClusterAggregator(port_base)(
        t(stacked), {"params": t(rows), "cluster": torch.from_numpy(ids)},
        torch.from_numpy(sizes), torch.from_numpy(mask))
    jnp = ref.jax.numpy
    want = ref.fl.PerClusterAggregator(ref.fl.get("aggregator", base)())(
        ref.jax.tree.map(jnp.asarray, stacked),
        {"params": ref.jax.tree.map(jnp.asarray, rows),
         "cluster": jnp.asarray(ids)}, jnp.asarray(sizes),
        jnp.asarray(mask))
    for leaf in ("w", "b"):
        np.testing.assert_allclose(got["a"][leaf].numpy(),
                                   np.asarray(want["a"][leaf]), rtol=0,
                                   atol=AGG_ATOL)
        for c in range(3):
            if not np.any(mask[ids == c]):    # no admitted member
                assert torch.equal(got["a"][leaf][c],
                                   torch.from_numpy(stacked["a"][leaf][c]))


def test_perclstr_without_cluster_key_is_its_base():
    rng = np.random.default_rng(0)
    out = {"params": {"w": torch.from_numpy(rng.normal(size=(4, 3)))}}
    gp = {"w": torch.from_numpy(rng.normal(size=(3,)))}
    sizes = torch.tensor([1.0, 2.0, 3.0, 4.0])
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    for base in (tfl.WeightedAverageAggregator(),
                 tfl.FusedAverageAggregator(backend="cuda")):
        got = tfl.PerClusterAggregator(base)(gp, out, sizes, mask)
        assert torch.equal(got["w"], base(gp, out, sizes, mask)["w"])


# --------------------------------------------------------- whole rounds

def test_k1_is_bit_for_bit_fedentropy(tiny):
    k1 = _run(_build(tiny, k=1), 3)
    assert k1.bank is None
    assert all("cluster" not in r for r in k1.history)
    fe = _run(_build(tiny, "fedentropy", k=1), 3)
    _assert_equal(fe, k1)


_ENGINES = {"server": {},
            "pipelined-spec-off": {"engine": "pipelined",
                                   "runtime": RuntimeConfig()},
            "pipelined-spec-on": {"runtime": RuntimeConfig(speculate=True)}}


@pytest.mark.parametrize("engine", sorted(_ENGINES))
def test_reproduces_cluster_golden(ref, tiny_golden, engine):
    with open(GOLDEN) as f:
        golden = json.load(f)["ifca_maxent_k3_drift"]
    server = _build(tiny_golden, ref=ref, drift=_drift(tiny_golden),
                    **_ENGINES[engine])
    _run(server, len(golden["history"]))
    for got, want in zip(server.history, golden["history"], strict=True):
        _assert_records(got, want)
        assert got.get("drift") == want["drift"], want["round"]
        if engine == "pipelined-spec-on":
            assert isinstance(got["spec_hit"], bool)
    assert [r["round"] for r in server.history if "drift" in r] == \
        [golden["drift_round"]]
    assert _digest(server.bank.stacked) == pytest.approx(
        float(golden["params_digest"]), rel=DIGEST_RTOL)


@pytest.mark.parametrize("name", ["ifca+maxent", "ifca", "fesem"])
def test_matches_live_reference(ref, tiny, name):
    port = _build(tiny, name, ref=ref)
    live = _build_ref(ref, tiny, name)
    for _ in range(3):
        want, got = live.round(), port.round()
        _assert_records(got, want)
    if name == "fesem":
        assert port.cluster.stats() == live.cluster.stats()
    assert _digest(port.bank.stacked) == pytest.approx(
        _digest(live.bank.stacked), rel=LIVE_DIGEST_RTOL)


@pytest.mark.parametrize("wrong", [False, True], ids=["hit", "miss"])
def test_pipelined_equals_sequential(tiny, wrong):
    """ifca+maxent across the drift, speculating on K1's plain version
    (and a traced form that admits everyone: a forced miss on every round
    that rejects), equals the sequential server bit for bit."""
    kw = {"judge": _AdmitAll()} if wrong else {}
    seq = _run(_build(tiny, ref=None, drift=_drift(tiny), **kw))
    pip = _run(_build(tiny, ref=None, drift=_drift(tiny), **kw,
                      runtime=RuntimeConfig(speculate=True,
                                            spec_backend="cuda")))
    _assert_equal(seq, pip, flags=True)
    misses = [not r["spec_hit"] for r in pip.history]
    assert any(misses) == wrong
    for prev, rec in zip(pip.history, pip.history[1:]):
        # round 1 does not dispatch round 2 across the drift
        assert rec["redispatched"] == (not prev["spec_hit"]
                                       and rec["round"] != 2)


def test_speculation_never_spans_drift(tiny):
    server = _build(tiny, drift=_drift(tiny, at=2),
                    runtime=RuntimeConfig(speculate=True))
    server.round()
    server.round()
    assert server._pending is None
    assert "drift" in server.round()


def test_fesem_across_engines(tiny):
    seq = _run(_build(tiny, "fesem", judge="maxent", selector="pools"))
    pip = _run(_build(tiny, "fesem", judge="maxent", selector="pools",
                      runtime=RuntimeConfig(speculate=True)))
    _assert_equal(seq, pip, flags=True)
    assert seq.cluster.stats() == pip.cluster.stats()
    np.testing.assert_array_equal(seq.cluster.assignments,
                                  pip.cluster.assignments)


def test_evaluate_scores_a_center(tiny):
    (_, _), data = tiny.split
    server = _run(_build(tiny), 1)
    x = data["x"][0][:16]
    y = data["y"][0][:16]
    scores = [server.evaluate(x, y, center=c) for c in range(3)]
    assert server.evaluate(x, y) == scores[0]
    assert all(0.0 <= s["accuracy"] <= 1.0 for s in scores)


# ---------------------------------------------------- registry, refusals

def test_registry_cluster_axis(ref):
    assert "cluster" in tfl.names.__globals__["KINDS"]
    assert tfl.names("cluster") == ["fesem", "ifca"]
    for comp in ("ifca", "ifca+maxent", "fesem"):
        got, want = tfl.get("composition", comp), ref.fl.get("composition",
                                                              comp)
        for axis in ("strategy", "selector", "judge", "aggregator",
                     "cluster"):
            assert getattr(got, axis) == getattr(want, axis), (comp, axis)
    assert tfl.get("composition", "fedentropy").cluster is None
    assert tfl.get("aggregator", "perclstr") is tfl.PerClusterAggregator
    assert isinstance(tfl.IFCAAssigner(3), tfl.ClusterAssigner)


def test_refusals(tiny):
    with pytest.raises(ValueError, match="state"):
        _build(tiny, "ifca", strategy="scaffold")
    with pytest.raises(ValueError, match="fan-out"):
        _build(tiny, "ifca", strategy="catchain")
    with pytest.raises(ValueError, match="ModelBank"):
        _build(tiny, runtime=AsyncConfig())
    with pytest.raises(ValueError, match="num_clusters"):
        tfl.IFCAAssigner(0)


class _AdmitAll(tfl.MaxEntropyJudge):
    """The float64 oracle with a traced form that admits everyone."""

    def traced(self, backend=None):
        return tfl.PassThroughJudge().traced()


# ------------------------------------------------------------------ card

_WRAPPERS = (entropy_judge_loop, entropy_judge_sweep, masked_weighted_sum)


def _reset():
    for fn in _WRAPPERS:
        fn.launches = 0


def _launches():
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def _card_kw():
    return dict(judge=tfl.MaxEntropyJudge(backend="cuda"),
                aggregator=tfl.PerClusterAggregator(
                    tfl.FusedAverageAggregator(backend="cuda")),
                device="cuda")


def test_card_clustered_captured_equals_eager(cuda, tiny_card):
    """ifca+maxent at K = 3 across the drift with the client program
    captured equals the eager route bit for bit; K1's loop judges each
    non-empty cluster once a round and K2 runs K = 3 times a round."""
    cap = _build(tiny_card, drift=_drift(tiny_card), **_card_kw())
    _reset()
    _run(cap)
    clusters = sum(len(r["clusters"]) for r in cap.history)
    assert _launches() == {"entropy_judge_loop": clusters,
                           "entropy_judge_sweep": 0,
                           "masked_weighted_sum": 3 * ROUNDS}
    with tfl.disable_capture():
        eager = _run(_build(tiny_card, drift=_drift(tiny_card),
                            **_card_kw()))
    _assert_equal(eager, cap)
    assert (cap.graphs_captured, eager.graphs_captured) == (1, 0)


@pytest.mark.parametrize("wrong", [False, True], ids=["hit", "miss"])
def test_card_clustered_pipelined_equals_sequential(cuda, tiny_card, wrong):
    kw = dict(judge=(_AdmitAll if wrong else tfl.MaxEntropyJudge)(),
              aggregator=tfl.PerClusterAggregator(
                  tfl.FusedAverageAggregator(backend="cuda")),
              device="cuda", drift=_drift(tiny_card))
    seq = _run(_build(tiny_card, **kw))
    pip = _build(tiny_card, **kw,
                 runtime=RuntimeConfig(speculate=True, spec_backend="cuda"))
    _reset()
    _run(pip)
    _assert_equal(seq, pip, flags=True)
    clusters = sum(len(r["clusters"]) for r in pip.history)
    misses = sum(not r["spec_hit"] for r in pip.history)
    assert _launches() == {"entropy_judge_loop": 0 if wrong else clusters,
                           "entropy_judge_sweep": 0,
                           "masked_weighted_sum": 3 * (ROUNDS + misses)}
    assert seq.graphs_captured == 1 == pip.graphs_captured
