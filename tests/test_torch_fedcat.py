"""FedCAT in the port (``fedcat`` and ``fedcat+maxent``): the grouping,
the chain selectors, the chain program, the devconcat merge and the whole
round on the sequential and pipelined servers, against the JAX package.

The ``tiny`` fixture of ``tests/test_fedcat.py`` (8 clients,
participation 0.5, 16x16 images, 4 classes, ``LocalSpec(epochs=1,
batch_size=20)``), on the CPU. The data comes from the port's numpy
transcriptions (the same arrays as the reference's); the params from
``repro``'s ``cnn.init``, converted.

Tolerances:

* the grouping and the selectors: exact (numpy in both packages);
* the chain program's params, soft labels and sizes within 1e-5 of the
  reference (as ``tests/test_torch_strategies.py``), ``group_id`` and
  ``chain_pos`` exact, a padded stage's carry bit for bit;
* devconcat against the reference within 1e-6 (the float32 sums over
  the client axis run in another order); all rejected keeps the global
  params bit for bit; at group size 1 it equals the port's
  ``WeightedAverageAggregator`` bit for bit;
* the golden histories (``tests/golden/fedcat_history.json``, recorded
  by the JAX package with the pre-partitionable threefry, so the init
  params are drawn under ``jax.threefry_partitionable(False)``; ROADMAP
  F1): integer records and each round's groups exact, entropy within
  1e-6, params digest within a relative 1e-6 — the port's policy, not
  the JAX tests' 1e-9 and 1e-7, which do not carry across frameworks;
* against the live reference: integer records exact, entropy 1e-6,
  digest rel 1e-5 (as ``tests/test_torch_server.py``);
* ``fedcat`` at group size 1 against the port's ``fedavg``: bit for bit.

The ``test_card_*`` cases need a card and skip without one; they take
the port's own init params and import nothing of JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_fedcat.py -k card
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
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.core.pools import greedy_entropy_groups, label_histograms
from repro_torch.data.partition import partition, stack_clients
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.runtime import (RuntimeConfig, disable_process_cache,
                                    enable_process_cache)
from repro_torch.kernels.entropy_judge import (entropy_judge_loop,
                                               entropy_judge_sweep)
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.models import cnn as tcnn

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "fedcat_history.json")
_VARIANTS = {"fedcat": "fedcat", "fedcat_maxent": "fedcat+maxent"}
PARAMS_ATOL = 1e-5
AGG_ATOL = 1e-6
ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-6
LIVE_DIGEST_RTOL = 1e-5
ROUNDS = 3


def _data():
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    return stack_clients(xtr, ytr, parts, batch_multiple=20)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's modules (imported here, so the card cases run
    where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import repro.fl as rfl
    from repro.core import pools as jpools
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.models import cnn as jcnn
    return SimpleNamespace(jax=jax, fl=rfl, pools=jpools, cnn=jcnn,
                           LocalSpec=JLocalSpec)


@pytest.fixture(scope="module")
def tiny(ref):
    """The data and the reference's init params as the installed JAX
    draws them (numpy), for the live-reference cases."""
    params = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                          num_classes=4)
    return _data(), ref.jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_golden(ref):
    """The data and the init params the goldens were recorded with
    (F1: drawn under the pre-partitionable threefry)."""
    with ref.jax.threefry_partitionable(False):
        params = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                              num_classes=4)
    return _data(), ref.jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def tiny_card():
    """The data with the port's own init params (no JAX)."""
    return _data(), tcnn.init(torch.Generator().manual_seed(0),
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
    """Numpy reference-layout params as the port's, or the port's as
    they are."""
    if isinstance(tree["conv1"]["w"], torch.Tensor):
        return tree
    return cnn_params_from_numpy(tree)


def _build(case, name="fedcat", group_size=2, device="cpu", **kw):
    data, params = case
    strategy = tfl.get("composition", name).strategy
    return tfl.build(name, tcnn.apply, _params(params), data,
                     tfl.ServerConfig(num_clients=8, participation=0.5,
                                      seed=0, group_size=group_size),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     device=device, **kw)


def _spy_groups(server) -> dict:
    """Records the groups each dispatch was laid out by, keyed by the
    selection (a re-dispatch of a selection lays it out the same)."""
    seen = {}
    run = server._run_cohort

    def spy(sel, selector, global_params=None):
        seen[tuple(sel)] = list(selector.last_groups)
        return run(sel, selector, global_params)

    server._run_cohort = spy
    return seen


def _run(server, rounds=ROUNDS):
    for _ in range(rounds):
        server.round()
    return server


def _digest(params) -> float:
    return sum(float(x.abs().sum()) for x in pytree.tree_leaves(params))


def _assert_equal(seq, pip, flags=False):
    """Records equal to the bit (the speculation flags apart) and params
    equal bit for bit."""
    assert len(seq.history) == len(pip.history)
    for a, b in zip(seq.history, pip.history):
        extra = {"spec_hit", "redispatched"} if flags else set()
        assert set(b) == set(a) | extra
        for key in a:
            if key == "entropy" and np.isnan(a[key]):
                assert np.isnan(b[key])
            else:
                assert b[key] == a[key], (a["round"], key)
    for x, y in zip(pytree.tree_leaves(seq.global_params),
                    pytree.tree_leaves(pip.global_params), strict=True):
        assert torch.equal(x, y)


# ------------------------------------------------------------- grouping

def _grouping_case(i: int):
    """30 seeded cases: Dirichlet histograms, tied rows, n < k, k = 1,
    integer counts with empty rows and a short last group."""
    r = np.random.default_rng(100 + i)
    kind = i // 6
    n = int(r.integers(4, 13))
    c = int(r.integers(2, 11))
    k = int(r.integers(2, 5))
    hists = r.dirichlet(np.full(c, 0.3), size=n) * r.integers(20, 200)
    if kind == 1:                                   # tied rows
        hists[1::2] = hists[0::2][:len(hists[1::2])]
        hists[-1] = hists[0]
    elif kind == 2:                                 # n < k
        n, k = int(r.integers(1, 4)), int(r.integers(4, 7))
        hists = hists[:n]
    elif kind == 3:                                 # k = 1
        k = 1
    elif kind == 4:                                 # counts, short group
        hists = r.integers(0, 6, size=(n, c)).astype(np.float64)
        hists[r.integers(0, n)] = 0.0
        k = 3 if n % 3 else 5
    return hists, k


@pytest.mark.parametrize("case", range(30))
def test_greedy_entropy_groups_match_reference(ref, case):
    hists, k = _grouping_case(case)
    got = greedy_entropy_groups(hists, k)
    assert got == ref.pools.greedy_entropy_groups(hists, k)
    assert sorted(i for g in got for i in g) == list(range(len(hists)))
    assert all(len(g) == min(k, len(hists)) for g in got[:-1])


# ------------------------------------------------------------ selectors

@pytest.mark.parametrize("bound", [True, False], ids=["bound", "unbound"])
@pytest.mark.parametrize("name", ["catgroups", "catgroups-pools"])
def test_cat_selectors_match_reference(ref, name, bound):
    data = _data()
    t_cfg = tfl.ServerConfig(num_clients=8, participation=0.5,
                             group_size=3)
    r_cfg = ref.fl.ServerConfig(num_clients=8, participation=0.5,
                                group_size=3)
    got = tfl.get("selector", name).from_config(t_cfg, None)
    want = ref.fl.get("selector", name).from_config(r_cfg, None)
    if bound:
        got.bind_data(tfl.ClientCorpus.from_stacked(data, device="cpu"))
        want.bind_data(data)
    assert got.stats() == want.stats()
    for r in range(5):
        sel = got.select(4)
        assert sel == want.select(4)
        assert got.last_groups == want.last_groups
        assert got.stats() == want.stats()
        pos, neg = sel[:r % 3], sel[r % 3:]
        got.update(pos, neg)
        want.update(pos, neg)
        assert got.stats() == want.stats()
    assert isinstance(got, tfl.CatGrouper)
    assert (type(got) is tfl.PoolCatGrouper) == (name == "catgroups-pools")


# --------------------------------------------------------- chain program

def _cohort_groups(data, idx, group_size):
    hists = label_histograms(data["y"], data["w"])[idx]
    return greedy_entropy_groups(hists, group_size)


@pytest.mark.parametrize("group_size", [1, 2, 3])
def test_chain_program_matches_reference(ref, tiny, group_size):
    """One chain program on a cohort of 4 (group size 3 is ragged: a
    chain of 3 and one of 1, padded with valid = 0)."""
    jnp = ref.jax.numpy
    data, params = tiny
    idx = np.array([5, 2, 7, 0])
    groups = _cohort_groups(data, idx, group_size)
    selector = SimpleNamespace(last_groups=groups)
    spec = ref.LocalSpec(epochs=1, batch_size=20)

    rs = ref.fl.get("strategy", "catchain")(spec, group_size)
    jdata = {k: jnp.asarray(v[idx]) for k, v in data.items()}
    gd, aux = rs.prepare_round(jdata, selector)
    out = ref.jax.jit(rs.make_client_fn(ref.cnn.apply))(
        params, gd, None, None, None, aux["valid"])
    want = rs.finish_round(out, aux)

    ts = tfl.CatChainStrategy(tfl.LocalSpec(epochs=1, batch_size=20),
                              group_size)
    tdata = tfl.ClientCorpus.from_stacked(data, device="cpu").cohort(idx)
    tgd, taux = ts.prepare_round(tdata, selector)
    raw = ts.make_client_fn(tcnn.apply)(cnn_params_from_numpy(params), tgd,
                                        None, None, None, taux["valid"])
    got = ts.finish_round(raw, taux)

    np.testing.assert_array_equal(taux["valid"].numpy(),
                                  np.asarray(aux["valid"]))
    for key in ("group_id", "chain_pos"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    for key in ("soft_label", "size"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=PARAMS_ATOL)
    for i in range(len(idx)):
        row = cnn_params_to_numpy(pytree.tree_map(lambda x: x[i],
                                                  got["params"]))
        for layer in row:
            for leaf in ("w", "b"):
                np.testing.assert_allclose(
                    row[layer][leaf],
                    np.asarray(want["params"][layer][leaf][i]), rtol=0,
                    atol=PARAMS_ATOL, err_msg=f"{i} {layer}.{leaf}")
    # a padded stage is the identity: its carry is its predecessor's
    valid = taux["valid"]
    for g, j in zip(*np.nonzero(valid.numpy() == 0)):
        for leaf in pytree.tree_leaves(raw["params"]):
            assert torch.equal(leaf[g, j], leaf[g, j - 1])
    assert (group_size == 3) == bool((valid == 0).any())


# ------------------------------------------------------------ devconcat

def _layout(groups):
    n = sum(len(g) for g in groups)
    gid, pos = np.zeros(n, np.int32), np.zeros(n, np.int32)
    for g, members in enumerate(groups):
        for j, m in enumerate(members):
            gid[m], pos[m] = g, j
    return gid, pos


_MASKS = {
    "all-admitted": [1, 1, 1, 1, 1, 1],
    "head-rejected": [0, 1, 1, 1, 1, 1],      # chain [0, 3] loses it all
    "middle-rejected": [1, 1, 1, 1, 0, 1],    # chain [1, 4, 5] cut at 4
    "all-rejected": [0, 0, 0, 0, 0, 0],
    "random": None,
}


@pytest.mark.parametrize("mask", sorted(_MASKS))
def test_devconcat_matches_reference(ref, mask):
    jnp = ref.jax.numpy
    r = np.random.default_rng(7)
    groups = [[0, 3], [1, 4, 5], [2]]
    gid, pos = _layout(groups)
    m = np.asarray(_MASKS[mask] if _MASKS[mask] is not None
                   else r.integers(0, 2, 6), np.float32)
    params = {"a": {"w": r.normal(size=(6, 3, 4)).astype(np.float32)},
              "b": {"b": r.normal(size=(6, 5)).astype(np.float32)}}
    glob = {"a": {"w": r.normal(size=(3, 4)).astype(np.float32)},
            "b": {"b": r.normal(size=(5,)).astype(np.float32)}}
    sizes = r.integers(20, 120, 6).astype(np.float32)

    want = ref.fl.DeviceConcatAggregator()(
        ref.jax.tree.map(jnp.asarray, glob),
        {"params": ref.jax.tree.map(jnp.asarray, params),
         "group_id": jnp.asarray(gid), "chain_pos": jnp.asarray(pos)},
        jnp.asarray(sizes), jnp.asarray(m))
    tglob = pytree.tree_map(torch.from_numpy, glob)
    got = tfl.DeviceConcatAggregator()(
        tglob, {"params": pytree.tree_map(torch.from_numpy, params),
                "group_id": torch.from_numpy(gid),
                "chain_pos": torch.from_numpy(pos)},
        torch.from_numpy(sizes), torch.from_numpy(m))
    for g, w in zip(pytree.tree_leaves(got), ref.jax.tree.leaves(want),
                    strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=AGG_ATOL)
    if mask == "all-rejected":
        for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(tglob)):
            assert torch.equal(g, w)
    # without chain annotations it is the plain weighted average
    plain = tfl.DeviceConcatAggregator()(
        tglob, {"params": pytree.tree_map(torch.from_numpy, params)},
        torch.from_numpy(sizes), torch.from_numpy(m))
    avg = tfl.WeightedAverageAggregator()(
        tglob, {"params": pytree.tree_map(torch.from_numpy, params)},
        torch.from_numpy(sizes), torch.from_numpy(m))
    for g, w in zip(pytree.tree_leaves(plain), pytree.tree_leaves(avg)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_devconcat_at_group_size_1_is_weighted_average(seed):
    r = np.random.default_rng(seed)
    m = 10
    params = {"a": {"w": torch.from_numpy(
        r.normal(size=(m, 6, 5)).astype(np.float32))}}
    glob = {"a": {"w": torch.zeros(6, 5)}}
    sizes = torch.from_numpy(r.integers(20, 500, m).astype(np.float32))
    mask = torch.from_numpy(r.integers(0, 2, m).astype(np.float32))
    mask[0] = 1.0
    out = {"params": params,
           "group_id": torch.arange(m, dtype=torch.int32),
           "chain_pos": torch.zeros(m, dtype=torch.int32)}
    got = tfl.DeviceConcatAggregator()(glob, out, sizes, mask)
    want = tfl.WeightedAverageAggregator()(glob, out, sizes, mask)
    assert torch.equal(got["a"]["w"], want["a"]["w"])


# --------------------------------------------------- goldens, engines

_ENGINES = {"server": {},
            "pipelined-spec-off": {"engine": "pipelined",
                                   "runtime": RuntimeConfig()},
            "pipelined-spec-on": {"runtime": RuntimeConfig(speculate=True)}}


@pytest.mark.parametrize("engine", sorted(_ENGINES))
@pytest.mark.parametrize("variant", sorted(_VARIANTS))
def test_reproduces_golden(tiny_golden, variant, engine):
    with open(GOLDEN) as f:
        golden = json.load(f)[variant]
    server = _build(tiny_golden, _VARIANTS[variant], **_ENGINES[engine])
    groups = _spy_groups(server)
    _run(server, len(golden["history"]))
    for got, want in zip(server.history, golden["history"], strict=True):
        for key in ("selected", "positive", "negative"):
            assert got[key] == want[key], (want["round"], key)
        assert got["comm"]["total_bytes"] == want["total_bytes"]
        assert groups[tuple(got["selected"])] == want["groups"]
        ent = float(want["entropy"])
        if np.isnan(ent):
            assert np.isnan(got["entropy"])
        else:
            assert got["entropy"] == pytest.approx(ent, abs=ENT_ATOL)
        if engine == "pipelined-spec-on":
            assert isinstance(got["spec_hit"], bool)
    if engine != "pipelined-spec-on":    # the adopted copy is a round ahead
        assert server.selector.last_groups == golden["history"][-1]["groups"]
    assert _digest(server.global_params) == pytest.approx(
        float(golden["params_digest"]), rel=DIGEST_RTOL)


@pytest.mark.parametrize("name", ["fedcat", "fedcat+maxent"])
def test_build_matches_live_reference(ref, tiny, name):
    data, params = tiny
    live = ref.fl.build(name, ref.cnn.apply, params, data,
                        ref.fl.ServerConfig(num_clients=8, participation=0.5),
                        ref.LocalSpec(epochs=1, batch_size=20))
    port = _build(tiny, name)
    for _ in range(ROUNDS):
        want, got = live.round(), port.round()
        for key in ("selected", "positive", "negative", "comm"):
            assert got[key] == want[key], (want["round"], key)
        if np.isnan(want["entropy"]):
            assert np.isnan(got["entropy"])
        else:
            assert got["entropy"] == pytest.approx(want["entropy"],
                                                   abs=ENT_ATOL)
        assert port.selector.last_groups == live.selector.last_groups
    if name == "fedcat+maxent":
        assert any(h["negative"] for h in port.history)   # judgment bites
    want_digest = sum(float(np.abs(np.asarray(x)).sum())
                      for x in ref.jax.tree.leaves(live.global_params))
    assert _digest(port.global_params) == pytest.approx(
        want_digest, rel=LIVE_DIGEST_RTOL)


def test_group_size_1_is_bit_for_bit_fedavg(tiny):
    """Every device its own chain: the same records and params as the
    port's fedavg on the uniform selector (catgroups wraps the same
    uniform stream)."""
    k1 = _run(_build(tiny, "fedcat", group_size=1))
    fa = _run(_build(tiny, "fedavg"))
    _assert_equal(fa, k1)
    assert all(len(g) == 1 for g in k1.selector.last_groups)


def test_budgeted_judge_truncates_chains(ref, tiny):
    """BudgetedJudge keeps exactly two devices a round, so chains are cut
    every round; the records equal the reference's under its own
    BudgetedJudge, and the merge moves the params."""
    data, params = tiny
    live = ref.fl.build("fedcat", ref.cnn.apply, params, data,
                        ref.fl.ServerConfig(num_clients=8, participation=0.5),
                        ref.LocalSpec(epochs=1, batch_size=20),
                        judge=ref.fl.BudgetedJudge(budget=2))
    port = _build(tiny, "fedcat", judge=tfl.BudgetedJudge(budget=2))
    before = _digest(port.global_params)
    for _ in range(2):
        want, got = live.round(), port.round()
        assert len(got["positive"]) == 2 and len(got["negative"]) == 2
        for key in ("selected", "positive", "negative", "comm"):
            assert got[key] == want[key], (want["round"], key)
    assert _digest(port.global_params) != pytest.approx(before)


class _WrongSpeculation(tfl.MaxEntropyJudge):
    """The oracle is the real maxent; the traced form admits everyone,
    so every round that rejects a device misses (the counterpart of
    tests/test_fedcat.py's ``_WrongSpeculationJudge``)."""

    def traced(self, backend=None):
        return tfl.PassThroughJudge().traced()


def test_forced_miss_redispatches_groups_and_equals_server(tiny):
    seq = _run(_build(tiny, "fedcat+maxent"), 5)
    pip = _build(tiny, "fedcat+maxent", judge=_WrongSpeculation(),
                 runtime=RuntimeConfig(speculate=True))
    groups = _spy_groups(pip)
    _run(pip, 5)
    _assert_equal(seq, pip, flags=True)
    assert not all(r["spec_hit"] for r in pip.history)
    assert not pip.history[0]["redispatched"]
    for prev, rec in zip(pip.history, pip.history[1:]):
        assert rec["redispatched"] == (not prev["spec_hit"])
        assert prev["spec_hit"] == (not prev["negative"])
    hists = label_histograms(_data()["y"], _data()["w"])
    for rec in pip.history:        # each dispatch laid out by its own copy
        sel = rec["selected"]
        assert groups[tuple(sel)] == greedy_entropy_groups(hists[sel], 2)


def test_group_sizes_key_separate_programs(tiny):
    """Two group sizes on one process cache: two keys (the (G, K) layout
    is part of the key), each tagged with the chain strategy's class; a
    second server of the same group size shares its program."""
    cache = enable_process_cache(maxsize=8)
    try:
        for gs in (2, 3, 2):
            _build(tiny, "fedcat", group_size=gs).round()
        assert cache.stats()["misses"] == 2 and cache.stats()["hits"] == 1
        keys = [k for k in cache._entries if k[0] != "spec-judge"]
        assert [k[0] for k in keys] == ["client-CatChainStrategy"] * 2
        assert sorted(k[-1] for k in keys) == [(2, 2), (2, 3)]
        _build(tiny, "fedavg").round()
        assert ("client", None) in {(k[0], k[-1]) for k in cache._entries}
    finally:
        disable_process_cache()


# ------------------------------------------------------------- card only

_WRAPPERS = (entropy_judge_loop, entropy_judge_sweep, masked_weighted_sum)


def _reset():
    for fn in _WRAPPERS:
        fn.launches = 0


def _launches():
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


@pytest.mark.parametrize("name", ["fedcat", "fedcat+maxent"])
def test_card_captured_chain_equals_eager(cuda, tiny_card, name):
    """The chain program captured as one CUDA graph equals the eager
    route bit for bit; K1's loop judges fedcat+maxent once a round and
    K2 never runs (devconcat merges leaf by leaf)."""
    kw = {"judge": tfl.MaxEntropyJudge(backend="cuda")} \
        if name == "fedcat+maxent" else {}
    cap = _build(tiny_card, name, device="cuda", **kw)
    _reset()
    _run(cap)
    assert _launches() == {
        "entropy_judge_loop": ROUNDS if name == "fedcat+maxent" else 0,
        "entropy_judge_sweep": 0, "masked_weighted_sum": 0}
    with tfl.disable_capture():
        eager = _run(_build(tiny_card, name, device="cuda", **kw))
    _assert_equal(eager, cap)
    assert (cap.graphs_captured, eager.graphs_captured) == (1, 0)


@pytest.mark.parametrize("wrong", [False, True], ids=["hit", "miss"])
def test_card_pipelined_chains_equal_sequential(cuda, tiny_card, wrong):
    """fedcat+maxent speculating in K1's loop under capture equals the
    sequential server bit for bit, with and without a forced miss."""
    judge = _WrongSpeculation if wrong else tfl.MaxEntropyJudge
    seq = _run(_build(tiny_card, "fedcat+maxent", device="cuda",
                      judge=judge()), 5)
    pip = _build(tiny_card, "fedcat+maxent", device="cuda", judge=judge(),
                 runtime=RuntimeConfig(speculate=True, spec_backend="cuda"))
    _reset()
    _run(pip, 5)
    _assert_equal(seq, pip, flags=True)
    assert _launches() == {"entropy_judge_loop": 0 if wrong else 5,
                           "entropy_judge_sweep": 0,
                           "masked_weighted_sum": 0}
    if wrong:
        assert not all(r["spec_hit"] for r in pip.history)
    assert seq.graphs_captured == 1 == pip.graphs_captured
