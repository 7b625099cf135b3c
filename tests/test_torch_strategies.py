"""The port's MOON and SCAFFOLD client updates, their strategy state, the
SCAFFOLD server step and the budgeted judgment against the JAX package's,
on the same numpy inputs on the CPU.

Tolerances (measured on the ``tiny`` fixture's shapes, one epoch of two
minibatches of 20):

* params and soft labels within 1e-5, as ``tests/test_torch_cnn.py``
  (measured: at most 6e-8);
* SCAFFOLD's variate ``c_local`` and its change ``c_delta`` within 1e-4
  absolute: the variate divides the params' change by K * lr = 2 * 0.01,
  so the float32 differences of the two frameworks' convolutions grow
  50x there (measured: at most 3e-6);
* state slices and the MOON state's rows are exact copies; SCAFFOLD's
  ``c_global`` mean within 1e-7;
* ``judge_budgeted``: masks equal, entropies within 1e-6, or 1e-6 of
  the entropy where that is larger: at C = 1000 the entropy is near 6.9
  and float32 sums over the classes, taken in another order, part by up
  to 1.4e-6 (about 20 ulp).
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.fl as rfl
import repro_torch.fl as tfl
from repro.core import judgment as jjud
from repro.core import strategies as jstrat
from repro.data.partition import partition, stack_clients
from repro.data.synthetic import make_image_dataset
from repro.fl.server import _make_client_fn as j_client_fn
from repro.models import cnn as jcnn
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.core import judgment as tjud
from repro_torch.core import strategies as tstrat
from repro_torch.fl.server import _make_client_fn as t_client_fn
from repro_torch.models import cnn as tcnn

PARAMS_ATOL = 1e-5
VARIATE_ATOL = 1e-4
ENT_ATOL = 1e-6
N, M = 8, 4


@pytest.fixture(scope="module")
def case():
    """The tiny fixture's data, its init params, a second model standing
    for the clients' previous models, and small random control variates."""
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, N, 4, seed=0)
    data = stack_clients(xtr, ytr, parts, batch_multiple=20)
    params = jax.tree.map(np.asarray, jcnn.init(
        jax.random.PRNGKey(0), image_hw=16, num_classes=4))
    prev = jax.tree.map(np.asarray, jcnn.init(
        jax.random.PRNGKey(1), image_hw=16, num_classes=4))
    r = np.random.default_rng(0)
    c_loc = jax.tree.map(
        lambda x: (1e-2 * r.normal(size=(N,) + x.shape)).astype(np.float32),
        params)
    c_glob = jax.tree.map(
        lambda x: (1e-2 * r.normal(size=x.shape)).astype(np.float32), params)
    return data, params, prev, c_loc, c_glob


def _to_torch(tree):
    """A reference-layout params tree, stacked on a leading client axis or
    not, as the port's tensors."""
    leaf = tree["conv1"]["w"]
    if np.ndim(leaf) == 4:
        return cnn_params_from_numpy(tree)
    rows = [cnn_params_from_numpy(jax.tree.map(lambda x: x[i], tree))
            for i in range(np.shape(leaf)[0])]
    return pytree.tree_map(lambda *xs: torch.stack(xs), *rows)


def _to_numpy(tree):
    """The port's params tree (stacked or not) in the reference layout."""
    leaf = tree["conv1"]["w"]
    if leaf.dim() == 4:
        return cnn_params_to_numpy(tree)
    rows = [cnn_params_to_numpy(pytree.tree_map(lambda x: x[i], tree))
            for i in range(leaf.shape[0])]
    return jax.tree.map(lambda *xs: np.stack(xs), *rows)


def _close(got, want, atol, what):
    for (path, g), w in zip(jax.tree_util.tree_leaves_with_path(got),
                            jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=atol,
                                   err_msg=f"{what}{path}")


def _inputs(case, strategy, cohort):
    """(reference args, port args) for ``client_update`` on client 0 or a
    vmapped cohort of the first M clients."""
    data, params, prev, c_loc, c_glob = case
    sl = slice(0, M) if cohort else 0
    d = {k: v[sl] for k, v in data.items()}
    p_prev = jax.tree.map(lambda x: np.stack([x] * M) if cohort else x, prev)
    p_cloc = jax.tree.map(lambda x: x[sl], c_loc)
    ref = [params, d, None, None, None]
    if strategy == "moon":
        ref[2] = p_prev
    else:
        ref[3], ref[4] = p_cloc, c_glob
    port = [None if a is None else
            ({k: torch.from_numpy(np.asarray(v)) for k, v in a.items()}
             if a is d else _to_torch(a)) for a in ref]
    return ref, port


@pytest.mark.parametrize("cohort", [False, True], ids=["one", "cohort"])
@pytest.mark.parametrize("strategy", ["moon", "scaffold"])
def test_client_update_matches_reference(case, strategy, cohort):
    spec_kw = dict(strategy=strategy, epochs=1, batch_size=20)
    jspec, tspec = jstrat.LocalSpec(**spec_kw), tstrat.LocalSpec(**spec_kw)
    ref_args, port_args = _inputs(case, strategy, cohort)
    if cohort:
        axes = (rfl.get("strategy", strategy)(jspec).client_in_axes())
        assert tfl.get("strategy", strategy)(tspec).client_in_axes() == axes
        want = j_client_fn(jcnn.apply, jspec, axes)(*ref_args)
        got = t_client_fn(tcnn.apply, tspec, axes)(*port_args)
    else:
        names = ("prev_params", "c_local", "c_global")
        want = jstrat.client_update(jcnn.apply, *ref_args[:2], jspec,
                                    **dict(zip(names, ref_args[2:])))
        got = tstrat.client_update(tcnn.apply, *port_args[:2], tspec,
                                   **dict(zip(names, port_args[2:])))
    assert set(got) == set(want)
    _close(_to_numpy(got["params"]), want["params"], PARAMS_ATOL, "params")
    np.testing.assert_allclose(got["soft_label"].numpy(),
                               np.asarray(want["soft_label"]), rtol=0,
                               atol=PARAMS_ATOL)
    np.testing.assert_array_equal(got["size"].numpy(),
                                  np.asarray(want["size"]))
    if strategy == "scaffold":
        for key in ("c_local", "c_delta"):
            _close(_to_numpy(got[key]), want[key], VARIATE_ATOL, key)
    # the MOON term moves the update: without prev_params it is FedAvg's
    if strategy == "moon" and not cohort:
        plain = tstrat.client_update(tcnn.apply, *port_args[:2], tspec)
        moved = max(float((a - b).abs().max()) for a, b in zip(
            pytree.tree_leaves(plain["params"]),
            pytree.tree_leaves(got["params"])))
        assert moved > 1e-6


@pytest.mark.parametrize("strategy", ["moon", "scaffold"])
def test_strategy_state_matches_reference(case, strategy):
    """init_state, client_inputs and update_state on the same round
    outputs, for a cohort drawn out of order."""
    _, params, prev, c_loc, c_glob = case
    spec = dict(strategy=strategy)
    jst = rfl.get("strategy", strategy)(jstrat.LocalSpec(**spec))
    tst = tfl.get("strategy", strategy)(tstrat.LocalSpec(**spec))
    assert tst.doubles_uplink == jst.doubles_uplink
    idx = np.array([5, 2, 7, 0])
    js = jst.init_state(params, N)
    ts = tst.init_state(cnn_params_from_numpy(params), N)
    assert set(ts) == set(js)
    for key in js:
        _close(_to_numpy(ts[key]), js[key], 0, f"init {key}")
    r = np.random.default_rng(1)
    rows = jax.tree.map(
        lambda x: r.normal(size=(len(idx),) + x.shape).astype(np.float32),
        params)
    out_j = {"params": rows, "c_local": rows,
             "c_delta": jax.tree.map(lambda x: 0.5 * x, rows)}
    out_t = {k: _to_torch(v) for k, v in out_j.items()}
    for _ in range(2):
        want = jst.client_inputs(js, idx)
        got = tst.client_inputs(ts, idx)
        for w, g in zip(want, got, strict=True):
            if w is None:
                assert g is None
            else:
                _close(_to_numpy(g), w, 0, "client_inputs")
        js = jst.update_state(js, params, out_j, idx, N)
        ts = tst.update_state(ts, cnn_params_from_numpy(params), out_t,
                              idx, N)
        for key in js:
            atol = 1e-7 if key == "c_global" else 0
            _close(_to_numpy(ts[key]), js[key], atol, key)


@pytest.mark.parametrize("eta", [1.0, 0.5])
def test_scaffold_aggregator_matches_reference(case, eta):
    _, params, _, _, _ = case
    r = np.random.default_rng(2)
    stacked = jax.tree.map(
        lambda x: r.normal(size=(M,) + x.shape).astype(np.float32), params)
    sizes = np.array([40, 20, 40, 40], np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    want = rfl.get("aggregator", "scaffold")(eta)(
        params, {"params": stacked}, jnp.asarray(sizes), jnp.asarray(mask))
    got = tfl.ScaffoldAggregator(eta)(
        cnn_params_from_numpy(params), {"params": _to_torch(stacked)},
        torch.from_numpy(sizes), torch.from_numpy(mask))
    _close(_to_numpy(got), want, 1e-6, "aggregate")
    local = tstrat.LocalSpec(scaffold_lr_g=eta)
    assert tfl.ScaffoldAggregator.from_config(None, local).lr_g == eta


def _budget_case(m, c, seed):
    r = np.random.default_rng(seed)
    soft = r.dirichlet(np.full(c, 0.3), size=m).astype(np.float32)
    sizes = r.integers(10, 500, m).astype(np.float32)
    active = (r.random(m) < 0.8).astype(np.float32)
    active[0] = 1.0
    return soft, sizes, active


@pytest.mark.parametrize("m,c,budget", [(10, 10, 3), (10, 10, 10),
                                        (16, 100, 5), (8, 4, 1),
                                        (32, 1000, 12), (5, 10, 9)])
@pytest.mark.parametrize("masked", [False, True])
def test_judge_budgeted_matches_reference(m, c, budget, masked):
    soft, sizes, active = _budget_case(m, c, seed=m * c + budget)
    act = active if masked else None
    want = jjud.judge_budgeted(jnp.asarray(soft), jnp.asarray(sizes),
                               budget,
                               None if act is None else jnp.asarray(act))
    got = tjud.judge_budgeted(torch.from_numpy(soft),
                              torch.from_numpy(sizes), budget,
                              None if act is None else torch.from_numpy(act))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.removal_order is None
    assert int(got.num_removed) == int(want.num_removed)
    for field in ("entropy", "initial_entropy"):
        assert float(getattr(got, field)) == pytest.approx(
            float(getattr(want, field)), abs=ENT_ATOL, rel=ENT_ATOL)


@pytest.mark.parametrize("budget", [1, 3, 10])
def test_budgeted_judge_matches_reference(budget):
    soft, sizes, _ = _budget_case(10, 10, seed=budget)
    want = rfl.BudgetedJudge(budget)(soft.astype(np.float64),
                                     sizes.astype(np.float64))
    got = tfl.BudgetedJudge(budget)(torch.from_numpy(soft),
                                    torch.from_numpy(sizes))
    assert got[:2] == want[:2]
    assert len(got[0]) == budget
    assert got[2] == pytest.approx(want[2], abs=ENT_ATOL)
    assert tfl.get("judge", "budget") is tfl.BudgetedJudge
    with pytest.raises(ValueError, match="needs an explicit budget"):
        tfl.BudgetedJudge.from_config(None, None)


def test_localspec_defaults_and_conflicts():
    want, got = jstrat.LocalSpec(), tstrat.LocalSpec()
    for field in ("lr", "momentum", "epochs", "batch_size", "prox_mu",
                  "moon_mu", "moon_tau", "scaffold_lr_g"):
        assert getattr(got, field) == getattr(want, field)
    with pytest.raises(ValueError, match="conflicts with the 'moon'"):
        tfl.MoonStrategy(tfl.LocalSpec(strategy="scaffold"))
    with pytest.raises(ValueError, match="conflicts with the 'scaffold'"):
        tfl.ScaffoldStrategy(tfl.LocalSpec(strategy="fedprox"))
    assert tfl.MoonStrategy(tfl.LocalSpec()).spec.strategy == "moon"
    assert tfl.ScaffoldStrategy(
        tfl.LocalSpec(strategy="scaffold")).spec.strategy == "scaffold"


def test_registry_round_trips_the_five_compositions():
    assert tfl.names("composition") == ["fedavg", "fedcat", "fedcat+maxent",
                                        "fedentropy", "fedentropy+queue",
                                        "fedentropy-traced", "fedprox",
                                        "fesem", "ifca", "ifca+maxent",
                                        "moon", "scaffold"]
    for name in tfl.names("composition"):
        got, want = tfl.get("composition", name), rfl.get("composition",
                                                           name)
        for axis in ("strategy", "selector", "judge", "aggregator"):
            assert getattr(got, axis) == getattr(want, axis), (name, axis)
            tfl.get(axis, getattr(got, axis))
    assert tfl.get("strategy", "moon") is tfl.MoonStrategy
    assert tfl.get("strategy", "scaffold") is tfl.ScaffoldStrategy
    assert tfl.get("aggregator", "scaffold") is tfl.ScaffoldAggregator
    assert tfl.get("selector", "queue") is tfl.QueueSelector
    assert tfl.get("selector", "catgroups") is tfl.CatGrouper
    assert tfl.get("selector", "catgroups-pools") is tfl.PoolCatGrouper
    assert tfl.get("strategy", "catchain") is tfl.CatChainStrategy
    assert tfl.get("aggregator", "devconcat") is tfl.DeviceConcatAggregator
    assert tfl.get("selector", "pools-traced") is tfl.TracedPoolSelector
