"""The port's queue data plane and drift against the live JAX reference.

``DataQueue``, ``QueueSelector``, the corpus's label statistics, the
queue mask of ``cohort`` and ``drift_schedule`` are numpy control-plane
code (or a gather) and must equal ``repro``'s exactly. The rounds of
``fedentropy+queue`` and of a drifting ``Server`` run on the ``tiny``
fixture of ``tests/test_fl_api.py`` (8 clients, 4 classes, 16x16 images)
with the reference's params converted: the integer records (selected,
positive and negative lists, comm bytes) must be equal; entropy within
1e-6 and the params digest within a relative 1e-5, the tolerances of
``tests/test_torch_server.py`` (the soft labels come out of another
framework's convolutions).
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
from repro.core import pools as jpools
from repro.core.strategies import LocalSpec as JLocalSpec
from repro.data import corpus as jcorpus
from repro.data.partition import drift_schedule as jdrift_schedule
from repro.data.partition import partition, stack_clients
from repro.data.synthetic import make_image_dataset
from repro.models import cnn as jcnn
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core import pools as tpools
from repro_torch.data import corpus as tcorpus
from repro_torch.data.partition import drift_schedule as tdrift_schedule
from repro_torch.models import cnn as tcnn

ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-5


@pytest.fixture(scope="module")
def tiny():
    """Identical to tests/test_fl_api.py's fixture, with the raw split."""
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    data = stack_clients(xtr, ytr, parts, batch_multiple=20)
    params = jcnn.init(jax.random.PRNGKey(0), image_hw=16, num_classes=4)
    return (xtr, ytr), data, params


@pytest.fixture(scope="module")
def dirichlet():
    """Uneven sizes and mixed labels: 12 clients of a Dirichlet split,
    padded to a common length, so sizes, histograms and entropies vary."""
    (xtr, ytr), _ = make_image_dataset(
        num_classes=5, train_per_class=40, test_per_class=5, hw=8,
        noise=0.4, seed=1)
    parts = partition("dirichlet", ytr, 12, 5, seed=3, beta=0.5)
    return stack_clients(xtr, ytr, parts, batch_multiple=10)


def _corpora(data):
    return (jcorpus.ClientCorpus.from_stacked(data),
            tcorpus.ClientCorpus.from_stacked(data, device="cpu"))


# ------------------------------------------------------------- DataQueue

@pytest.mark.parametrize("kw", [
    {}, {"start_frac": 0.1, "rounds_to_full": 37},
    {"growth": "staged"}, {"growth": "staged", "stages": 3,
                           "rounds_to_full": 50, "min_samples": 4},
    {"start_frac": 1.0, "rounds_to_full": 0}])
def test_data_queue_matches_reference(kw):
    want, got = jcorpus.DataQueue(**kw), tcorpus.DataQueue(**kw)
    sizes = np.array([0, 1, 7, 40, 100, 499, 500])
    for r in range(121):
        assert got.frac(r) == want.frac(r)
        np.testing.assert_array_equal(got.active(r, sizes),
                                      want.active(r, sizes))
    with pytest.raises(ValueError, match="linear.*staged"):
        tcorpus.DataQueue(growth="Staged")


# ------------------------------------------------------- corpus statistics

@pytest.mark.parametrize("fixture", ["tiny", "dirichlet"])
def test_corpus_stats_match_reference(request, fixture):
    data = request.getfixturevalue(fixture)
    data = data[1] if fixture == "tiny" else data
    want, got = _corpora(data)
    np.testing.assert_array_equal(got.sizes(), want.sizes())
    for c in (None, 4, 9):
        np.testing.assert_array_equal(got.label_histograms(c),
                                      want.label_histograms(c))
    np.testing.assert_array_equal(got.label_entropy(), want.label_entropy())
    assert got.num_clients == want.num_clients
    assert got.samples_per_client == want.samples_per_client
    for k, v in want.as_numpy().items():
        np.testing.assert_array_equal(got.as_numpy()[k], v)
    # the module functions too, with and without weights
    y, w = np.asarray(data["y"]), np.asarray(data["w"])
    for ww in (None, w):
        h = tpools.label_histograms(y, ww)
        np.testing.assert_array_equal(h, jpools.label_histograms(y, ww))
        assert [tpools.hist_entropy(r) for r in h] == \
            [jpools.hist_entropy(r) for r in h]
    assert tpools.hist_entropy(np.zeros(3)) == 0.0


@pytest.mark.parametrize("idx,active", [
    ([0, 4, 6], [3, 20, 0]), ([7, 1], [60, 1]), ([2, 2, 5], [10, 0, 59])])
def test_cohort_queue_mask_matches_reference(tiny, idx, active):
    want, got = _corpora(tiny[1])
    w_ref = want.cohort(np.asarray(idx), active=np.asarray(active))
    w_got = got.cohort(idx, active=active)
    for k in ("x", "y", "w"):
        np.testing.assert_array_equal(w_got[k].numpy(), np.asarray(w_ref[k]))
    plain = got.cohort(idx)
    np.testing.assert_array_equal(plain["w"].numpy(),
                                  np.asarray(tiny[1]["w"])[idx])


# ---------------------------------------------------------- QueueSelector

@pytest.mark.parametrize("bound", [True, False])
@pytest.mark.parametrize("kw", [
    {"eps": 0.8, "seed": 0}, {"eps": 1.0, "seed": 3},
    {"eps": 0.3, "seed": 7, "fairness": 0.2}])
def test_queue_selector_matches_reference(dirichlet, bound, kw):
    want_c, got_c = _corpora(dirichlet)
    queue = dict(start_frac=0.3, rounds_to_full=6, growth="staged")
    want = rfl.QueueSelector(12, queue=jcorpus.DataQueue(**queue), **kw)
    got = tfl.QueueSelector(12, queue=tcorpus.DataQueue(**queue), **kw)
    assert got.stats() == want.stats()
    if bound:
        want.bind_data(want_c)
        got.bind_data(got_c)
    for r in range(10):
        sel = got.select(5)
        assert sel == want.select(5), r
        w_sched, g_sched = want.data_schedule(sel), got.data_schedule(sel)
        if bound:
            np.testing.assert_array_equal(g_sched, w_sched)
        else:
            assert g_sched is None and w_sched is None
        got.update(sel[:3], sel[3:])
        want.update(sel[:3], sel[3:])
        assert got.stats() == want.stats()


def test_queue_selector_binds_a_raw_dict(dirichlet):
    """A stacked dict binds as the corpus does, in both packages."""
    want = rfl.QueueSelector(12, eps=1.0, seed=0)
    got = tfl.QueueSelector(12, eps=1.0, seed=0)
    want.bind_data(dirichlet)
    got.bind_data(dirichlet)
    for _ in range(4):
        sel = got.select(4)
        assert sel == want.select(4)
        np.testing.assert_array_equal(got.data_schedule(sel),
                                      want.data_schedule(sel))


# ------------------------------------------------------------------ drift

@pytest.mark.parametrize("at,kw", [
    (2, {}), ((1, 4), {"frac": 0.25, "seed": 5}),
    (3, {"case": "case2", "frac": 1.0}),
    ((0, 2), {"case": "dirichlet", "beta": 0.3, "seed": 2})])
def test_drift_schedule_matches_reference(tiny, at, kw):
    (xtr, ytr), data, _ = tiny
    s = int(data["y"].shape[1])
    want = jdrift_schedule(xtr, ytr, 8, 4, at=at, samples_per_client=s,
                           **kw)
    got = tdrift_schedule(xtr, ytr, 8, 4, at=at, samples_per_client=s, **kw)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.round == w.round and g.clients == w.clients
        assert sorted(g.data) == sorted(w.data)
        for k in w.data:
            assert g.data[k].dtype == w.data[k].dtype
            np.testing.assert_array_equal(g.data[k], w.data[k])


def test_drift_schedule_refuses_what_the_reference_refuses(tiny):
    (xtr, ytr), data, _ = tiny
    s = int(data["y"].shape[1])
    for kw, match in [({}, "samples_per_client is required"),
                      ({"samples_per_client": s, "frac": 0.0}, "frac"),
                      ({"samples_per_client": s, "at": (2, 2)},
                       "distinct")]:
        kw = {"at": 2, **kw}
        for fn in (jdrift_schedule, tdrift_schedule):
            with pytest.raises(ValueError, match=match):
                fn(xtr, ytr, 8, 4, **kw)
    with pytest.raises(ValueError, match="distinct"):
        tfl.DriftEvent(round=1, clients=(0, 0), data={})
    with pytest.raises(ValueError, match=">= 0"):
        tfl.DriftEvent(round=-1, clients=(0,), data={})


# ------------------------------------------------------------ full rounds

def _pair(tiny, name, rounds, **kw):
    _, data, params = tiny
    strategy = rfl.get("composition", name).strategy
    ref = rfl.build(name, jcnn.apply, params, data,
                    rfl.ServerConfig(num_clients=8, participation=0.5),
                    JLocalSpec(strategy, epochs=1, batch_size=20), **kw)
    port = tfl.build(name, tcnn.apply,
                     cnn_params_from_numpy(jax.tree.map(np.asarray, params)),
                     data, tfl.ServerConfig(num_clients=8, participation=0.5),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     device="cpu", **kw)
    for _ in range(rounds):
        ref.round()
        port.round()
    return ref, port


def _assert_parity(ref, port):
    for want, got in zip(ref.history, port.history, strict=True):
        assert sorted(got) == sorted(want)          # the same record keys
        for key in ("selected", "positive", "negative", "comm"):
            assert got[key] == want[key], (want["round"], key)
        assert got["entropy"] == pytest.approx(want["entropy"],
                                               abs=ENT_ATOL, nan_ok=True)
    want_digest = sum(float(jnp.sum(jnp.abs(x)))
                      for x in jax.tree.leaves(ref.global_params))
    got_digest = sum(float(x.abs().sum())
                     for x in pytree.tree_leaves(port.global_params))
    assert got_digest == pytest.approx(want_digest, rel=DIGEST_RTOL)


def test_fedentropy_queue_matches_reference(tiny):
    ref, port = _pair(tiny, "fedentropy+queue", 3)
    _assert_parity(ref, port)
    assert port.selector.stats() == ref.selector.stats()
    # the queue withheld data at round 0
    act = port.selector.queue.active(0, port.corpus.sizes())
    assert np.all(act < port.corpus.sizes())


@pytest.mark.parametrize("at", [2, (1, 3)])
def test_drifting_server_matches_reference(tiny, at):
    (xtr, ytr), data, _ = tiny
    s = int(data["y"].shape[1])
    kw = {"samples_per_client": s, "at": at}
    ref, port = _pair(tiny, "fedentropy", 4,
                      drift=jdrift_schedule(xtr, ytr, 8, 4, **kw))
    # the port's events are its own, equal to the reference's (above)
    port2 = tfl.build("fedentropy", port.apply_fn,
                      cnn_params_from_numpy(jax.tree.map(
                          np.asarray, tiny[2])), data,
                      tfl.ServerConfig(num_clients=8, participation=0.5),
                      tfl.LocalSpec(epochs=1, batch_size=20), device="cpu",
                      drift=tdrift_schedule(xtr, ytr, 8, 4, **kw))
    for _ in range(4):
        port2.round()
    _assert_parity(ref, port)
    _assert_parity(ref, port2)
    assert port._drift == [] == ref._drift
    for k, v in ref.corpus.as_numpy().items():
        np.testing.assert_array_equal(port.corpus.as_numpy()[k], v)
    assert not np.array_equal(port.corpus.as_numpy()["y"],
                              np.asarray(data["y"]))


def test_drift_event_validates_sample_length(tiny):
    _, data, params = tiny
    tparams = cnn_params_from_numpy(jax.tree.map(np.asarray, params))
    bad = tfl.DriftEvent(round=1, clients=(0,),
                         data={"y": np.zeros((1, 3), np.int32)})
    with pytest.raises(ValueError, match="sample length"):
        tfl.build("fedentropy", tcnn.apply, tparams, data,
                  tfl.ServerConfig(num_clients=8, participation=0.5),
                  tfl.LocalSpec(epochs=1, batch_size=20), device="cpu",
                  drift=[bad])
    with pytest.raises(ValueError, match="sample length"):
        rfl.build("fedentropy", jcnn.apply, params, data,
                  rfl.ServerConfig(num_clients=8, participation=0.5),
                  JLocalSpec(epochs=1, batch_size=20),
                  drift=[rfl.DriftEvent(round=1, clients=(0,),
                                        data={"y": np.zeros((1, 3),
                                                            np.int32)})])


def test_drift_replaces_rows_on_the_device_copy(tiny):
    """``with_rows`` builds a new corpus; the old one is untouched and the
    signature (the captured program's key) is kept."""
    _, data, _ = tiny
    corpus = tcorpus.ClientCorpus.from_stacked(data, device="cpu")
    rows = {"y": np.full((2, data["y"].shape[1]), 3, np.int64),
            "extra": np.zeros((2, 1))}
    new = corpus.with_rows((1, 5), rows)
    assert new.signature() == corpus.signature()
    np.testing.assert_array_equal(corpus["y"].numpy(), data["y"])
    assert (new["y"][[1, 5]] == 3).all() and new["y"].dtype == torch.int32
    np.testing.assert_array_equal(new["y"][[0, 2]].numpy(),
                                  data["y"][[0, 2]])
    np.testing.assert_array_equal(new["x"].numpy(), data["x"])
