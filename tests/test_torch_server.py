"""The port's ``fl.build`` round against the live JAX ``repro.fl.build``.

The ``tiny`` fixture of ``tests/test_fl_api.py`` (8 clients, 4 classes,
16x16 images), the same params converted from ``repro``, 3 rounds on the
CPU. The integer records — selected, positive and negative lists and the
comm bytes — must be equal. Float records carry measured tolerances:
per-round entropy within 1e-6 (measured: at most 1e-8), params digest
within a relative 1e-5 (measured: at most 3e-7); both differ only by
float32 convolutions and sums taken in another order. SCAFFOLD's server
variate ``c_global`` is held within 1e-5 absolute (measured: at most
7.5e-7): its rows divide the params' change by K * lr = 0.02, so those
float32 differences grow 50x.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from torch.utils import _pytree as pytree

import repro.fl as rfl
import repro_torch.fl as tfl
from repro.core.strategies import LocalSpec as JLocalSpec
from repro.data.partition import partition, stack_clients
from repro.data.synthetic import make_image_dataset
from repro.models import cnn as jcnn
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.models import cnn as tcnn

ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-5
VARIATE_ATOL = 1e-5
ROUNDS = 3


@pytest.fixture(scope="module")
def tiny():
    """Identical to tests/test_fl_api.py's fixture."""
    (xtr, ytr), (xte, yte) = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    data = stack_clients(xtr, ytr, parts, batch_multiple=20)
    params = jcnn.init(jax.random.PRNGKey(0), image_hw=16, num_classes=4)
    return data, params, (xte, yte)


def _run_pair(tiny, name, jax_kw=None, torch_kw=None):
    data, params, _ = tiny
    strategy = rfl.get("composition", name).strategy
    ref = rfl.build(name, jcnn.apply, params, data,
                    rfl.ServerConfig(num_clients=8, participation=0.5),
                    JLocalSpec(strategy, epochs=1, batch_size=20),
                    **(jax_kw or {}))
    port = tfl.build(name, tcnn.apply,
                     cnn_params_from_numpy(jax.tree.map(np.asarray, params)),
                     data, tfl.ServerConfig(num_clients=8, participation=0.5),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     device="cpu", **(torch_kw or {}))
    for _ in range(ROUNDS):
        ref.round()
        port.round()
    return ref, port


def _assert_parity(ref, port):
    for want, got in zip(ref.history, port.history, strict=True):
        for key in ("selected", "positive", "negative", "comm"):
            assert got[key] == want[key], (want["round"], key)
        if np.isnan(want["entropy"]):
            assert np.isnan(got["entropy"])
        else:
            assert got["entropy"] == pytest.approx(want["entropy"],
                                                   abs=ENT_ATOL)
    want_digest = sum(float(jnp.sum(jnp.abs(x)))
                      for x in jax.tree.leaves(ref.global_params))
    got_digest = sum(float(x.abs().sum())
                     for x in pytree.tree_leaves(port.global_params))
    assert got_digest == pytest.approx(want_digest, rel=DIGEST_RTOL)


@pytest.mark.parametrize("name", ["fedentropy", "fedavg", "fedprox",
                                  "moon", "scaffold"])
def test_build_matches_live_reference(tiny, name):
    ref, port = _run_pair(tiny, name)
    _assert_parity(ref, port)
    if name == "fedentropy":
        assert any(h["negative"] for h in port.history)   # judgment bites
    if name == "scaffold":
        for want, got in zip(jax.tree.leaves(ref.state["c_global"]),
                             jax.tree.leaves(cnn_params_to_numpy(
                                 port.state["c_global"])), strict=True):
            np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                                       atol=VARIATE_ATOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fedentropy_float32_judge_and_fused_aggregator(tiny, backend):
    """The device routes of steps 4-5 (on CPU tensors the "cuda" route
    takes the kernels' plain versions) against repro's xla judge and
    fused aggregator."""
    ref, port = _run_pair(
        tiny, "fedentropy",
        jax_kw=dict(judge=rfl.MaxEntropyJudge(backend="xla"),
                    aggregator=rfl.get("aggregator", "fused")()),
        torch_kw=dict(judge=tfl.MaxEntropyJudge(backend=backend),
                      aggregator=tfl.FusedAverageAggregator(backend=backend)))
    _assert_parity(ref, port)


def test_evaluate_matches_reference(tiny):
    ref, port = _run_pair(tiny, "fedavg")
    xte, yte = tiny[2]
    want = ref.evaluate(jnp.asarray(xte), jnp.asarray(yte), batch=16)
    got = port.evaluate(xte, yte, batch=16)
    assert got["accuracy"] == want["accuracy"]
    assert got["loss"] == pytest.approx(want["loss"], abs=1e-5)
    with pytest.raises(ValueError, match="empty eval set"):
        port.evaluate(xte[:0], yte[:0])


def test_registry_surface():
    assert tfl.names("composition") == ["fedavg", "fedcat", "fedcat+maxent",
                                        "fedentropy", "fedentropy+queue",
                                        "fedentropy-traced", "fedprox",
                                        "fesem", "ifca", "ifca+maxent",
                                        "moon", "scaffold"]
    assert tfl.names("composition") == rfl.names("composition")
    with pytest.raises(KeyError, match="no composition registered"):
        tfl.get("composition", "nope")
    want = rfl.get("composition", "fedcat")
    assert want.cluster is None and tfl.get("composition", "fedcat") == \
        tfl.Composition(want.strategy, want.selector, want.judge,
                        want.aggregator)
    assert tfl.get("judge", "maxent") is tfl.MaxEntropyJudge
    assert tfl.get("aggregator", "fused") is tfl.FusedAverageAggregator
    with pytest.raises(ValueError, match="unknown kind"):
        tfl.register("flavor", "vanilla", object())
    with pytest.raises(ValueError, match="conflicts with the 'fedprox'"):
        tfl.FedProxStrategy(tfl.LocalSpec(strategy="moon"))
    for n, c in [(25, 0.1), (100, 0.1), (8, 0.5), (3, 0.01)]:
        assert tfl.ServerConfig(num_clients=n, participation=c) \
            .cohort_size() == rfl.ServerConfig(
                num_clients=n, participation=c).cohort_size()
