"""The port's CNN, weight conversion and local update against the JAX
package's, on the CPU.

Tolerances: the forward pass agrees to 1e-5 (float32 convolutions and
products summed in another order); one client's E local epochs agree to
1e-5 in params and soft label.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import strategies as jstrat
from repro.models import cnn as jcnn
from repro_torch.convert import cnn_params_from_numpy, cnn_params_to_numpy
from repro_torch.core import strategies as tstrat
from repro_torch.models import cnn as tcnn

FWD_ATOL = 1e-5


def _jax_params(hw, channels=3, classes=10, seed=0):
    p = jcnn.init(jax.random.PRNGKey(seed), image_hw=hw, channels=channels,
                  num_classes=classes)
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("hw", [16, 32])
def test_apply_matches_reference(hw):
    params = _jax_params(hw)
    x = np.random.default_rng(hw).normal(size=(5, hw, hw, 3)).astype(
        np.float32)
    logits_j, feats_j = jcnn.apply(params, jnp.asarray(x))
    logits_t, feats_t = tcnn.apply(cnn_params_from_numpy(params),
                                   torch.from_numpy(x))
    assert feats_t.shape == (5, 84) and logits_t.shape == (5, 10)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j),
                               atol=FWD_ATOL)
    np.testing.assert_allclose(feats_t.numpy(), np.asarray(feats_j),
                               atol=FWD_ATOL)


def test_param_round_trip_and_shapes():
    params = _jax_params(32)
    back = cnn_params_to_numpy(cnn_params_from_numpy(params))
    for layer in params:
        for k in params[layer]:
            np.testing.assert_array_equal(back[layer][k], params[layer][k])
    # the port's own init has the reference's shapes after conversion
    own = cnn_params_to_numpy(tcnn.init(torch.Generator().manual_seed(0)))
    for layer in params:
        for k in params[layer]:
            assert own[layer][k].shape == params[layer][k].shape
    assert sum(v.size for layer in own.values() for v in layer.values()) \
        == 62006          # the main path's P at 32x32x3, 10 classes
    assert tcnn.init(torch.Generator().manual_seed(0))["fc1"]["w"].equal(
        tcnn.init(torch.Generator().manual_seed(0))["fc1"]["w"])


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(7, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 7).astype(np.int32)
    w = np.array([1, 1, 0, 1, 0, 1, 1], np.float32)
    for weights in (None, w):
        want = jstrat.cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if weights is None else jnp.asarray(weights))
        got = tstrat.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if weights is None else torch.from_numpy(weights))
        assert float(got) == pytest.approx(float(want), abs=1e-6)


@pytest.mark.parametrize("strategy", ["fedavg", "fedprox"])
def test_client_update_matches_reference(strategy):
    """One client, padded tail (w = 0) and a dropped partial minibatch."""
    params = _jax_params(16, classes=4)
    rng = np.random.default_rng(1)
    s = 45                                   # bs 20 -> 2 batches, 5 dropped
    data = {"x": rng.normal(size=(s, 16, 16, 3)).astype(np.float32),
            "y": rng.integers(0, 4, s).astype(np.int32),
            "w": (np.arange(s) < 38).astype(np.float32)}
    kw = dict(strategy=strategy, lr=0.05, momentum=0.5, epochs=2,
              batch_size=20, prox_mu=0.1)
    want = jstrat.client_update(
        jcnn.apply, jax.tree.map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in data.items()},
        jstrat.LocalSpec(**kw))
    got = tstrat.client_update(
        tcnn.apply, cnn_params_from_numpy(params),
        {k: torch.from_numpy(v) for k, v in data.items()},
        tstrat.LocalSpec(**kw))
    assert float(got["size"]) == float(want["size"]) == 38.0
    np.testing.assert_allclose(got["soft_label"].numpy(),
                               np.asarray(want["soft_label"]), atol=1e-5)
    got_p = cnn_params_to_numpy(got["params"])
    for layer, p in want["params"].items():
        for k in p:
            np.testing.assert_allclose(got_p[layer][k], np.asarray(p[k]),
                                       atol=1e-5)
