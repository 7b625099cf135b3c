"""The port's control plane and data plane against the JAX package's:
synthetic data, partitioners, device pools and selectors (exact
transcriptions on numpy RNGs: equal outputs), the resident corpus, and
the aggregation module (float32 tolerance 1e-5, sums in another order;
bf16 leaves compared at bf16 resolution)."""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro.fl as rfl
import repro_torch.fl as tfl
from repro.core import aggregation as jagg
from repro.core.pools import DevicePools as JPools
from repro.data import partition as jpart
from repro.data.corpus import ClientCorpus as JCorpus, Normalize as JNorm
from repro.data.synthetic import make_image_dataset as jmake
from repro_torch.core import aggregation as tagg
from repro_torch.core.pools import DevicePools as TPools
from repro_torch.data import partition as tpart
from repro_torch.data.corpus import ClientCorpus as TCorpus
from repro_torch.data.corpus import Normalize as TNorm
from repro_torch.data.synthetic import make_image_dataset as tmake


@pytest.fixture(scope="module")
def images():
    return jmake(num_classes=5, train_per_class=40, test_per_class=7, hw=8,
                 seed=3)


def test_make_image_dataset_exact(images):
    got = tmake(num_classes=5, train_per_class=40, test_per_class=7, hw=8,
                seed=3)
    for g, w in zip(pytree.tree_leaves(got), pytree.tree_leaves(images)):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


@pytest.mark.parametrize("case", ["case1", "case2", "dirichlet"])
def test_partition_and_stack_exact(images, case):
    (x, y), _ = images
    got = tpart.partition(case, y, 7, 5, seed=1, beta=0.5)
    want = jpart.partition(case, y, 7, 5, seed=1, beta=0.5)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g, w)
    gs = tpart.stack_clients(x, y, got, batch_multiple=4)
    ws = jpart.stack_clients(x, y, want, batch_multiple=4)
    for k in ("x", "y", "w"):
        np.testing.assert_array_equal(gs[k], ws[k])
    with pytest.raises(ValueError, match="unknown heterogeneity case"):
        tpart.partition("case9", y, 7, 5)


def test_device_pools_and_selectors_draw_the_same_cohorts():
    rng = np.random.default_rng(0)
    tp, jp = TPools(30, eps=0.6, seed=4), JPools(30, eps=0.6, seed=4)
    cfg_t = tfl.ServerConfig(num_clients=30, seed=4)
    cfg_j = rfl.ServerConfig(num_clients=30, seed=4)
    sel_t = [tfl.PoolSelector.from_config(cfg_t, None),
             tfl.UniformSelector.from_config(cfg_t, None)]
    sel_j = [rfl.PoolSelector.from_config(cfg_j, None),
             rfl.UniformSelector.from_config(cfg_j, None)]
    for _ in range(15):
        a, b = tp.select(7), jp.select(7)
        assert a == b
        verdict = rng.random(7) < 0.6
        pos = [c for c, v in zip(a, verdict) if v]
        neg = [c for c, v in zip(a, verdict) if not v]
        tp.update(pos, neg)
        jp.update(pos, neg)
        assert tp.stats() == jp.stats()
        for st, sj in zip(sel_t, sel_j):
            a, b = st.select(7), sj.select(7)
            assert a == b
            st.update(a[:4], a[4:])
            sj.update(b[:4], b[4:])
    assert tp.select(100) == jp.select(100)       # clamps to the population


def test_corpus_gather_sizes_and_transform(images):
    (x, y), _ = images
    parts = jpart.partition("dirichlet", y, 6, 5, seed=0, beta=0.5)
    norm_t = TNorm(scale=0.5, mean=(0.1, 0.2, 0.3), std=(1.0, 2.0, 4.0))
    norm_j = JNorm(scale=0.5, mean=(0.1, 0.2, 0.3), std=(1.0, 2.0, 4.0))
    tc = TCorpus.from_parts(x, y, parts, batch_multiple=4, transform=norm_t,
                            device="cpu")
    jc = JCorpus.from_parts(x, y, parts, batch_multiple=4, transform=norm_j)
    np.testing.assert_array_equal(tc.sizes(), jc.sizes())
    assert tc.nbytes == jc.nbytes
    assert [s[:2] for s in tc.signature()[0]] == \
        [s[:2] for s in jc.signature()[0]]
    idx = [4, 0, 5]
    got, want = tc.cohort(idx), jc.cohort(idx)
    for k in ("y", "w"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["x"].numpy(), np.asarray(want["x"]),
                               rtol=1e-6, atol=1e-6)
    assert TCorpus.from_stacked(tc, device="cpu") is tc
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (skipped: a card is present)")
        TCorpus.from_parts(x, y, parts)


def _tree(rng, m):
    return {"conv": {"w": rng.normal(size=(m, 5, 5, 3, 6)).astype(np.float32),
                     "b": rng.normal(size=(m, 6)).astype(np.float32)},
            "fc": {"w": rng.normal(size=(m, 40, 7)).astype(np.float32)}}


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_aggregation_matches_reference(backend):
    rng = np.random.default_rng(7)
    m = 9
    tree = _tree(rng, m)
    sizes = rng.integers(20, 200, m).astype(np.float32)
    mask = rng.integers(0, 2, m).astype(np.float32)
    mask[0] = 1.0
    ttree = pytree.tree_map(torch.from_numpy, tree)
    jtree = jax.tree.map(jnp.asarray, tree)
    ts, tm = torch.from_numpy(sizes), torch.from_numpy(mask)
    js, jm = jnp.asarray(sizes), jnp.asarray(mask)
    want = jagg.masked_mean_tree(jtree, js, jm)
    for got in (tagg.masked_mean_tree(ttree, ts, tm),
                tagg.aggregate(ttree, ts, tm),
                tagg.fused_aggregate(ttree, ts, tm, backend=backend)):
        for layer in want:
            for k in want[layer]:
                assert got[layer][k].shape == want[layer][k].shape
                np.testing.assert_allclose(got[layer][k].numpy(),
                                           np.asarray(want[layer][k]),
                                           rtol=1e-5, atol=1e-5)
    template = pytree.tree_map(lambda t: t[0], ttree)
    jtemplate = jax.tree.map(lambda t: t[0], jtree)
    assert tagg.tree_bytes(template) == jagg.tree_bytes(jtemplate)
    for cv in (False, True):
        assert tagg.comm_bytes(template, 9, 4, 10, control_variate=cv) == \
            jagg.comm_bytes(jtemplate, 9, 4, 10, control_variate=cv)


def test_bf16_leaves_accumulate_in_f32():
    rng = np.random.default_rng(1)
    m = 64
    x = rng.normal(size=(m, 33)).astype(np.float32)
    sizes = np.full(m, 100.0, np.float32)
    mask = np.ones(m, np.float32)
    want = jagg.masked_mean_tree(
        {"a": jnp.asarray(x, jnp.bfloat16)}, jnp.asarray(sizes),
        jnp.asarray(mask))["a"]
    for fn in (tagg.masked_mean_tree, tagg.fused_aggregate):
        got = fn({"a": torch.tensor(x).to(torch.bfloat16)},
                 torch.from_numpy(sizes), torch.from_numpy(mask))["a"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=1e-2, atol=1e-2)
