"""The port's threefry stream and traced pools against ``jax.random`` and
``repro``'s traced pools, on the CPU.

``repro_torch.core.threefry`` transcribes JAX's default (partitionable)
threefry: every function must give ``jax.random``'s bits exactly, over
seeds drawn by hypothesis in [0, 2**31). ``pools_draw`` and
``pools_refile`` must give the reference's jitted functions' selection,
key and masks exactly, and ``TracedPoolSelector`` the reference
selector's cohorts, keys and pools over 8 rounds fed the same verdicts.
All integers, so the tolerance is none.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl as rfl
import repro_torch.fl as tfl
from repro.core import pools as jpools
from repro_torch.core import pools as tpools
from repro_torch.core import threefry

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # the property cases skip without hypothesis
    given = None

SEEDS = [0, 1, 5, 123456, 2 ** 31 - 1]


def _np(x) -> np.ndarray:
    return np.asarray(x).astype(np.int64)


def test_jax_default_is_partitionable():
    """The port mirrors the partitionable stream; a JAX whose default
    changed must fail here, not skip."""
    assert jax.config.jax_threefry_partitionable is True


def test_shuffle_rounds():
    assert [threefry.shuffle_rounds(n) for n in (1, 8, 1000, 1600, 2000)] \
        == [0, 1, 1, 1, 2]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split_fixed_seeds(seed):
    key = jax.random.PRNGKey(seed)
    assert np.array_equal(_np(key), threefry.prng_key(seed).numpy())
    for n in (2, 3):
        assert np.array_equal(_np(jax.random.split(key, n)),
                              threefry.split(threefry.prng_key(seed),
                                             n).numpy())


def test_threefry2x32_known_answer():
    """The Random123 known-answer vector JAX's own tests use: key (0x13198a2e,
    0x03707344) over counters (0x243f6a88, 0x85a308d3)."""
    k0, k1 = torch.tensor(0x13198A2E), torch.tensor(0x03707344)
    x0, x1 = threefry.threefry2x32(k0, k1, torch.tensor([0x243F6A88]),
                                   torch.tensor([0x85A308D3]))
    assert (int(x0), int(x1)) == (0xC4923A9C, 0x483DF7A0)


if given is not None:
    _seeds = st.integers(0, 2 ** 31 - 1)

    @settings(max_examples=20, deadline=None)
    @given(seed=_seeds)
    def test_prng_key_split_uniform(seed):
        key, tkey = jax.random.PRNGKey(seed), threefry.prng_key(seed)
        assert np.array_equal(_np(key), tkey.numpy())
        for n in (2, 3):
            assert np.array_equal(_np(jax.random.split(key, n)),
                                  threefry.split(tkey, n).numpy())
        want = np.asarray(jax.random.uniform(key))
        got = threefry.uniform(tkey)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        assert got.numpy().tobytes() == want.tobytes()
        assert 0.0 <= float(got) < 1.0

    @pytest.mark.parametrize("n", [1, 8, 100, 1000, 5000])
    @settings(max_examples=10, deadline=None)
    @given(seed=_seeds)
    def test_random_bits(n, seed):
        want = jax.random.bits(jax.random.PRNGKey(seed), (n,), jnp.uint32)
        got = threefry.random_bits(threefry.prng_key(seed), n)
        assert got.dtype == torch.int64
        assert np.array_equal(_np(want), got.numpy())

    @pytest.mark.parametrize("n", [8, 100, 2000])
    @settings(max_examples=10, deadline=None)
    @given(seed=_seeds)
    def test_permutation(n, seed):
        want = jax.random.permutation(jax.random.PRNGKey(seed), n)
        got = threefry.permutation(threefry.prng_key(seed), n)
        assert np.array_equal(_np(want), got.numpy())
        # choice without replacement is the permutation's head
        m = max(1, n // 3)
        head = jax.random.choice(jax.random.PRNGKey(seed), n, shape=(m,),
                                 replace=False)
        assert np.array_equal(_np(head), got[:m].numpy())

    @settings(max_examples=30, deadline=None)
    @given(data=st.data())
    def test_pools_match_reference(data):
        n = data.draw(st.integers(1, 200), label="n")
        num = data.draw(st.integers(1, n), label="num")
        eps = data.draw(st.sampled_from([0.0, 0.3, 0.8, 1.0]), label="eps")
        seed = data.draw(st.integers(0, 2 ** 31 - 1), label="seed")
        # each client positive, negative, or out of both (drawn, not yet
        # re-filed)
        where = np.asarray(data.draw(st.lists(
            st.sampled_from([0, 1, 2]), min_size=n, max_size=n),
            label="pools"))
        pos = (where == 0).astype(np.float32)
        neg = (where == 1).astype(np.float32)
        sel, key = jpools.pools_draw(jax.random.PRNGKey(seed),
                                     jnp.asarray(pos), jnp.asarray(neg),
                                     num=num, eps=eps)
        tsel, tkey = tpools.pools_draw(threefry.prng_key(seed),
                                       torch.from_numpy(pos),
                                       torch.from_numpy(neg), num=num,
                                       eps=eps)
        assert tsel.dtype == torch.int32
        assert np.array_equal(np.asarray(sel), tsel.numpy())
        assert np.array_equal(_np(key), tkey.numpy())
        admitted = np.asarray(data.draw(st.lists(
            st.sampled_from([0.0, 1.0]), min_size=num, max_size=num),
            label="admitted"), np.float32)
        want = jpools.pools_refile(jnp.asarray(pos), jnp.asarray(neg), sel,
                                   jnp.asarray(admitted))
        got = tpools.pools_refile(torch.from_numpy(pos),
                                  torch.from_numpy(neg), tsel,
                                  torch.from_numpy(admitted))
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            assert np.array_equal(np.asarray(w), g.numpy())
else:
    @pytest.mark.skip(reason="hypothesis is not installed")
    def test_prng_key_split_uniform():
        pass

    @pytest.mark.skip(reason="hypothesis is not installed")
    def test_pools_match_reference():
        pass


@pytest.mark.parametrize("n,num,eps", [(8, 4, 0.8), (100, 10, 0.3),
                                       (200, 200, 1.0), (5, 3, 0.0)])
def test_pools_draw_fixed_cases(n, num, eps):
    rng = np.random.default_rng(n)
    pos = (rng.random(n) < 0.5).astype(np.float32)
    neg = 1.0 - pos
    sel, key = jpools.pools_draw(jax.random.PRNGKey(n), jnp.asarray(pos),
                                 jnp.asarray(neg), num=num, eps=eps)
    tsel, tkey = tpools.pools_draw(threefry.prng_key(n),
                                   torch.from_numpy(pos),
                                   torch.from_numpy(neg), num=num, eps=eps)
    assert np.array_equal(np.asarray(sel), tsel.numpy())
    assert np.array_equal(_np(key), tkey.numpy())
    assert len(set(tsel.tolist())) == num


# ------------------------------------------------------------- selector

def test_traced_pool_selector_matches_reference():
    """8 rounds of select and update on the same verdicts; the pools, the
    key and the fold carry equal after each."""
    ref = rfl.TracedPoolSelector(20, eps=0.8, seed=3)
    port = tfl.TracedPoolSelector(20, eps=0.8, seed=3)
    rng = np.random.default_rng(0)
    for _ in range(8):
        a, b = ref.select(6), port.select(6)
        assert a == b
        admitted = rng.random(6) < 0.6
        pos = [c for c, ok in zip(a, admitted) if ok]
        neg = [c for c, ok in zip(a, admitted) if not ok]
        ref.update(pos, neg)
        port.update(pos, neg)
        assert (ref.positive, ref.negative) == (port.positive, port.negative)
        assert ref.stats() == port.stats()
        key, p, n = ref.fold_carry()
        tkey, tp, tn = port.fold_carry()
        assert np.array_equal(_np(key), tkey.numpy())
        assert np.array_equal(np.asarray(p), tp.numpy())
        assert np.array_equal(np.asarray(n), tn.numpy())
        assert tp.dtype == tn.dtype == torch.float32


def test_traced_pool_selector_fold_surface():
    """``fold_drawn`` of a draw made from the fold carry is ``select``:
    the same pools and key after it; the registry and the config build
    it."""
    a = tfl.TracedPoolSelector(10, eps=0.8, seed=0)
    b = tfl.TracedPoolSelector(10, eps=0.8, seed=0)
    key, pos, neg = a.fold_carry("cpu")
    sel, key_after = tpools.pools_draw(key, pos, neg, num=4, eps=0.8)
    a.fold_drawn(sel.numpy(), key_after.numpy())
    assert b.select(4) == sel.tolist()
    assert (a.positive, a.negative) == (b.positive, b.negative)
    assert torch.equal(a.fold_carry()[0], b.fold_carry()[0])
    assert a.stats() == {"selector": "pools-traced", "positive": 6,
                         "negative": 0}
    assert tfl.get("selector", "pools-traced") is tfl.TracedPoolSelector
    built = tfl.TracedPoolSelector.from_config(
        tfl.ServerConfig(num_clients=12, eps=0.5, seed=7), None)
    assert (built.num_clients, built.eps) == (12, 0.5)
    assert torch.equal(built.fold_carry()[0], threefry.prng_key(7))
    assert tfl.get("composition", "fedentropy-traced") == tfl.Composition(
        strategy="fedavg", selector="pools-traced", judge="maxent")
