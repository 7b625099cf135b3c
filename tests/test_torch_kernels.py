"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper takes its plain PyTorch version, which is
held here against ``repro.kernels`` run as ``tests/test_kernels.py`` runs
it (``interpret=True``), on the same numpy inputs. The kernels themselves
run only on a CUDA card: the ``test_card_*`` cases skip without one. They
import nothing of JAX, so on a machine with a card and without JAX they
run alone::

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels.py -k card
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels._build import SOURCES, library_path
from repro_torch.kernels.entropy_judge import entropy_judge_sweep
from repro_torch.kernels.fused_aggregate import masked_weighted_sum

K1_ATOL = 1e-4        # tests/test_kernels.py's tolerance for this kernel


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's kernels and jnp (imported here, not at the top,
    so the card cases run where JAX is not installed)."""
    import jax.numpy as jnp
    from repro.kernels.entropy_judge import entropy_judge_sweep
    from repro.kernels.fused_aggregate import masked_weighted_sum
    return SimpleNamespace(jnp=jnp, sweep=entropy_judge_sweep,
                           mws=masked_weighted_sum)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _judge_case(m, c, seed, mask=None):
    rng = np.random.default_rng(seed)
    soft = rng.dirichlet(np.full(c, 0.3), size=m).astype(np.float32)
    sizes = rng.integers(10, 500, m).astype(np.float32)
    if mask is None:
        mask = (rng.random(m) < 0.7).astype(np.float32)
        mask[0] = 1.0
    return soft, sizes, np.asarray(mask, np.float32)


@pytest.mark.parametrize("m,c", [(8, 10), (16, 1000), (10, 517),
                                 (32, 4096)])
def test_entropy_judge_plain_matches_pallas(pallas, m, c):
    soft, sizes, mask = _judge_case(m, c, seed=m + c)
    jnp = pallas.jnp
    ent_j, loo_j = pallas.sweep(jnp.asarray(soft), jnp.asarray(sizes),
                                jnp.asarray(mask), block_c=128,
                                interpret=True)
    before = entropy_judge_sweep.launches
    ent_t, loo_t = entropy_judge_sweep(torch.from_numpy(soft),
                                       torch.from_numpy(sizes),
                                       torch.from_numpy(mask))
    assert entropy_judge_sweep.launches == before   # CPU: no kernel
    np.testing.assert_allclose(float(ent_t), float(ent_j), atol=K1_ATOL)
    np.testing.assert_allclose(loo_t.numpy(), np.asarray(loo_j),
                               atol=K1_ATOL)


@pytest.mark.parametrize("case", ["single", "empty"])
def test_entropy_judge_emptying_conventions(pallas, case):
    """A removal that empties the set gives -1.0; an empty set ln C."""
    m, c = 6, 10
    mask = np.zeros(m, np.float32)
    if case == "single":
        mask[2] = 1.0
    soft, sizes, mask = _judge_case(m, c, seed=3, mask=mask)
    jnp = pallas.jnp
    ent_j, loo_j = pallas.sweep(jnp.asarray(soft), jnp.asarray(sizes),
                                jnp.asarray(mask), interpret=True)
    ent_t, loo_t = ops.entropy_judge_sweep(
        torch.from_numpy(soft), torch.from_numpy(sizes),
        torch.from_numpy(mask), backend="cuda")
    np.testing.assert_allclose(float(ent_t), float(ent_j), atol=K1_ATOL)
    np.testing.assert_allclose(loo_t.numpy(), np.asarray(loo_j),
                               atol=K1_ATOL)
    if case == "single":
        assert loo_t[2] == -1.0
    else:
        assert float(ent_t) == pytest.approx(math.log(c), abs=1e-6)
        assert bool((loo_t == -1.0).all())


@pytest.mark.parametrize("m,p,block_m", [(10, 4099, None), (3, 1, None),
                                         (13, 700, 4)])
def test_masked_weighted_sum_plain_matches_pallas(pallas, m, p, block_m):
    """Includes M not a multiple of the Pallas client tile (13 vs 4)."""
    rng = np.random.default_rng(m * p)
    flat = rng.normal(size=(m, p)).astype(np.float32)
    w = (rng.integers(20, 200, m) * rng.integers(0, 2, m)).astype(np.float32)
    jnp = pallas.jnp
    want = pallas.mws(jnp.asarray(flat), jnp.asarray(w), block_p=256,
                      block_m=block_m, interpret=True)
    before = masked_weighted_sum.launches
    got = masked_weighted_sum(torch.from_numpy(flat), torch.from_numpy(w))
    assert masked_weighted_sum.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_ops_rejects_unknown_backend():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.masked_weighted_sum(x, torch.ones(2), backend="pallas")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.entropy_judge_sweep(x, torch.ones(2), torch.ones(2),
                                backend="xla")


def test_library_path_follows_source():
    """Each source has its own library, named by a hash of its content."""
    paths = {library_path(name) for name in SOURCES}
    assert len(paths) == len(SOURCES)
    assert all(p.suffix == ".so" and p.parent.name == "_build"
               for p in paths)
    assert library_path(SOURCES[0]) == library_path(SOURCES[0])


# ------------------------------------------------------------- card only

@pytest.mark.parametrize("m,c,dtype", [
    (10, 10, torch.float32), (16, 1000, torch.float32),
    (32, 4096, torch.float32), (10, 151936, torch.float32),
    (16, 1000, torch.bfloat16)])
def test_card_entropy_judge_kernel_matches_plain(cuda, m, c, dtype):
    soft, sizes, mask = _judge_case(m, c, seed=m)
    args = (torch.tensor(soft, dtype=dtype, device=cuda),
            torch.tensor(sizes, device=cuda), torch.tensor(mask, device=cuda))
    before = entropy_judge_sweep.launches
    ent_k, loo_k = entropy_judge_sweep(*args)
    ent_p, loo_p = ref.entropy_judge_sweep_reference(*args)
    torch.cuda.synchronize()
    assert entropy_judge_sweep.launches == before + 1
    torch.testing.assert_close(ent_k, ent_p, rtol=0, atol=K1_ATOL)
    torch.testing.assert_close(loo_k, loo_p, rtol=0, atol=K1_ATOL)


@pytest.mark.parametrize("m,p", [(10, 62006), (3, 1), (16, 1 << 20),
                                 (300, 4099), (1, 62006), (17, 62006)])
def test_card_masked_weighted_sum_kernel_matches_plain(cuda, m, p):
    gen = torch.Generator(device=cuda).manual_seed(0)
    flat = torch.rand((m, p), generator=gen, device=cuda)
    w = torch.rand(m, generator=gen, device=cuda)
    before = masked_weighted_sum.launches
    got = masked_weighted_sum(flat, w)
    want = ref.masked_weighted_sum_reference(flat, w)
    torch.cuda.synchronize()
    assert masked_weighted_sum.launches == before + 1
    # the kernel adds rows in order with each product rounded first, the
    # plain version's arithmetic: equal bit for bit
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_card_kernel_wrappers_reject_what_they_do_not_take(cuda):
    with pytest.raises(TypeError):
        masked_weighted_sum(torch.zeros(2, 3, dtype=torch.float64,
                                        device=cuda), torch.ones(2))
    with pytest.raises(ValueError, match="contiguous"):
        masked_weighted_sum(torch.zeros(3, 2, device=cuda).t(),
                            torch.ones(2))
    with pytest.raises(TypeError):
        entropy_judge_sweep(torch.zeros(2, 3, dtype=torch.float16,
                                        device=cuda),
                            torch.ones(2), torch.ones(2))
