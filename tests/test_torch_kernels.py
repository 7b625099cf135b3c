"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper takes its plain PyTorch version, which is
held here against ``repro.kernels`` run as ``tests/test_kernels.py`` runs
it (``interpret=True``), on the same numpy inputs. The kernels themselves
run only on a CUDA card: the ``test_card_*`` cases skip without one. They
from _torch_threads import capped_threads  # noqa: F401 (autouse)
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
from repro_torch.core.judgment import judge, unpack
from repro_torch.fl import MaxEntropyJudge
from repro_torch.kernels import entropy_judge
from repro_torch.kernels.entropy_judge import (entropy_judge_loop,
                                               entropy_judge_sweep, plan)
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


@pytest.mark.parametrize("case", ["one row", "sizes zero", "last two"])
def test_entropy_judge_sweep_folded_conventions_plain(pallas, case):
    """The conventions the kernel now applies itself, through the plain
    version on the CPU: one row (its removal empties the set), active rows
    of size 0 (an empty set: ln C, and every removal -1), and a removal
    that leaves one row."""
    m, c = {"one row": (1, 10)}.get(case, (5, 12))
    soft, sizes, mask = _judge_case(m, c, seed=5, mask=np.ones(m))
    if case == "sizes zero":
        sizes[:] = 0.0
    if case == "last two":
        mask[2:] = 0.0
    jnp = pallas.jnp
    ent_j, loo_j = pallas.sweep(jnp.asarray(soft), jnp.asarray(sizes),
                                jnp.asarray(mask), interpret=True)
    ent_t, loo_t = ops.entropy_judge_sweep(
        torch.from_numpy(soft), torch.from_numpy(sizes),
        torch.from_numpy(mask), backend="cuda")
    np.testing.assert_allclose(float(ent_t), float(ent_j), atol=K1_ATOL)
    np.testing.assert_allclose(loo_t.numpy(), np.asarray(loo_j),
                               atol=K1_ATOL)
    if case == "sizes zero":
        assert float(ent_t) == pytest.approx(math.log(c), abs=1e-6)
    want_minus_one = {"one row": [0], "sizes zero": range(m),
                      "last two": []}[case]
    for k in range(m):
        assert (float(loo_t[k]) == -1.0) == (k in want_minus_one), k


def test_entropy_judge_loop_kernel_choice():
    """One warp at the paper's shape; above it the grid kernel, slices of
    1,152 classes (a multiple of 4) on up to 132 CTAs, each CTA's block of
    P resident in shared memory where it fits, streamed where it does not
    (64 rows of 1,152 floats: 294,912 bytes)."""
    assert plan(10, 10)[:2] == ("warp", 1)
    assert plan(32, 32)[:2] == ("warp", 1)
    for (m, c), (ctas, slc, resident) in {
            (100, 10): (1, 12, True), (10, 1024): (1, 1024, True),
            (10, 1025): (1, 1028, True), (32, 4096): (4, 1024, True),
            (10, 151936): (132, 1152, True), (8, 152064): (132, 1152, True),
            (64, 151936): (132, 1152, False)}.items():
        pl = plan(m, c)
        assert (pl.kernel, pl.ctas, pl.slice, pl.resident) == (
            "grid", ctas, slc, resident), (m, c, pl)
        assert pl.smem <= entropy_judge.SMEM_LIMIT
    assert plan(10, 10, 2)[:3] == ("grid", 2, 8)      # forced: the grid
    assert plan(10, 151936, sweep=True)[:4] == ("grid", 132, 1152, False)


@pytest.mark.parametrize("m,c", [(10, 10), (100, 10), (10, 517), (32, 4096),
                                 (10, 151936), (8, 152064), (64, 151936),
                                 (4, 10 ** 6)])
def test_entropy_judge_plan_depends_on_shape_alone(monkeypatch, m, c):
    """The plan reads nothing of the card: the same plan with CUDA made
    unreachable, and it covers C exactly (every CTA owns classes, the
    slices 16-byte multiples, at most 132 CTAs, the shared memory within
    a block's limit)."""
    want = [plan(m, c), plan(m, c, sweep=True)]

    def unreachable(*a, **k):
        raise AssertionError("the plan asked the card")
    plan.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "get_device_properties", unreachable)
    monkeypatch.setattr(torch.cuda, "device_count", unreachable)
    assert [plan(m, c), plan(m, c, sweep=True)] == want
    for pl in want[1:] + want[:1]:
        if pl.kernel == "warp":
            continue
        assert pl.slice % 4 == 0 and 1 <= pl.ctas <= entropy_judge.MAX_CTAS
        assert (pl.ctas - 1) * pl.slice < c <= pl.ctas * pl.slice
        assert pl.smem <= entropy_judge.SMEM_LIMIT


@pytest.mark.parametrize("m,c,ctas", [(10, 151936, 0), (10, 151936, 133),
                                      (10, 10, 4), (4, 6, 3)])
def test_entropy_judge_loop_forced_ctas_outside_the_plan_raise(m, c, ctas):
    """A forced CTA count the plan could not choose raises, on the CPU as
    on the card, before anything runs."""
    soft, sizes, _ = _judge_case(m, c, seed=1)
    before = entropy_judge_loop.launches
    with pytest.raises(ValueError, match="CTAs"):
        entropy_judge_loop(torch.from_numpy(soft), torch.from_numpy(sizes),
                           _ctas=ctas)
    assert entropy_judge_loop.launches == before


def test_entropy_judge_cpu_wrappers_launch_nothing():
    """On the CPU both wrappers take their plain versions, a forced CTA
    count and bfloat16 included, and count no launch."""
    soft, sizes, mask = (torch.from_numpy(a)
                         for a in _judge_case(8, 300, seed=4))
    counts = entropy_judge_loop.launches, entropy_judge_sweep.launches
    got = entropy_judge_loop(soft, sizes, _ctas=2)
    assert torch.equal(got.view(torch.int32),
                       ref.entropy_judge_loop_reference(soft, sizes)
                       .view(torch.int32))
    ent, loo = entropy_judge_sweep(soft.to(torch.bfloat16), sizes, mask)
    want = ref.entropy_judge_sweep_reference(soft.to(torch.bfloat16), sizes,
                                             mask)
    assert torch.equal(ent, want[0]) and torch.equal(loo, want[1])
    assert (entropy_judge_loop.launches,
            entropy_judge_sweep.launches) == counts


def test_entropy_judge_loop_plain_packs_the_kernel_layout():
    """On the CPU the loop wrapper takes its plain version (no launch) and
    returns the kernel's packed layout: mask | order (int32) | removed
    (int32) | entropy | initial entropy."""
    soft, sizes, _ = _judge_case(6, 10, seed=2)
    soft[[1, 4]] = np.eye(10, dtype=np.float32)[7] * 0.91 + 0.009
    sizes[[1, 4]] = 400.0
    before = entropy_judge_loop.launches
    buf = entropy_judge_loop(torch.from_numpy(soft),
                             torch.from_numpy(sizes))
    assert entropy_judge_loop.launches == before
    assert buf.dtype == torch.float32 and buf.shape == (2 * 6 + 3,)
    mask, order, removed, ent, init = ref.unpack_judgment(buf)
    res = judge(torch.from_numpy(soft), torch.from_numpy(sizes))
    # compared as bits: the int32 -1 pad reads as a float NaN
    assert torch.equal(buf.view(torch.int32), ref.pack_judgment(
        res.mask, res.removal_order, int(res.num_removed), res.entropy,
        res.initial_entropy).view(torch.int32))
    n = int(removed)
    assert order[:2].tolist() == [1, 4]       # the tie goes to row 1 first
    assert n >= 2 and (order[n:] == -1).all()
    assert mask[order[:n].long()].eq(0).all() and int(mask.sum()) == 6 - n
    assert float(ent) > float(init)


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
    (16, 1000, torch.bfloat16), (8, 152064, torch.bfloat16)])
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


def _loop_case(m, c, seed, dev):
    """Soft labels and sizes with rows 1 and m - 1 equal outliers (their
    leave-one-out entropies tie; the first index must win), and, by seed:
    0 all active, nothing protected, no cap; 1 random active and protected
    rows; 2 protected rows and a cap of 2."""
    rng = np.random.default_rng(1000 + seed)
    soft, sizes, _ = _judge_case(m, c, seed=m + seed)
    if m > 2:
        soft[[1, m - 1]] = 0.1 / c
        soft[[1, m - 1], 3] += 0.9
        sizes[[1, m - 1]] = 450.0
    active = protected = cap = None
    if seed == 1:
        active = (rng.random(m) < 0.8).astype(np.float32)
        active[[0, 1, m - 1]] = 1.0
    if seed >= 1:
        protected = (rng.random(m) < 0.2).astype(np.float32)
        protected[[1, m - 1]] = 0.0
    if seed == 2:
        cap = 2
    t = lambda a: None if a is None else torch.tensor(a, device=dev)
    return t(soft), t(sizes), t(active), t(protected), cap


def _assert_same_verdicts(got, want, msg=""):
    g, w = unpack(got), unpack(want)
    assert torch.equal(g.mask, w.mask), msg
    assert torch.equal(g.removal_order, w.removal_order), msg
    assert int(g.num_removed) == int(w.num_removed), msg
    for a, b in ((g.entropy, w.entropy),
                 (g.initial_entropy, w.initial_entropy)):
        assert abs(float(a) - float(b)) <= K1_ATOL, (msg, float(a), float(b))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("m,c", [(10, 10), (8, 10), (100, 10), (16, 1000),
                                 (10, 517), (32, 4096), (10, 151936),
                                 (64, 151936)])
def test_card_entropy_judge_loop_matches_plain(cuda, m, c, seed):
    args = _loop_case(m, c, seed, cuda)
    before = entropy_judge_loop.launches
    got = entropy_judge_loop(*args)
    want = ref.entropy_judge_loop_reference(*args)
    torch.cuda.synchronize()
    assert entropy_judge_loop.launches == before + 1
    _assert_same_verdicts(got, want, f"({m}, {c}) seed {seed}")


@pytest.mark.parametrize("ctas", [1, 2, 4, 8, 16, 33, 66, 132])
def test_card_entropy_judge_loop_grid_sizes(cuda, ctas):
    """Each grid size, forced, gives the plain version's verdicts at
    151,936 classes: 1-16 CTAs stream their slices, 33-132 hold them."""
    args = _loop_case(10, 151936, 0, cuda)
    assert plan(10, 151936, ctas).resident == (ctas >= 33)
    got = entropy_judge_loop(*args, _ctas=ctas)
    want = ref.entropy_judge_loop_reference(*args)
    torch.cuda.synchronize()
    assert int(unpack(got).num_removed) >= 2
    _assert_same_verdicts(got, want, f"{ctas} CTAs")


@pytest.mark.parametrize("cluster", [None, 1, 2])
@pytest.mark.parametrize("seed", range(3))
def test_card_entropy_judge_loop_paper_shape_both_kernels(cuda, seed,
                                                          cluster):
    """At (10, 10) the loop takes the warp route; a forced grid of 1 or 2
    CTAs runs the grid kernel. All give the plain version's verdicts."""
    assert plan(10, 10, cluster).kernel == ("warp" if cluster is None
                                            else "grid")
    args = _loop_case(10, 10, seed, cuda)
    got = entropy_judge_loop(*args, _ctas=cluster)
    want = ref.entropy_judge_loop_reference(*args)
    torch.cuda.synchronize()
    _assert_same_verdicts(got, want, f"seed {seed} CTAs {cluster}")


@pytest.mark.parametrize("m,c", [(10, 10), (100, 10), (10, 151936),
                                 (64, 151936)])
def test_card_entropy_judge_loop_same_bits(cuda, m, c):
    args = _loop_case(m, c, 1, cuda)
    first = entropy_judge_loop(*args)
    second = entropy_judge_loop(*args)
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def _cuda_kernels(fn, tries: int = 3) -> list[str]:
    """Names of the kernels ``fn`` launches, by torch.profiler; a profile
    that recorded no kernel at all is taken again, up to ``tries`` times
    (the profiler now and then drops a whole trace)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    names = []
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and "emcpy" not in e.name and "emset" not in e.name]
        if names:
            break
    return names


def test_card_judge_is_one_launch_without_a_host_read(cuda):
    """judge(backend="cuda") launches the loop kernel once, the sweep
    never, and makes no synchronising call before it returns;
    MaxEntropyJudge makes one more (its one copy to the host)."""
    soft, sizes, _, _, _ = _loop_case(10, 10, 0, cuda)
    judge(soft, sizes, backend="cuda")           # built and bound
    torch.cuda.synchronize()
    loops, sweeps = entropy_judge_loop.launches, entropy_judge_sweep.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = judge(soft, sizes, backend="cuda")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert entropy_judge_loop.launches == loops + 1
    assert entropy_judge_sweep.launches == sweeps
    assert res.mask.is_cuda and res.num_removed.dtype == torch.int32
    kernels = _cuda_kernels(lambda: judge(soft, sizes, backend="cuda"))
    assert len(kernels) == 1 and "judge_loop" in kernels[0], kernels
    # counted from here: _cuda_kernels judges again when the profiler drops
    # a whole trace
    loops = entropy_judge_loop.launches
    accepted, rejected, ent = MaxEntropyJudge("cuda")(soft, sizes)
    assert entropy_judge_loop.launches == loops + 1
    assert entropy_judge_sweep.launches == sweeps
    want = unpack(ref.entropy_judge_loop_reference(soft, sizes).cpu())
    assert rejected == [k for k in want.removal_order.tolist() if k >= 0]
    assert accepted == [i for i, v in enumerate(want.mask.tolist()) if v]


def test_card_entropy_judge_sweep_is_one_launch_at_paper_shape(cuda):
    soft, sizes, mask = (torch.tensor(a, device=cuda)
                         for a in _judge_case(10, 10, seed=1))
    entropy_judge_sweep(soft, sizes, mask)
    kernels = _cuda_kernels(lambda: entropy_judge_sweep(soft, sizes, mask))
    assert kernels == [k for k in kernels if "judge_loop_grid" in k]
    assert len(kernels) == 1, kernels


def test_card_entropy_judge_sweep_is_one_launch_at_qwen_vocabulary(cuda):
    """At 152,064 classes in bfloat16 the sweep is one launch of the grid
    kernel (132 CTAs), within K1_ATOL of its plain version."""
    soft, sizes, mask = _judge_case(8, 152064, seed=8)
    soft = torch.tensor(soft, dtype=torch.bfloat16, device=cuda)
    sizes, mask = torch.tensor(sizes, device=cuda), torch.tensor(mask,
                                                                 device=cuda)
    ent, loo = entropy_judge_sweep(soft, sizes, mask)
    ent_p, loo_p = ref.entropy_judge_sweep_reference(soft, sizes, mask)
    torch.testing.assert_close(ent, ent_p, rtol=0, atol=K1_ATOL)
    torch.testing.assert_close(loo, loo_p, rtol=0, atol=K1_ATOL)
    kernels = _cuda_kernels(lambda: entropy_judge_sweep(soft, sizes, mask))
    assert len(kernels) == 1 and "judge_loop_grid" in kernels[0], kernels


@pytest.mark.parametrize("case", ["single", "empty"])
def test_card_entropy_judge_sweep_conventions(cuda, case):
    mask = np.zeros(10, np.float32)
    if case == "single":
        mask[3] = 1.0
    for c in (10, 4096):                 # one CTA, and four
        args = [torch.tensor(a, device=cuda)
                for a in _judge_case(10, c, seed=2, mask=mask)]
        ent, loo = entropy_judge_sweep(*args)
        ent_p, loo_p = ref.entropy_judge_sweep_reference(*args)
        torch.testing.assert_close(ent, ent_p, rtol=0, atol=K1_ATOL)
        torch.testing.assert_close(loo, loo_p, rtol=0, atol=K1_ATOL)
        if case == "single":
            assert float(loo[3]) == -1.0
        else:
            assert float(ent) == pytest.approx(math.log(c), abs=1e-6)
            assert bool((loo == -1.0).all())


def test_card_entropy_judge_loop_rejects_what_it_does_not_take(cuda):
    soft = torch.rand(4, 10, device=cuda)
    with pytest.raises(TypeError):
        entropy_judge_loop(soft.to(torch.bfloat16), torch.ones(4))
    with pytest.raises(ValueError, match="contiguous"):
        entropy_judge_loop(torch.rand(10, 4, device=cuda).t(), torch.ones(4))
    with pytest.raises(ValueError, match="CTAs"):
        entropy_judge_loop(soft, torch.ones(4), _ctas=133)
    with pytest.raises(ValueError, match="active"):
        entropy_judge_loop(soft, torch.ones(4), torch.ones(3))
