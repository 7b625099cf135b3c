"""The port's entropy and judgment modules against the JAX package's.

``judge_np`` is a float64 transcription: its verdicts and entropies must
be exactly equal. The float32 greedy ``judge`` (plain and kernel route)
must give the same masks and removal orders as ``repro``'s
``judge(backend="xla")`` and ``backend="pallas"`` on the cases of
``tests/test_judgment.py``; its entropies agree within 1e-5 (float32
sums taken in another order).
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import entropy as jent
from repro.core import judgment as jjud
from repro_torch.core import entropy as tent
from repro_torch.core import judgment as tjud
from repro_torch.fl import MaxEntropyJudge

ENT_ATOL = 1e-5


def _case(m, c, seed, concentration=0.3):
    r = np.random.default_rng(seed)
    p = r.dirichlet(np.full(c, concentration), size=m)
    sizes = r.integers(10, 500, m).astype(np.float64)
    return p, sizes


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


def _j(a):
    return jnp.asarray(a, jnp.float32)


def test_entropy_functions_match():
    p, sizes = _case(9, 17, 0)
    mask = np.array([1, 0, 1, 1, 1, 0, 1, 1, 1], np.float64)
    for t_fn, j_fn in [(tent.group_entropy, jent.group_entropy),
                       (tent.leave_one_out_entropies,
                        jent.leave_one_out_entropies),
                       (tent.masked_soft_label_mean,
                        jent.masked_soft_label_mean)]:
        got = t_fn(_t(p), _t(sizes), _t(mask)).numpy()
        want = np.asarray(j_fn(_j(p), _j(sizes), _j(mask)))
        np.testing.assert_allclose(got, want, atol=ENT_ATOL)
    np.testing.assert_allclose(tent.entropy(_t(p)).numpy(),
                               np.asarray(jent.entropy(_j(p))),
                               atol=ENT_ATOL)
    np.testing.assert_array_equal(tent.entropy_np(p), jent.entropy_np(p))
    assert tent.group_entropy_np(p, sizes, mask) == \
        jent.group_entropy_np(p, sizes, mask)
    # empty mask -> uniform distribution, entropy ln C
    zero = np.zeros(9)
    assert tent.group_entropy_np(p, sizes, zero) == \
        jent.group_entropy_np(p, sizes, zero)
    np.testing.assert_allclose(
        float(tent.group_entropy(_t(p), _t(sizes), _t(zero))),
        float(jent.group_entropy(_j(p), _j(sizes), _j(zero))), atol=1e-6)


@pytest.mark.parametrize("seed", range(12))
def test_judge_np_exactly_equal(seed):
    r = np.random.default_rng(100 + seed)
    m = 4 + seed % 9
    p, sizes = _case(m, 10, seed)
    active = (r.random(m) < 0.8).astype(np.float64) if seed % 3 else None
    protected = ((r.random(m) < 0.3).astype(np.float64)
                 if seed % 2 else None)
    assert tjud.judge_np(p, sizes, active=active, protected=protected) == \
        jjud.judge_np(p, sizes, active=active, protected=protected)


def _cases():
    """The inputs of tests/test_judgment.py."""
    out = []
    for seed in range(25):                      # jax_matches_oracle
        out.append((*_case(5 + seed % 10, 10, seed), None))
    for seed in range(5):                       # pallas_backend_matches_xla
        out.append((*_case(6 + seed, 12, seed), None))
    p, sizes = _case(8, 10, 3)                  # respects_active_mask
    out.append((p, sizes, np.array([1, 1, 1, 1, 0, 0, 0, 0], np.float64)))
    # never_empty
    out.append((np.eye(6) * 0.999 + 0.001 / 6, np.ones(6), None))
    out.append((np.full((8, 10), 0.1), np.ones(8), None))    # uniform
    maj = np.array([0.85, 0.05, 0.05, 0.05])
    comp = np.array([0.02, 0.32, 0.33, 0.33])
    out.append((np.stack([maj, maj, maj, comp]), np.ones(4), None))
    return out


@pytest.fixture(scope="module")
def reference_verdicts():
    """repro's judge(backend="xla") and ("pallas") on every case, once."""
    out = []
    for p, sizes, active in _cases():
        act = None if active is None else _j(active)
        out.append({jb: jjud.judge(_j(p), _j(sizes), act, backend=jb)
                    for jb in ("xla", "pallas")})
    return out


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_judge_matches_reference_backends(backend, reference_verdicts):
    """backend="cuda" on CPU tensors takes the kernel's plain version."""
    for i, (p, sizes, active) in enumerate(_cases()):
        got = tjud.judge(_t(p), _t(sizes),
                         None if active is None else _t(active),
                         backend=backend)
        for jb, want in reference_verdicts[i].items():
            np.testing.assert_array_equal(got.mask.numpy(),
                                          np.asarray(want.mask),
                                          err_msg=f"case {i} {jb}")
            np.testing.assert_array_equal(got.removal_order.numpy(),
                                          np.asarray(want.removal_order),
                                          err_msg=f"case {i} {jb}")
            assert got.num_removed == int(want.num_removed)
            assert float(got.entropy) == pytest.approx(
                float(want.entropy), abs=ENT_ATOL)
            assert float(got.initial_entropy) == pytest.approx(
                float(want.initial_entropy), abs=ENT_ATOL)


def test_judge_protected_and_cap_match_reference():
    for seed in range(6):
        p, sizes = _case(9, 10, seed)
        prot = np.zeros(9)
        prot[:3] = 1.0
        for cap in (None, 1):
            got = tjud.judge(_t(p), _t(sizes), protected=_t(prot),
                             max_removals=cap)
            want = jjud.judge(_j(p), _j(sizes), protected=_j(prot),
                              max_removals=cap)
            np.testing.assert_array_equal(got.mask.numpy(),
                                          np.asarray(want.mask))
            np.testing.assert_array_equal(got.removal_order.numpy(),
                                          np.asarray(want.removal_order))
            assert not set(got.removal_order.tolist()) & {0, 1, 2}


def test_max_entropy_judge_backends_agree():
    """The numpy judge is the float64 oracle; the float32 routes give the
    same verdicts on these cases."""
    for p, sizes, active in _cases():
        if active is not None:
            continue
        want = jjud.judge_np(p, sizes)
        for backend in ("numpy", "torch", "cuda"):
            a, r, ent = MaxEntropyJudge(backend)(_t(p), _t(sizes))
            assert (a, r) == (want[0], want[1]), backend
            assert ent == pytest.approx(want[2], abs=ENT_ATOL)
    with pytest.raises(ValueError, match="unknown judge backend"):
        MaxEntropyJudge("pallas")


def _loop_cases():
    """(p, sizes, active, protected, cap) beyond _cases(): protected rows
    with and without a cap, an empty active set, one active row, every row
    protected, cap = 0, duplicate rows (a tie goes to the first index) and
    M = 100."""
    out = []
    for seed in range(6):
        p, sizes = _case(9, 10, seed)
        prot = np.zeros(9)
        prot[:3] = 1.0
        for cap in (None, 1):
            out.append((p, sizes, None, prot, cap))
    p, sizes = _case(8, 10, 11)
    one = np.zeros(8)
    one[5] = 1.0
    out += [(p, sizes, np.zeros(8), None, None), (p, sizes, one, None, None),
            (p, sizes, None, np.ones(8), None), (p, sizes, None, None, 0)]
    p, sizes = _case(8, 10, 12)
    p[[1, 6]] = np.eye(10)[3] * 0.91 + 0.01     # two equal outliers
    sizes[[1, 6]] = 300.0
    out.append((p, sizes, None, None, None))
    out.append((p, sizes, np.array([1, 1, 0, 1, 1, 1, 1, 1], np.float64),
                np.array([0, 0, 0, 0, 1, 0, 0, 0], np.float64), 3))
    out.append((*_case(100, 10, 13), None, None, None))
    return out


def _opt(a, conv):
    return None if a is None else conv(a)


def _assert_verdicts_equal(got, want, msg=""):
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask),
                                  err_msg=msg)
    np.testing.assert_array_equal(got.removal_order.numpy(),
                                  np.asarray(want.removal_order),
                                  err_msg=msg)
    assert got.num_removed.dtype == torch.int32
    assert got.num_removed.dim() == 0
    assert int(got.num_removed) == int(want.num_removed), msg
    assert float(got.entropy) == pytest.approx(float(want.entropy),
                                               abs=ENT_ATOL), msg
    assert float(got.initial_entropy) == pytest.approx(
        float(want.initial_entropy), abs=ENT_ATOL), msg


@pytest.mark.parametrize("case", range(len(_cases()) + len(_loop_cases())))
def test_loop_matches_reference_judge(case):
    """The loop's plain version, and judge on both backends with CPU
    tensors, against repro's judge on the xla and the Pallas (interpret
    mode) routes."""
    from repro_torch.kernels.ref import entropy_judge_loop_reference
    cases = [(p, s, a, None, None) for p, s, a in _cases()] + _loop_cases()
    p, sizes, active, prot, cap = cases[case]
    wants = {jb: jjud.judge(_j(p), _j(sizes), _opt(active, _j), cap,
                            backend=jb, protected=_opt(prot, _j))
             for jb in ("xla", "pallas")}
    gots = {"plain loop": tjud.unpack(entropy_judge_loop_reference(
        _t(p), _t(sizes), _opt(active, _t), _opt(prot, _t), cap))}
    for backend in ("torch", "cuda"):
        gots[backend] = tjud.judge(_t(p), _t(sizes), _opt(active, _t), cap,
                                   backend=backend,
                                   protected=_opt(prot, _t))
    for name, got in gots.items():
        for jb, want in wants.items():
            _assert_verdicts_equal(got, want, f"case {case}: {name} vs {jb}")


def test_loop_matches_reference_judge_at_151936_classes():
    """Qwen's vocabulary, the FL-LLM judgment's C, against the xla route
    only (the Pallas interpret route is slow on the CPU at this size)."""
    p, sizes = _case(10, 151936, 7)
    want = jjud.judge(_j(p), _j(sizes), backend="xla")
    for backend in ("torch", "cuda"):
        _assert_verdicts_equal(tjud.judge(_t(p), _t(sizes), backend=backend),
                               want, backend)


def test_max_entropy_judge_copies_once():
    """The judge hands the whole packed result to the host in one copy."""
    calls = []
    real = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        calls.append(self.shape)
        return real(self, *a, **kw)

    p, sizes = _case(8, 10, 4)
    judge = MaxEntropyJudge("torch")
    want = judge(_t(p), _t(sizes))
    torch.Tensor.cpu = counting_cpu
    try:
        got = judge(_t(p), _t(sizes))
    finally:
        torch.Tensor.cpu = real
    assert got == want
    assert calls == [(2 * 8 + 3,)]


def test_time_judge_refuses_the_cpu():
    """The judgment timer measures the card and fails without one."""
    from repro_torch.launch import time_judge
    if torch.cuda.is_available():
        pytest.skip("a card is present: the timer would run")
    assert time_judge.main(["--calls", "1"]) == 1
    with pytest.raises(ValueError, match="CUDA"):
        time_judge.judgment_ms(torch.ones(2, 3), torch.ones(2))
