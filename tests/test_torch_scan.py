"""The port's scan engine (``repro_torch.fl.runtime.ScanServer``) against
the sequential ``Server`` and the live reference.

On the ``tiny`` fixture of ``tests/test_fl_api.py`` (8 clients, 4 classes,
16x16 images) with the reference's params converted, on the CPU, where
the block runs eagerly (K1 and K2 take their plain versions):

* ``ScanServer`` equals the port's sequential ``Server`` bit for bit
  (records, entropy and params) for ``fedavg`` at R in {1, 4},
  ``fedentropy`` on the uniform selector, ``fedentropy-traced`` in both
  memory modes with and without a forced miss, on both speculation
  backends;
* it gives the live reference ``ScanServer``'s records (run as
  ``tests/test_scan_engine.py`` runs it): ``selected``, ``positive``,
  ``negative``, ``comm``, ``spec_hit`` and ``redispatched`` exact, the
  entropy within 1e-6 and the params digest within a relative 1e-6
  (float32 convolutions and sums in another order); with
  ``selection="device"`` its cohorts are the reference's device stream;
* ``ScanConfig``, the routing and the registry behave as the
  reference's.

Each run that several cases compare against is made once per module:
the reference's (``reference``), the port's sequential servers
(``sequential``) and its scan servers (``scanned``); the cases only read
them. ``tests/test_torch_scan_blocks.py`` holds the forced misses and
rewinds, the block-graph cache, the fallbacks and the card cases, on
these helpers.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.aggregation import tree_bytes
from repro_torch.data.corpus import ClientCorpus
from repro_torch.data.partition import partition, stack_clients
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.runtime import RuntimeConfig, ScanConfig, ScanServer
from repro_torch.models import cnn as tcnn

ROUNDS = 8               # two blocks of 4
ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-6


def _split():
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    return (xtr, ytr), stack_clients(xtr, ytr, parts, batch_multiple=20)


@pytest.fixture(scope="module")
def tiny():
    """The fixture with the reference's init params (jax) and their
    conversion (port)."""
    jax = pytest.importorskip("jax")
    from repro.models import cnn as jcnn
    params = jcnn.init(jax.random.PRNGKey(0), image_hw=16, num_classes=4)
    split, data = _split()
    return (split, data,
            cnn_params_from_numpy(jax.tree.map(np.asarray, params)), params)


def _config(**kw):
    return tfl.ServerConfig(num_clients=8, participation=0.5, seed=0, **kw)


def _port(tiny, name="fedavg", device="cpu", config=None, **kw):
    _, data, params, _ = tiny
    strategy = tfl.get("composition", name).strategy
    return tfl.build(name, tcnn.apply, params, data, config or _config(),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     device=device, **kw)


def _scan(tiny, name="fedavg", r=4, **kw):
    cfg = {k: kw.pop(k) for k in ("params_mode", "selection",
                                  "spec_backend") if k in kw}
    return _port(tiny, name, engine="scan",
                 runtime=ScanConfig(rounds_per_scan=r, **cfg), **kw)


def _run(server, rounds=ROUNDS):
    for _ in range(rounds):
        server.round()
    return server


@pytest.fixture(scope="module")
def reference(tiny):
    """``reference(label, name, runtime, **kw)``: the live reference
    ``ScanServer``'s history and params digest after ``ROUNDS`` rounds,
    run once per label for the module."""
    import repro.fl as rfl
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.models import cnn as jcnn
    _, data, _, params = tiny
    runs = {}

    def run(label, name, runtime, **kw):
        if label not in runs:
            strategy = rfl.get("composition", name).strategy
            ref = _run(rfl.build(
                name, jcnn.apply, params, data,
                rfl.ServerConfig(num_clients=8, participation=0.5, seed=0),
                JLocalSpec(strategy, epochs=1, batch_size=20),
                engine="scan", runtime=runtime, **kw))
            digest = float(sum(np.abs(np.asarray(x)).sum(dtype=np.float64)
                               for x in pytree.tree_leaves(
                                   ref.global_params)))
            runs[label] = (ref.history, digest)
        return runs[label]
    return run


@pytest.fixture(scope="module")
def sequential(tiny):
    """``sequential(name, rounds=ROUNDS, **kw)``: the port's sequential
    ``Server`` of ``name`` after ``rounds`` rounds, run once per arguments
    for the module."""
    runs = {}

    def run(name="fedavg", rounds=ROUNDS, **kw):
        key = (name, rounds, tuple(sorted(kw.items())))
        if key not in runs:
            runs[key] = _run(_port(tiny, name, **kw), rounds)
        return runs[key]
    return run


@pytest.fixture(scope="module")
def scanned(tiny):
    """``scanned(name, wrong=False, r=4, **kw)``: a ``ScanServer`` of
    ``name`` at R = ``r`` after ``ROUNDS`` rounds, judged by
    :class:`_WrongSpeculation` when ``wrong``, run once per arguments for
    the module."""
    runs = {}

    def run(name="fedavg", wrong=False, r=4, **kw):
        key = (name, wrong, r, tuple(sorted(kw.items())))
        if key not in runs:
            judge = {"judge": _WrongSpeculation()} if wrong else {}
            runs[key] = _run(_scan(tiny, name, r=r, **judge, **kw))
        return runs[key]
    return run


def _digest(params) -> float:
    return float(sum(x.double().abs().sum()
                     for x in pytree.tree_leaves(params)))


def _assert_equal(seq, scan, flags=True):
    """Records equal to the bit (the two speculation flags apart, which a
    block's records carry) and params equal bit for bit."""
    assert len(seq.history) == len(scan.history)
    extra = {"spec_hit", "redispatched"} if flags else set()
    for a, b in zip(seq.history, scan.history):
        assert set(b) == set(a) | extra
        for key in a:
            if key == "entropy" and np.isnan(a[key]):
                assert np.isnan(b[key])
            else:
                assert b[key] == a[key], (a["round"], key)
    for x, y in zip(pytree.tree_leaves(seq.global_params),
                    pytree.tree_leaves(scan.global_params), strict=True):
        assert torch.equal(x, y)


def _assert_matches_reference(port, ref, flags=True):
    history, digest = ref
    assert len(port.history) == len(history)
    keys = ["round", "selected", "positive", "negative", "comm"]
    if flags:
        keys += ["spec_hit", "redispatched"]
    for want, got in zip(history, port.history):
        for key in keys:
            assert got[key] == want[key], (want["round"], key)
        if np.isnan(want["entropy"]):
            assert np.isnan(got["entropy"])
        else:
            assert got["entropy"] == pytest.approx(want["entropy"],
                                                   abs=ENT_ATOL)
    assert _digest(port.global_params) == pytest.approx(digest,
                                                        rel=DIGEST_RTOL)


class _WrongSpeculation(tfl.MaxEntropyJudge):
    """The oracle is the real maxent; the traced form admits everyone, so
    every round that rejects a device misspeculates."""

    def traced(self, backend=None):
        return tfl.PassThroughJudge().traced()


def _wrong_reference_judge():
    import repro.fl as rfl

    class Wrong(rfl.MaxEntropyJudge):
        def traced(self):
            return rfl.PassThroughJudge().traced()
    return Wrong()


# --------------------------------------------- against Server and repro

@pytest.mark.parametrize("R", [1, 4])
def test_scan_fedavg_matches_server_and_reference(tiny, reference,
                                                  sequential, R):
    from repro.fl.runtime import ScanConfig as JScanConfig
    seq = sequential()
    scan = _run(_scan(tiny, r=R))
    assert isinstance(scan, ScanServer) and scan.scan_rounds() == R
    _assert_equal(seq, scan, flags=R > 1)
    if R > 1:
        assert all(r["spec_hit"] for r in scan.history)
        assert scan.stats()["blocks"] == ROUNDS // R
    _assert_matches_reference(scan, reference(
        f"fedavg R={R}", "fedavg", JScanConfig(rounds_per_scan=R)),
        flags=R > 1)


def test_scan_fedentropy_uniform_matches_server(tiny, sequential):
    """fedentropy on the uniform selector (judgment without pools): two
    blocks against the sequential server, every round a hit."""
    seq = sequential("fedentropy", selector="uniform")
    scan = _run(_scan(tiny, "fedentropy", selector="uniform"))
    _assert_equal(seq, scan)
    assert all(r["spec_hit"] for r in scan.history)
    assert any(r["negative"] for r in scan.history)       # judgment bites


@pytest.mark.parametrize("spec_backend", ["torch", "cuda"])
def test_scan_spec_backends_equal_server(tiny, sequential, spec_backend):
    """Both device judges speculate the same verdicts (``"cuda"`` takes
    K1's plain version on CPU tensors)."""
    seq = sequential("fedentropy-traced", rounds=4)
    scan = _run(_scan(tiny, "fedentropy-traced", spec_backend=spec_backend),
                4)
    _assert_equal(seq, scan)
    assert scan.stats()["spec_backend"] == spec_backend
    assert scan.stats()["captured_block"] is False


@pytest.mark.parametrize("wrong", [False, True], ids=["hit", "miss"])
@pytest.mark.parametrize("mode", ["stack", "remat"])
def test_scan_traced_matches_server_and_reference(reference, sequential,
                                                  scanned, mode, wrong):
    """fedentropy-traced at R = 4: bit for bit the port's sequential server
    (the same threefry pools), and the live reference's records, flags
    included; a forced miss cuts blocks and still equals both."""
    from repro.fl.runtime import ScanConfig as JScanConfig
    seq = sequential("fedentropy-traced")
    scan = scanned("fedentropy-traced", wrong=wrong, params_mode=mode)
    assert scan.scan_rounds() == 4
    stats = scan.stats()
    assert stats["fallback_reasons"] == [] and stats["pool_fold"] is True
    _assert_equal(seq, scan)
    ref_kw = {"judge": _wrong_reference_judge()} if wrong else {}
    _assert_matches_reference(scan, reference(
        f"traced {mode} wrong={wrong}", "fedentropy-traced",
        JScanConfig(rounds_per_scan=4, params_mode=mode), **ref_kw))
    assert scan.selector.stats() == seq.selector.stats()
    if wrong:
        assert any(not r["spec_hit"] for r in scan.history)
        assert any(r["redispatched"] for r in scan.history)
        assert stats["mismatch_rounds"] == sum(
            not r["spec_hit"] for r in scan.history)
        for r in scan.history:
            if not r["spec_hit"]:
                assert r["negative"], "only a rejecting round can miss"


def test_scan_traced_composition_alias(tiny, scanned):
    a = scanned("fedentropy-traced", params_mode="stack")
    b = _run(_scan(tiny, "fedentropy", selector="pools-traced"))
    _assert_equal(a, b)


def test_scan_device_selection_matches_reference(tiny, reference):
    """``selection="device"`` draws each cohort from a threefry key carried
    through the block: the reference's ``jax.random.choice`` stream."""
    from repro.fl.runtime import ScanConfig as JScanConfig
    a = _run(_scan(tiny, selection="device"))
    b = _run(_scan(tiny, selection="device"))
    _assert_equal(a, b)
    for rec in a.history:
        assert len(set(rec["selected"])) == 4
        assert all(0 <= c < 8 for c in rec["selected"])
    _assert_matches_reference(a, reference(
        "fedavg device", "fedavg",
        JScanConfig(rounds_per_scan=4, selection="device")))



# ---------------------------------------------------- config, registry

def test_scan_remat_ys_carry_no_params(tiny):
    stack = _scan(tiny, params_mode="stack")
    remat = _scan(tiny, params_mode="remat")
    s, r = stack.block_ys_shapes(4), remat.block_ys_shapes(4)
    assert "params" in s and "params" not in r
    assert all(t.device.type == "meta" for t in pytree.tree_leaves(s))
    assert tuple(r["soft"].shape) == (4, 4, 4) and \
        r["sel"].dtype == torch.int32
    nbytes = tree_bytes(stack.global_params)
    assert remat.stacked_ys_nbytes(4) < nbytes
    assert stack.stacked_ys_nbytes(4) - remat.stacked_ys_nbytes(4) == \
        4 * nbytes
    traced = _scan(tiny, "fedentropy-traced")
    assert tuple(traced.block_ys_shapes(2)["key"].shape) == (2, 2)


def test_scan_config_validation():
    with pytest.raises(ValueError, match="rounds_per_scan"):
        ScanConfig(rounds_per_scan=0)
    with pytest.raises(ValueError, match="selection"):
        ScanConfig(selection="bogus")
    with pytest.raises(ValueError, match="params_mode"):
        ScanConfig(rounds_per_scan=4, params_mode="checkpoint")
    with pytest.raises(ValueError, match="unknown spec_backend 'xla'"):
        ScanConfig(spec_backend="xla")
    assert ScanConfig(shard=True).runtime().shard is True
    assert ScanConfig().runtime().shard == "auto"     # the pipelined rule
    with pytest.raises(ValueError, match="shard must be"):
        ScanConfig(shard="yes")
    cfg = ScanConfig(shard=False, donate_data=False)
    assert cfg.spec_backend == "cuda" and cfg.runtime() == RuntimeConfig(
        speculate=False, shard=False, spec_backend="cuda", donate_data=False)


def test_scan_config_routes_without_engine(tiny):
    assert isinstance(_port(tiny, runtime=ScanConfig()), ScanServer)
    assert tfl.get("engine", "scan") is ScanServer
    assert tfl.ScanServer is ScanServer and tfl.ScanConfig is ScanConfig


def test_engine_runtime_mismatches_error_loudly(tiny):
    with pytest.raises(ValueError, match="ScanConfig"):
        _port(tiny, engine="scan", runtime=RuntimeConfig())
    with pytest.raises(ValueError, match="RuntimeConfig"):
        _port(tiny, engine="pipelined", runtime=ScanConfig())
    with pytest.raises(ValueError, match="ScanConfig"):
        _port(tiny, engine=ScanServer, runtime=RuntimeConfig(speculate=True))
    s = _scan(tiny)
    with pytest.raises(ValueError, match="ScanServer takes runtime="
                                         "ScanConfig, got RuntimeConfig"):
        ScanServer(tcnn.apply, s.global_params, s.corpus, s.config,
                   selector=s.selector, strategy=s.strategy, judge=s.judge,
                   aggregator=s.aggregator, runtime=RuntimeConfig(),
                   device="cpu")


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_traced_cohort_equals_cohort(tiny, dtype):
    _, data, _, _ = tiny
    corpus = ClientCorpus.from_stacked(data, device="cpu")
    idx = [5, 0, 3]
    active = [7, 20, 1]
    for act in (None, active):
        want = corpus.cohort(idx, active=act)
        got = corpus.traced_cohort(
            torch.tensor(idx, dtype=dtype),
            None if act is None else torch.tensor(act))
        assert want.keys() == got.keys()
        for k in want:
            assert torch.equal(want[k], got[k]), k
    assert float(want["w"].sum()) < float(corpus.cohort(idx)["w"].sum())
