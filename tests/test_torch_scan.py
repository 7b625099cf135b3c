"""The port's scan engine (``repro_torch.fl.runtime.ScanServer``).

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
* its fallback reasons (codes and components) are the reference's for
  every composition that cannot fold; ``ScanConfig``, the routing and the
  registry behave as the reference's.

The ``test_card_*`` cases need a card and skip without one: the block
captured as one CUDA graph equals the same block run eagerly
(``fl.disable_capture()``) and the sequential server bit for bit, hit
and forced miss, stack and remat, with K1's and K2's launches counted
per replay. They take the port's own init params and import nothing of
JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_scan.py -k card
"""
import logging

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.core.aggregation import tree_bytes
from repro_torch.data.corpus import ClientCorpus
from repro_torch.data.partition import (drift_schedule, partition,
                                        stack_clients)
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.runtime import RuntimeConfig, ScanConfig, ScanServer
from repro_torch.kernels.entropy_judge import entropy_judge_loop
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
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


@pytest.fixture(scope="module")
def tiny_card():
    """The fixture with the port's own init params (no JAX)."""
    split, data = _split()
    return (split, data, tcnn.init(torch.Generator().manual_seed(0),
                                   image_hw=16, num_classes=4), None)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


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
def test_scan_fedavg_matches_server_and_reference(tiny, reference, R):
    from repro.fl.runtime import ScanConfig as JScanConfig
    seq = _run(_port(tiny))
    scan = _run(_scan(tiny, r=R))
    assert isinstance(scan, ScanServer) and scan.scan_rounds() == R
    _assert_equal(seq, scan, flags=R > 1)
    if R > 1:
        assert all(r["spec_hit"] for r in scan.history)
        assert scan.stats()["blocks"] == ROUNDS // R
    _assert_matches_reference(scan, reference(
        f"fedavg R={R}", "fedavg", JScanConfig(rounds_per_scan=R)),
        flags=R > 1)


def test_scan_fedentropy_uniform_matches_server(tiny):
    """fedentropy on the uniform selector (judgment without pools): two
    blocks against the sequential server, every round a hit."""
    seq = _run(_port(tiny, "fedentropy", selector="uniform"))
    scan = _run(_scan(tiny, "fedentropy", selector="uniform"))
    _assert_equal(seq, scan)
    assert all(r["spec_hit"] for r in scan.history)
    assert any(r["negative"] for r in scan.history)       # judgment bites


@pytest.mark.parametrize("spec_backend", ["torch", "cuda"])
def test_scan_spec_backends_equal_server(tiny, spec_backend):
    """Both device judges speculate the same verdicts (``"cuda"`` takes
    K1's plain version on CPU tensors)."""
    seq = _run(_port(tiny, "fedentropy-traced"), 4)
    scan = _run(_scan(tiny, "fedentropy-traced", spec_backend=spec_backend),
                4)
    _assert_equal(seq, scan)
    assert scan.stats()["spec_backend"] == spec_backend
    assert scan.stats()["captured_block"] is False


@pytest.mark.parametrize("wrong", [False, True], ids=["hit", "miss"])
@pytest.mark.parametrize("mode", ["stack", "remat"])
def test_scan_traced_matches_server_and_reference(tiny, reference, mode,
                                                  wrong):
    """fedentropy-traced at R = 4: bit for bit the port's sequential server
    (the same threefry pools), and the live reference's records, flags
    included; a forced miss cuts blocks and still equals both."""
    from repro.fl.runtime import ScanConfig as JScanConfig
    seq = _run(_port(tiny, "fedentropy-traced"))
    kw = {"judge": _WrongSpeculation()} if wrong else {}
    scan = _run(_scan(tiny, "fedentropy-traced", params_mode=mode, **kw))
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


def test_scan_forced_mismatch_uniform_equals_server(tiny):
    seq = _run(_port(tiny, "fedentropy", selector="uniform"))
    scan = _run(_scan(tiny, "fedentropy", selector="uniform",
                      judge=_WrongSpeculation()))
    _assert_equal(seq, scan)
    assert any(r["negative"] for r in seq.history)
    assert any(not r["spec_hit"] for r in scan.history)
    assert any(r["redispatched"] for r in scan.history)


@pytest.mark.parametrize("R", [1, 4])
def test_scan_remat_matches_stack_and_server(tiny, R):
    """``"remat"`` rebuilds each rewind point from the block's start: the
    same bits as ``"stack"``'s stored one, under forced misses."""
    seq = _run(_port(tiny, "fedentropy", selector="uniform"))
    runs = {mode: _run(_scan(tiny, "fedentropy", r=R, params_mode=mode,
                             selector="uniform", judge=_WrongSpeculation()))
            for mode in ("stack", "remat")}
    for scan in runs.values():
        _assert_equal(seq, scan, flags=R > 1)
    if R > 1:
        # a rewind from inside a block (j > 0), not only cuts at its start
        assert any(r["redispatched"] and r["spec_hit"]
                   for r in runs["remat"].history)


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


def test_scan_traced_composition_alias(tiny):
    a = _run(_scan(tiny, "fedentropy-traced"))
    b = _run(_scan(tiny, "fedentropy", selector="pools-traced"))
    _assert_equal(a, b)


def test_scan_params_advance_block_at_a_time(tiny):
    seq = _run(_port(tiny), 4)
    scan = _scan(tiny)
    scan.round()
    assert len(scan.history) == 1
    for x, y in zip(pytree.tree_leaves(seq.global_params),
                    pytree.tree_leaves(scan.global_params)):
        assert torch.equal(x, y)


class _EagerProgram:
    """Stands in for a captured block on the CPU: runs the block eagerly,
    so the cache's keys and entries can be checked without a card."""

    def __init__(self, fn, args):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


@pytest.fixture
def block_cache(monkeypatch):
    """Route blocks through the block-graph cache on the CPU, with each
    entry an :class:`_EagerProgram`."""
    from repro_torch.fl.runtime import scan_engine
    monkeypatch.setattr(scan_engine, "CapturedProgram", _EagerProgram)
    monkeypatch.setattr(ScanServer, "_capture_block", lambda self: True)


def test_scan_block_key_keeps_its_corpus(tiny):
    """A block graph gathers from its corpus's memory, so the key of its
    cache entry holds the corpus: a dropped server's corpus lives while
    the key does (no later corpus can take its memory), and another
    server's corpus, of the same signature, keys apart."""
    import gc
    import weakref
    server = _scan(tiny, "fedentropy-traced")
    corpus = weakref.ref(server.corpus)
    key = server._block_key(4)
    assert key == server._block_key(4)
    assert key != _scan(tiny, "fedentropy-traced")._block_key(4)
    del server
    gc.collect()
    assert corpus() is not None
    del key
    gc.collect()
    assert corpus() is None


def test_scan_process_cache_keys_blocks_by_corpus(tiny, block_cache):
    """Under the process cache a second server over a new corpus of the
    same signature misses the first server's block (after that server is
    dropped too) and runs its own, equal to the sequential server."""
    import gc

    from repro_torch.fl.runtime import (disable_process_cache,
                                        enable_process_cache)
    cache = enable_process_cache(maxsize=32)
    try:
        _run(_scan(tiny, "fedentropy-traced"), 4)
        gc.collect()
        seq = _run(_port(tiny, "fedentropy-traced"), 4)
        second = _run(_scan(tiny, "fedentropy-traced"), 4)
        blocks = [k for k in cache._entries if k[0] == "scan-block"]
        assert len(blocks) == 2
        assert second._block_graphs.captures == 0
        _assert_equal(seq, second)
    finally:
        disable_process_cache()


def test_scan_block_graphs_apart_from_client_programs(tiny, block_cache):
    """A forced miss at every rejecting round cuts blocks to every depth
    1..R; each depth is captured once, in the server's own block cache of
    R entries, whatever ``jit_cache_size`` (here 1) bounds the client
    programs to."""
    seq = _run(_port(tiny, "fedentropy-traced"))
    scan = _run(_scan(tiny, "fedentropy-traced", judge=_WrongSpeculation(),
                      config=_config(jit_cache_size=1)))
    _assert_equal(seq, scan)
    assert scan.stats()["captured_block"] is True
    depths = {k[1] for k in scan._block_graphs._entries}
    assert len(depths) > 1 and depths <= {1, 2, 3, 4}
    assert scan._block_graphs.captures == len(depths)
    assert not any(k[0] == "scan-block" for k in scan._graphs._entries)


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


# ----------------------------------------------------------- fallback

class _PlainJudge:
    """A judge without a traced form."""
    on_host = True

    def __call__(self, soft, sizes):
        return list(range(len(sizes))), [], float("nan")


@pytest.mark.parametrize("case", [
    "fedentropy", "moon", "scaffold", "fedcat", "ifca+maxent", "drift",
    "untraced-judge"])
def test_scan_fallback_reasons_match_reference(tiny, case):
    """Every composition that cannot fold falls back to sequential rounds
    with the reference's reason codes and components, in ``stats()`` and
    on each record."""
    import repro.fl as rfl
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.fl.runtime import ScanConfig as JScanConfig
    from repro.models import cnn as jcnn
    (xtr, ytr), data, _, jparams = tiny
    name, kw, jkw, ckw = case, {}, {}, {}
    if case == "ifca+maxent":
        ckw = {"num_clusters": 2}
    elif case == "drift":
        name = "fedentropy-traced"
        kw["drift"] = jkw["drift"] = drift_schedule(
            xtr, ytr, 8, 4, at=2, samples_per_client=int(data["y"].shape[1]))
    elif case == "untraced-judge":
        name = "fedavg"
        kw["judge"], jkw["judge"] = _PlainJudge(), _PlainJudge()
    strategy = rfl.get("composition", name).strategy
    ref = rfl.build(name, jcnn.apply, jparams, data,
                    rfl.ServerConfig(num_clients=8, participation=0.5,
                                     seed=0, **ckw),
                    JLocalSpec(strategy, epochs=1, batch_size=20),
                    engine="scan", runtime=JScanConfig(rounds_per_scan=4),
                    **jkw)
    port = _scan(tiny, name, config=_config(**ckw), **kw)
    assert ref.scan_rounds() == port.scan_rounds() == 1
    want = [(r["code"], r["component"]) for r in ref.fallback_reasons]
    got = [(r["code"], r["component"]) for r in port.fallback_reasons]
    assert got == want and got
    assert all(r["detail"] for r in port.fallback_reasons)
    assert port.stats()["fallback_reasons"] == port.fallback_reasons
    rec = port.round()
    assert rec["scan_fallback"] == [c for c, _ in got]
    assert "spec_hit" not in rec


def test_scan_pools_falls_back_to_server(tiny, caplog):
    """fedentropy's numpy pools couple each draw to the last verdict: one
    warning, R = 1, and the sequential server's rounds bit for bit."""
    scan = _scan(tiny, "fedentropy")
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.fl.runtime.scan_engine"):
        assert scan.scan_rounds() == 1
    assert any("falling back" in r.message for r in caplog.records)
    seq = _run(_port(tiny, "fedentropy"), 4)
    _run(scan, 4)
    for a, b in zip(seq.history, scan.history):
        assert b.pop("scan_fallback") == ["verdict-coupled-selector"]
    _assert_equal(seq, scan, flags=False)


def test_scan_foldable_reports_no_reasons(tiny):
    scan = _scan(tiny)
    assert scan.scan_rounds() == 4 and scan.fallback_reasons == []
    rec = scan.round()
    assert "scan_fallback" not in rec
    stats = scan.stats()
    assert stats["engine"] == "scan" and stats["blocks"] == 1
    assert stats["captured_block"] is False     # eager on the CPU
    assert stats["selection"] == "replay" and stats["pool_fold"] is False


# ---------------------------------------------------- config, registry

def test_scan_config_validation():
    with pytest.raises(ValueError, match="rounds_per_scan"):
        ScanConfig(rounds_per_scan=0)
    with pytest.raises(ValueError, match="selection"):
        ScanConfig(selection="bogus")
    with pytest.raises(ValueError, match="params_mode"):
        ScanConfig(rounds_per_scan=4, params_mode="checkpoint")
    with pytest.raises(ValueError, match="unknown spec_backend 'xla'"):
        ScanConfig(spec_backend="xla")
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        ScanConfig(shard=True)
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


# ------------------------------------------------------------- card only

def _counts():
    return (entropy_judge_loop.launches, masked_weighted_sum.launches)


@pytest.mark.parametrize("wrong", [False, True], ids=["hit", "miss"])
@pytest.mark.parametrize("mode", ["stack", "remat"])
def test_card_scan_captured_equals_eager_and_server(cuda, tiny_card, mode,
                                                    wrong):
    """The block captured as one graph (K1's loop and K2 inside it) equals
    the same blocks run eagerly and the sequential server bit for bit;
    each replay counts its launches: K1 and K2 once a round."""
    kw = dict(device="cuda",
              aggregator=tfl.FusedAverageAggregator(backend="cuda"))
    judge = _WrongSpeculation if wrong else tfl.MaxEntropyJudge
    seq = _run(_port(tiny_card, "fedentropy-traced", judge=judge(), **kw))
    scan = _scan(tiny_card, "fedentropy-traced", params_mode=mode,
                 judge=judge(), **kw)
    _run(scan)
    assert scan.stats()["captured_block"] is True
    _assert_equal(seq, scan)
    with tfl.disable_capture():
        eager = _run(_scan(tiny_card, "fedentropy-traced", params_mode=mode,
                           judge=judge(), **kw))
        assert eager.stats()["captured_block"] is False
    _assert_equal(eager, scan)
    programs = [(k[1], p) for k, p in
                scan._block_graphs._entries.items()]   # (depth, program)
    assert programs
    for r, p in programs:
        assert p.launches.get("masked_weighted_sum") == r
        assert p.launches.get("entropy_judge_loop", 0) == (0 if wrong else r)
    if wrong:
        assert any(not r["spec_hit"] for r in scan.history)


def test_card_scan_counts_per_replay(cuda, tiny_card):
    """A second block replays the graph the first one captured: K1's and
    K2's counts move by R each, as on the device."""
    kw = dict(device="cuda",
              aggregator=tfl.FusedAverageAggregator(backend="cuda"))
    scan = _scan(tiny_card, "fedentropy", selector="uniform", **kw)
    _run(scan, 4)
    if not all(r["spec_hit"] for r in scan.history):
        pytest.skip("a natural miss in the first block")
    before = _counts()
    _run(scan, 4)
    if all(r["spec_hit"] for r in scan.history[4:]):
        assert tuple(a - b for a, b in zip(_counts(), before)) == (4, 4)


def test_card_threefry_draw_captured_equals_eager_and_cpu(cuda):
    """The pool draw and the device selection's permutation (two sort
    rounds at N = 2000) captured in a graph give the eager card's and the
    CPU's integers: the stable argsort's scratch comes from the graph's
    pool."""
    from repro_torch.core import threefry
    from repro_torch.core.pools import pools_draw
    from repro_torch.fl.graph_cache import CapturedProgram
    for n, num in ((100, 10), (2000, 200)):
        rng = np.random.default_rng(n)
        pos = torch.from_numpy((rng.random(n) < 0.5).astype(np.float32))
        neg = 1.0 - pos
        key = threefry.prng_key(7)

        def draw(k, p, q):
            sel, k2 = pools_draw(k, p, q, num=num, eps=0.8)
            return sel, k2, threefry.permutation(k2, n)

        want = draw(key, pos, neg)
        args = (key.cuda(), pos.cuda(), neg.cuda())
        eager = draw(*args)
        program = CapturedProgram(draw, args)
        for _ in range(2):          # a second replay: the same bits
            got = program(*args)
            for w, e, g in zip(want, eager, got):
                assert torch.equal(w, e.cpu()) and torch.equal(w, g.cpu())


@pytest.mark.parametrize("c,cluster", [(10, None), (4096, None), (10, 2)],
                         ids=["warp", "cluster-4", "forced-2"])
def test_card_k1_loop_captures(cuda, c, cluster):
    """K1's loop inside a CUDA graph, as the scan block holds it: the
    warp kernel at the paper's shape and the cluster kernel (launched
    with a cluster attribute) give the eager launch's bits, one launch a
    replay."""
    from repro_torch.fl.graph_cache import CapturedProgram
    rng = np.random.default_rng(c)
    soft = rng.dirichlet(np.full(c, 0.3), size=10).astype(np.float32)
    soft = torch.from_numpy(soft).cuda()
    sizes = torch.from_numpy(rng.integers(20, 60, 10).astype(np.float32)) \
        .cuda()

    def fn(s, z):
        return entropy_judge_loop(s, z, _cluster=cluster)

    eager = fn(soft, sizes).clone()
    program = CapturedProgram(fn, (soft, sizes))
    assert program.launches == {"entropy_judge_loop": 1}
    before = entropy_judge_loop.launches
    got = program(soft, sizes)
    assert entropy_judge_loop.launches == before + 1
    assert torch.equal(got.view(torch.int32), eager.view(torch.int32))
