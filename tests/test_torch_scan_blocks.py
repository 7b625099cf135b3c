"""The port's scan engine (``repro_torch.fl.runtime.ScanServer``): forced
misses and rewinds, the block-graph cache, the fallbacks and the card
cases, on the helpers and per-module runs of ``tests/test_torch_scan.py``
(the same ``tiny`` fixture, on the CPU, where the block runs eagerly):

* a forced miss at every rejecting round cuts blocks and still equals
  the sequential ``Server`` bit for bit, in both memory modes (``"remat"``
  rebuilds each rewind point from the block's start: the same bits as
  ``"stack"``'s stored one);
* the block graphs keep their corpus in their key and live in the
  server's own cache, apart from the client programs';
* every composition that cannot fold falls back to sequential rounds
  with the reference's reason codes and components.

The ``test_card_*`` cases need a card and skip without one: the block
captured as one CUDA graph equals the same block run eagerly
(``fl.disable_capture()``) and the sequential server bit for bit, hit
and forced miss, stack and remat, with K1's and K2's launches counted
per replay. They take the port's own init params and import nothing of
JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_scan_blocks.py -k card
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import logging

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.data.partition import drift_schedule
from repro_torch.fl.runtime import ScanServer
from repro_torch.kernels.entropy_judge import entropy_judge_loop
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.models import cnn as tcnn
from test_torch_scan import (  # noqa: F401  (fixtures by name)
    _WrongSpeculation, _assert_equal, _config, _port, _run, _scan, _split,
    sequential, tiny)


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


# --------------------------------------- forced misses and rewinds

@pytest.fixture(scope="module")
def uniform_wrong(tiny):
    """``uniform_wrong(r, mode)``: fedentropy on the uniform selector at
    R = ``r`` in memory mode ``mode``, every rejecting round a forced miss
    (:class:`_WrongSpeculation`), after 8 rounds; run once per
    arguments for the module."""
    runs = {}

    def run(r, mode):
        if (r, mode) not in runs:
            runs[r, mode] = _run(_scan(tiny, "fedentropy", r=r,
                                       params_mode=mode, selector="uniform",
                                       judge=_WrongSpeculation()))
        return runs[r, mode]
    return run


def test_scan_forced_mismatch_uniform_equals_server(sequential,
                                                    uniform_wrong):
    seq = sequential("fedentropy", selector="uniform")
    scan = uniform_wrong(4, "stack")
    _assert_equal(seq, scan)
    assert any(r["negative"] for r in seq.history)
    assert any(not r["spec_hit"] for r in scan.history)
    assert any(r["redispatched"] for r in scan.history)


@pytest.mark.parametrize("R", [1, 4])
def test_scan_remat_matches_stack_and_server(sequential, uniform_wrong, R):
    """``"remat"`` rebuilds each rewind point from the block's start: the
    same bits as ``"stack"``'s stored one, under forced misses."""
    seq = sequential("fedentropy", selector="uniform")
    runs = {mode: uniform_wrong(R, mode) for mode in ("stack", "remat")}
    for scan in runs.values():
        _assert_equal(seq, scan, flags=R > 1)
    if R > 1:
        # a rewind from inside a block (j > 0), not only cuts at its start
        assert any(r["redispatched"] and r["spec_hit"]
                   for r in runs["remat"].history)


def test_scan_params_advance_block_at_a_time(tiny, sequential):
    seq = sequential(rounds=4)
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


def test_scan_process_cache_keys_blocks_by_corpus(tiny, sequential,
                                                  block_cache):
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
        seq = sequential("fedentropy-traced", rounds=4)
        second = _run(_scan(tiny, "fedentropy-traced"), 4)
        blocks = [k for k in cache._entries if k[0] == "scan-block"]
        assert len(blocks) == 2
        assert second._block_graphs.captures == 0
        _assert_equal(seq, second)
    finally:
        disable_process_cache()


def test_scan_block_graphs_apart_from_client_programs(tiny, sequential,
                                                       block_cache):
    """A forced miss at every rejecting round cuts blocks to every depth
    1..R; each depth is captured once, in the server's own block cache of
    R entries, whatever ``jit_cache_size`` (here 1) bounds the client
    programs to."""
    seq = sequential("fedentropy-traced")
    scan = _run(_scan(tiny, "fedentropy-traced", judge=_WrongSpeculation(),
                      config=_config(jit_cache_size=1)))
    _assert_equal(seq, scan)
    assert scan.stats()["captured_block"] is True
    depths = {k[1] for k in scan._block_graphs._entries}
    assert len(depths) > 1 and depths <= {1, 2, 3, 4}
    assert scan._block_graphs.captures == len(depths)
    assert not any(k[0] == "scan-block" for k in scan._graphs._entries)


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


def test_scan_pools_falls_back_to_server(tiny, sequential, caplog):
    """fedentropy's numpy pools couple each draw to the last verdict: one
    warning, R = 1, and the sequential server's rounds bit for bit."""
    scan = _scan(tiny, "fedentropy")
    with caplog.at_level(logging.WARNING,
                         logger="repro_torch.fl.runtime.scan_engine"):
        assert scan.scan_rounds() == 1
    assert any("falling back" in r.message for r in caplog.records)
    seq = sequential("fedentropy", rounds=4)
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
    warp kernel at the paper's shape and the grid kernel (a cooperative
    launch: 4 CTAs at 4096 classes, 2 forced at 10) give the eager
    launch's bits, one launch a replay."""
    from repro_torch.fl.graph_cache import CapturedProgram
    rng = np.random.default_rng(c)
    soft = rng.dirichlet(np.full(c, 0.3), size=10).astype(np.float32)
    soft = torch.from_numpy(soft).cuda()
    sizes = torch.from_numpy(rng.integers(20, 60, 10).astype(np.float32)) \
        .cuda()

    def fn(s, z):
        return entropy_judge_loop(s, z, _ctas=cluster)

    eager = fn(soft, sizes).clone()
    program = CapturedProgram(fn, (soft, sizes))
    assert program.launches == {"entropy_judge_loop": 1}
    before = entropy_judge_loop.launches
    got = program(soft, sizes)
    assert entropy_judge_loop.launches == before + 1
    assert torch.equal(got.view(torch.int32), eager.view(torch.int32))
