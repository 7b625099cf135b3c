"""The scan engine's client axis over several devices in the port
(``ScanConfig(shard=True)``, ``ClientCorpus.traced_blocks``,
``sharding.device_layout``), on the CPU, where a mesh names the CPU
several times (``make_client_mesh(["cpu"] * n)``) and the block runs
eagerly:

* on 4 shards at N = 10 (padded to 12, cohorts of 5 padded to 8) the
  records of the reference's sharded ``ScanServer``, run in a subprocess
  under 4 forced host devices, for fedavg and fedentropy-traced in both
  memory modes: integers and flags exact, entropy within 1e-6, the params
  digest within a relative 1e-5, the same padded client count;
* a 1-shard mesh is bit for bit the unsharded scan;
* on 3 shards at N = 100 a block is bit for bit the pipelined engine's
  ``shard=True`` rounds on the same mesh (the same per-shard programs),
  with the unsharded scan's integer records; a forced miss, ``"stack"``
  and ``"remat"`` bit for bit; ``selection="device"`` as unsharded;
* the traced gather equals the host slice bit for bit on uneven layouts;
* ``tests/golden/uneven_history.json``'s variants fall back to R = 1
  with the reference's reason codes and reproduce the golden;
* sharded and unsharded block graphs key apart in the process cache.

The ``test_card_*`` cases need a card and skip without one; they take
the port's own init params and import nothing of JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_scan_shard.py -k card
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.data.corpus import ClientCorpus
from repro_torch.data.partition import partition, stack_clients
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.runtime import (RuntimeConfig, ScanConfig, ScanServer,
                                    disable_process_cache,
                                    enable_process_cache, pad_to_multiple)
from repro_torch.fl.runtime.sharding import device_layout
from repro_torch.kernels.entropy_judge import entropy_judge_loop
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.models import cnn as tcnn
from test_torch_scan import _WrongSpeculation
from test_torch_scan_blocks import _EagerProgram
from test_torch_shard import (  # noqa: F401  (fixtures by name)
    PAPER_N, VARIANTS, _assert_bit_equal, _assert_close, _check_golden,
    _ints, _paper_data, cpu_mesh, golden, paper, ref)

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
ROUNDS = 8                       # two blocks of 4
R = 4
SMALL_N = 10                     # 4 shards: 12 rows, cohorts of 5 -> 8
ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-5
REF_TIMEOUT = 600
RUNS = [("fedavg", "stack"), ("fedavg", "remat"),
        ("fedentropy-traced", "stack"), ("fedentropy-traced", "remat")]

# the reference's sharded scan on 4 forced host devices: argv[1] the
# corpus (.npz), argv[2] the JSON it writes
_JAX_SCAN = r"""
import json, sys
import numpy as np
import jax
import repro.fl as rfl
from repro.core.strategies import LocalSpec
from repro.fl.runtime import ScanConfig
from repro.models import cnn
assert len(jax.devices()) == 4, jax.devices()
data = dict(np.load(sys.argv[1]))
with jax.threefry_partitionable(False):
    params = cnn.init(jax.random.PRNGKey(0), image_hw=16, num_classes=4)
out = {}
for name, mode in %r:
    strategy = rfl.get("composition", name).strategy
    s = rfl.build(name, cnn.apply, params, data,
                  rfl.ServerConfig(num_clients=%d, participation=0.5, seed=0),
                  LocalSpec(strategy, epochs=1, batch_size=20),
                  engine="scan", runtime=ScanConfig(
                      rounds_per_scan=%d, shard=True, params_mode=mode))
    for _ in range(%d):
        s.round()
    keys = ("round", "selected", "positive", "negative", "comm", "entropy",
            "spec_hit", "redispatched")
    out[name + "/" + mode] = {
        "history": [{k: r[k] for k in keys} for r in s.history],
        "digest": float(sum(np.abs(np.asarray(x)).sum(dtype=np.float64)
                            for x in jax.tree.leaves(s.global_params))),
        "scan_rounds": s.scan_rounds(),
        "reasons": s.fallback_reasons,
        "padded": int(s.corpus.padded_num_clients)}
json.dump(out, open(sys.argv[2], "w"), default=float)
print("JAX-SCAN-OK")
""" % (RUNS, SMALL_N, R, ROUNDS)


def _small_data():
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    return stack_clients(xtr, ytr, partition("case1", ytr, SMALL_N, 4,
                                             seed=0), batch_multiple=20)


@pytest.fixture(scope="module")
def reference_scans(ref, tmp_path_factory):
    """The reference's sharded scans of :data:`RUNS` on 4 forced host
    devices, run once for the module in a subprocess (the forced device
    count must be set before JAX starts)."""
    tmp = tmp_path_factory.mktemp("scan_shard")
    np.savez(tmp / "data.npz", **_small_data())
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    res = subprocess.run(
        [sys.executable, "-c", _JAX_SCAN, str(tmp / "data.npz"),
         str(tmp / "ref.json")], env=env, capture_output=True, text=True,
        timeout=REF_TIMEOUT)
    assert res.returncode == 0 and "JAX-SCAN-OK" in res.stdout, \
        res.stderr[-3000:]
    return json.loads((tmp / "ref.json").read_text())


@pytest.fixture(scope="module")
def small(ref):
    """N = 10 with the reference's init params (F1's context), converted."""
    with ref.jax.threefry_partitionable(False):
        params = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                              num_classes=4)
    return _small_data(), cnn_params_from_numpy(
        ref.jax.tree.map(np.asarray, params))


@pytest.fixture(scope="module")
def own():
    """N = 100 (the golden's corpus) with the port's own init params
    (port against port)."""
    return _paper_data(), tcnn.init(torch.Generator().manual_seed(0),
                                    image_hw=16, num_classes=10)


def _paper(case, comp, mesh=None, engine="scan", runtime=None, **kw):
    """``comp`` at the golden's configuration (N = 100, cohorts of 10);
    ``engine="scan"`` builds a ``ScanServer`` at R = 4 sharded over
    ``mesh`` (unsharded without one) unless ``runtime`` is given; ``kw``
    goes to ``fl.build`` and, for ``params_mode`` and ``selection``, to
    ``ScanConfig``."""
    data, params = case
    cfg = {k: kw.pop(k) for k in ("params_mode", "selection") if k in kw}
    if runtime is None and engine == "scan":
        runtime = ScanConfig(rounds_per_scan=R, shard=mesh is not None,
                             **cfg)
    strategy = tfl.get("composition", comp).strategy
    return tfl.build(comp, tcnn.apply, params, data,
                     tfl.ServerConfig(num_clients=PAPER_N, participation=0.1,
                                      seed=0, group_size=2),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=10),
                     device=kw.pop("device", "cpu"), engine=engine,
                     runtime=runtime, mesh=mesh, **kw)


@pytest.fixture(scope="module")
def own_small():
    """N = 10 with the port's own init params (no JAX)."""
    return _small_data(), tcnn.init(torch.Generator().manual_seed(0),
                                    image_hw=16, num_classes=4)


def _small_build(case, comp, mesh=None, engine="scan", device="cpu",
                 params_mode="stack", **kw):
    """``comp`` at N = 10, cohorts of 5: a ``ScanServer`` at R = 4 sharded
    over ``mesh`` (unsharded without one), or with ``engine="pipelined"``
    the sequential sharded rounds (``RuntimeConfig(shard=True)``), or
    with ``engine=None`` the unsharded ``Server``."""
    data, params = case
    runtime = {"scan": ScanConfig(rounds_per_scan=R, shard=mesh is not None,
                                  params_mode=params_mode),
               "pipelined": RuntimeConfig(shard=True), None: None}[engine]
    strategy = tfl.get("composition", comp).strategy
    return tfl.build(comp, tcnn.apply, params, data,
                     tfl.ServerConfig(num_clients=SMALL_N, participation=0.5,
                                      seed=0),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     device=device, engine=engine, mesh=mesh,
                     runtime=runtime, **kw)


def _run(server, rounds=ROUNDS):
    for _ in range(rounds):
        server.round()
    return server


def _digest(params) -> float:
    return float(sum(x.double().abs().sum()
                     for x in pytree.tree_leaves(params)))


def _folded(server, shards):
    stats = server.stats()
    assert server.scan_rounds() == R and server.fallback_reasons == []
    assert stats["blocks"] >= ROUNDS // R and stats["shards"] == shards
    assert stats["captured_block"] is False          # eager on the CPU


# ------------------------------------------------ the port against itself

@pytest.mark.parametrize("comp", ["fedavg", "fedentropy-traced"])
def test_one_shard_mesh_is_unsharded_scan(own, comp):
    """``shard=True`` on a mesh of one CPU shard runs the fan-out (one
    block, no pad) and equals the unsharded scan bit for bit; ``"auto"``
    does not shard on the CPU (the pipelined engine's rule)."""
    plain = _run(_paper(own, comp))
    assert plain._fanout is None and plain.stats()["shards"] == 1
    one = _paper(own, comp, cpu_mesh(1))
    gathers = []
    traced = one.corpus.traced_blocks
    one.corpus.traced_blocks = lambda *a: gathers.append(1) or traced(*a)
    _run(one)
    _folded(one, 1)
    assert len(gathers) == ROUNDS                     # the fan-out ran
    assert one.corpus.mesh == cpu_mesh(1)
    _assert_bit_equal(plain, one)
    for a, b in zip(plain.history, one.history):
        assert a["spec_hit"] == b["spec_hit"]


@pytest.mark.parametrize("mode", ["stack", "remat"])
@pytest.mark.parametrize("comp", ["fedavg", "fedentropy-traced"])
def test_three_shards_equal_pipelined_shard_rounds(own, comp, mode):
    """N = 100 on 3 shards (102 rows, cohorts of 10 padded to 12): the
    folded block equals the pipelined engine's ``shard=True`` rounds on
    the same mesh bit for bit (records and params), and the unsharded
    scan's integer records."""
    mesh = cpu_mesh(3)
    pip = _run(_paper(own, comp, mesh, engine="pipelined",
                      runtime=RuntimeConfig(shard=True)))
    scan = _run(_paper(own, comp, mesh, params_mode=mode))
    _folded(scan, 3)
    assert scan.corpus.padded_num_clients == 102
    assert scan.client_mesh() == mesh
    _assert_bit_equal(pip, scan)
    assert all(r["spec_hit"] for r in scan.history)
    plain = _run(_paper(own, comp))
    assert _ints(scan.history) == _ints(plain.history)


@pytest.fixture(scope="module")
def wrong_runs(own_small):
    """fedentropy on the uniform selector at N = 10 (cohorts of 5; at
    N = 100 nearly every round rejects, so no confirmed round follows a
    cut), every rejecting round a forced miss, on 3 shards (12 rows,
    cohorts padded to 6) in both memory modes; the sharded sequential
    rounds (the pipelined engine, speculation off) on the same mesh; the
    unsharded ``Server``."""
    mesh = cpu_mesh(3)
    kw = dict(selector="uniform", judge=_WrongSpeculation())
    runs = {mode: _run(_small_build(own_small, "fedentropy", mesh,
                                    params_mode=mode, **kw))
            for mode in ("stack", "remat")}
    runs["seq"] = _run(_small_build(own_small, "fedentropy", mesh,
                                    engine="pipelined", selector="uniform"))
    runs["plain"] = _run(_small_build(own_small, "fedentropy", None,
                                      engine=None, selector="uniform"))
    return runs


@pytest.mark.parametrize("mode", ["stack", "remat"])
def test_three_shards_forced_mismatch_equals_sequential(wrong_runs, mode):
    """A forced miss on 3 shards (``test_scan_forced_mismatch_truncates_
    and_replays``'s judge): blocks are cut, the mismatched round runs
    again eagerly through the fan-out, and the history and params equal
    the sequential sharded rounds bit for bit, the integers the
    unsharded ``Server``'s; ``"remat"`` rebuilds its rewind points from
    inside a block to ``"stack"``'s bits."""
    scan = wrong_runs[mode]
    _assert_bit_equal(wrong_runs["seq"], scan)
    _assert_bit_equal(wrong_runs["stack"], scan)
    assert _ints(scan.history) == _ints(wrong_runs["plain"].history)
    assert any(r["negative"] for r in scan.history)
    assert any(not r["spec_hit"] for r in scan.history)
    assert any(r["redispatched"] for r in scan.history)
    for r in scan.history:
        if not r["spec_hit"]:
            assert r["negative"], "only a rejecting round can miss"
    if mode == "remat":
        # a rewind from inside a block (j > 0), not only cuts at its start
        assert any(r["redispatched"] and r["spec_hit"]
                   for r in scan.history)
    assert scan.stats()["mismatch_rounds"] == sum(
        not r["spec_hit"] for r in scan.history)


def test_three_shards_device_selection_equals_unsharded(own):
    """``selection="device"`` draws each cohort from the threefry key the
    block carries, on the server's device: on 3 shards the cohorts and
    every integer record are the unsharded scan's, entropy within 1e-6
    and params within 1e-5 (the port's policy across program shapes)."""
    sharded = _run(_paper(own, "fedavg", cpu_mesh(3), selection="device"))
    plain = _run(_paper(own, "fedavg", selection="device"))
    _folded(sharded, 3)
    _assert_close(sharded, plain)
    assert len({tuple(r["selected"]) for r in sharded.history}) > 1


def test_traced_pools_on_shards_walk_the_sequential_selector(own):
    """fedentropy-traced carries the pools through the sharded block: the
    host mirror ends in the sequential sharded server's selector state."""
    mesh = cpu_mesh(3)
    scan = _run(_paper(own, "fedentropy-traced", mesh))
    seq = _run(_paper(own, "fedentropy-traced", mesh, engine="pipelined",
                      runtime=RuntimeConfig(shard=True)))
    assert scan.stats()["pool_fold"] is True
    assert scan.selector.stats() == seq.selector.stats()
    _assert_bit_equal(seq, scan)


# --------------------------------------------------------- the traced gather

@pytest.mark.parametrize("m,n", [(1, 3), (5, 4), (10, 3), (12, 4), (7, 8)])
def test_device_layout_is_pad_to_multiple(m, n):
    want = pad_to_multiple(np.arange(m), n).reshape(n, -1)
    got = device_layout(m, n, "cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _poisoned(data):
    """The corpus with a -0.0 and a NaN in two clients' images, so a gather
    that summed its blocks would change their bits."""
    data = {k: v.copy() for k, v in data.items()}
    data["x"] = data["x"].astype(np.float32)
    data["x"][3, 0, 0, 0, 0] = -0.0
    data["x"][data["x"].shape[0] - 1, 1, 2, 3, 1] = np.nan
    return data


@pytest.mark.parametrize("queued", [False, True], ids=["plain", "active"])
@pytest.mark.parametrize("n_clients,shards,idx", [
    (PAPER_N, 3, [0, 7, 99, 42, 13, 98, 3, 68, 33, 34]),
    (SMALL_N, 4, [9, 0, 3, 6, 2]),
])
def test_traced_blocks_equal_host_slice(n_clients, shards, idx, queued):
    """The traced gather over the padded-shard layout (N = 100 on 3
    shards, 34 rows a block; N = 10 on 4, 3 a block), ids from every
    owner block, int32 and int64: each block equals the host slice of its
    positions bit for bit (pad rows included, a -0.0 and a NaN kept), and
    ``cohort_blocks``'s blocks; with a queue's ``active`` counts, its
    masked ``w``."""
    data = _poisoned(_paper_data() if n_clients == PAPER_N
                     else _small_data())
    corpus = ClientCorpus(dict(data), device="cpu").shard(cpu_mesh(shards))
    idx = np.asarray(idx)
    per = corpus.padded_num_clients // shards
    assert set(idx // per) == set(range(shards))      # every owner block
    layout = pad_to_multiple(np.arange(len(idx)), shards).reshape(shards, -1)
    active = np.arange(1, len(idx) + 1) * 3 if queued else None
    want = corpus.cohort_blocks(idx, active, layout, corpus.mesh.devices)
    for dtype in (torch.int32, torch.int64):
        got = corpus.traced_blocks(
            torch.as_tensor(idx, dtype=dtype),
            device_layout(len(idx), shards, "cpu"),
            None if active is None else torch.as_tensor(active))
        assert len(got) == shards
        for b, blk in enumerate(got):
            rows = idx[layout[b]]
            for k, v in data.items():
                host = v[rows]
                if k == "w" and queued:
                    live = (np.arange(v.shape[1])[None, :]
                            < active[layout[b]][:, None])
                    host = host * live
                assert blk[k].numpy().dtype == host.dtype
                assert blk[k].numpy().tobytes() == host.tobytes(), (b, k)
                assert torch.equal(blk[k].view(torch.uint8),
                                   want[b][k].view(torch.uint8)), (b, k)


def test_traced_blocks_unsharded_is_traced_cohort():
    """On an unsharded corpus a one-row layout is the one-device traced
    gather; a sharded corpus's one-device gather still refuses."""
    data = _small_data()
    corpus = ClientCorpus(dict(data), device="cpu")
    idx = torch.tensor([4, 1, 8])
    [got] = corpus.traced_blocks(idx, device_layout(3, 1, "cpu"))
    want = corpus.traced_cohort(idx)
    for k in want:
        assert torch.equal(got[k], want[k])
    with pytest.raises(ValueError, match="layout rows"):
        corpus.traced_blocks(idx, device_layout(3, 2, "cpu"))
    corpus.shard(cpu_mesh(2))
    with pytest.raises(ValueError, match="traced_blocks"):
        corpus.traced_cohort(idx)


def test_sharded_block_ys_shapes_probe_one_row(own, monkeypatch):
    """``block_ys_shapes`` describes the sharded block's per-round outputs
    (those the block writes), and the probe behind it reads one row of the
    first corpus block, never the laid-out corpus's concatenation."""
    scan = _paper(own, "fedentropy-traced", cpu_mesh(3))

    def concatenated(self, key):
        raise AssertionError(f"corpus[{key!r}] concatenates every block")
    monkeypatch.setattr(ClientCorpus, "__getitem__", concatenated)
    for mode_r in (1, R):
        shapes = scan.block_ys_shapes(mode_r)
        key, pos, neg = scan._fold_state()
        rows = torch.zeros((mode_r, 10), dtype=torch.int32)
        ys = scan._block_fn(mode_r)(scan.global_params, key, pos, neg,
                                    rows)[4]
        for name, meta in shapes.items():
            for a, b in zip(pytree.tree_leaves(meta),
                            pytree.tree_leaves(ys[name]), strict=True):
                assert a.shape == b.shape and a.dtype == b.dtype, name
    assert scan.stacked_ys_nbytes(R) > scan.stacked_ys_nbytes(1)


# ------------------------------------------------------- the golden fallback

@pytest.mark.parametrize("variant", list(VARIANTS))
def test_uneven_golden_falls_back_on_three_shards(ref, paper, golden,
                                                  variant):
    """``uneven_history.json``'s compositions under ``engine="scan"``,
    ``shard=True`` on 3 shards: none folds, each falls back to R = 1 with
    the reference's reason codes and components (on every record), and
    the sequential sharded rounds reproduce the golden under the port's
    policy (integers exact, entropy within 1e-6; the init params drawn
    under F1's context)."""
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.fl.runtime import ScanConfig as JScanConfig
    comp = VARIANTS[variant]
    mesh = cpu_mesh(3)
    rounds = len(golden[variant]["history"])
    scan = _paper(paper, comp, mesh)
    jdata, jparams = _paper_data(), None
    with ref.jax.threefry_partitionable(False):
        jparams = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                               num_classes=10)
    strategy = ref.fl.get("composition", comp).strategy
    want = ref.fl.build(comp, ref.cnn.apply, jparams, jdata,
                        ref.fl.ServerConfig(num_clients=PAPER_N,
                                            participation=0.1, seed=0,
                                            group_size=2),
                        JLocalSpec(strategy, epochs=1, batch_size=10),
                        engine="scan", runtime=JScanConfig(rounds_per_scan=R))
    assert scan.scan_rounds() == want.scan_rounds() == 1
    codes = [(r["code"], r["component"]) for r in scan.fallback_reasons]
    assert codes == [(r["code"], r["component"])
                     for r in want.fallback_reasons] and codes
    _run(scan, rounds)
    for rec in scan.history:
        assert rec["scan_fallback"] == [c for c, _ in codes]
    _check_golden(scan, golden[variant])
    assert scan.corpus.padded_num_clients == 102
    assert scan.client_mesh() == mesh


# ------------------------------------------------------ the process cache

def test_process_cache_keeps_sharded_blocks_apart(own, monkeypatch):
    """Under the process cache, with blocks routed through it (an eager
    stand-in for the captured graph), an unsharded, a 1-shard and a
    3-shard server of one composition each key their own block, the
    mesh's devices in the key; each still equals its own sequential
    rounds."""
    from repro_torch.fl.runtime import scan_engine
    monkeypatch.setattr(scan_engine, "CapturedProgram", _EagerProgram)
    monkeypatch.setattr(ScanServer, "_capture_block", lambda self: True)
    cache = enable_process_cache(maxsize=32)
    try:
        servers = {
            "plain": _paper(own, "fedentropy-traced"),
            "one": _paper(own, "fedentropy-traced", cpu_mesh(1)),
            "three": _paper(own, "fedentropy-traced", cpu_mesh(3))}
        for server in servers.values():
            _run(server, R)
            assert server.stats()["captured_block"] is True
        keys = [k for k in cache._entries if k[0] == "scan-block"]
        assert len(keys) == 3
        meshes = {k[10] for k in keys}
        assert meshes == {None, cpu_mesh(1).devices, cpu_mesh(3).devices}
        keyed = {name: s._block_key(R) for name, s in servers.items()}
        assert len(set(keyed.values())) == 3
        assert all(s._block_graphs.captures == 0 for s in servers.values())
        seq = _run(_paper(own, "fedentropy-traced", cpu_mesh(3),
                          engine="pipelined",
                          runtime=RuntimeConfig(shard=True)), R)
        _assert_bit_equal(seq, servers["three"])
        _assert_bit_equal(servers["plain"], servers["one"])
    finally:
        disable_process_cache()


def test_capture_route_decided_from_the_mesh(monkeypatch):
    """On a card the block is one captured graph unsharded or on a mesh
    whose positions all name the server's card, and runs eagerly on a
    mesh over distinct cards (a graph is captured on one card's
    streams): decided from the mesh alone, before any launch."""
    from repro_torch.fl.runtime import scan_engine
    monkeypatch.setattr(scan_engine, "capture_enabled", lambda: True)
    card0, card1 = torch.device("cuda", 0), torch.device("cuda", 1)

    def captured(devices, backend="cuda"):
        mesh = None if devices is None else SimpleNamespace(
            devices=tuple(devices), home=devices[0])
        server = SimpleNamespace(device=card0, _fanout=mesh,
                                 runtime=SimpleNamespace(
                                     spec_backend=backend))
        return ScanServer._capture_block(server)

    assert captured(None) and captured([card0]) and captured([card0] * 3)
    assert not captured([card0, card1])
    assert not captured([card0, card1, card0])
    assert not captured([card0] * 3, backend="torch")


def test_scan_shard_mesh_must_start_at_the_server():
    """The inherited constructor checks the mesh before a round: one that
    does not start at the server's device raises."""
    data = _small_data()
    params = tcnn.init(torch.Generator().manual_seed(0), image_hw=16,
                       num_classes=4)
    with pytest.raises(ValueError, match="a mesh of cards serves"):
        tfl.build("fedavg", tcnn.apply, params, data,
                  tfl.ServerConfig(num_clients=SMALL_N, participation=0.5),
                  tfl.LocalSpec(epochs=1, batch_size=20), device="cpu",
                  engine="scan", mesh=[torch.device("meta")],
                  runtime=ScanConfig(shard=True))


# ------------------------------------------- 4 shards against the reference

@pytest.mark.parametrize("comp,mode", RUNS)
def test_four_shards_match_reference_sharded_scan(reference_scans, small,
                                                  comp, mode):
    """The port's scan on 4 CPU shards against the reference's on 4
    forced host devices: both fold, the same padded client count (12),
    integer records and flags exact, entropy within 1e-6, the params
    digest within a relative 1e-5; the integers are the unsharded scan's
    too."""
    port = _run(_small_build(small, comp, cpu_mesh(4), params_mode=mode))
    _folded(port, 4)
    want = reference_scans[f"{comp}/{mode}"]
    assert want["scan_rounds"] == R and want["reasons"] == []
    assert port.corpus.padded_num_clients == want["padded"] == 12
    for w, g in zip(want["history"], port.history, strict=True):
        for key in ("round", "selected", "positive", "negative", "comm",
                    "spec_hit", "redispatched"):
            assert g[key] == w[key], (w["round"], key)
        if np.isnan(w["entropy"]):
            assert np.isnan(g["entropy"])
        else:
            assert g["entropy"] == pytest.approx(w["entropy"], abs=ENT_ATOL)
    assert _digest(port.global_params) == pytest.approx(want["digest"],
                                                        rel=DIGEST_RTOL)
    plain = _run(_small_build(small, comp, params_mode=mode))
    assert _ints(port.history) == _ints(plain.history)
    if comp == "fedentropy-traced":
        assert any(r["negative"] for r in port.history)   # judgment bites


# --------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda", torch.cuda.current_device())


def _card(case, comp, mesh=None, engine="scan", judge=None, **kw):
    """:func:`_small_build` on the card, the float64 oracle as the judge
    unless ``judge`` is given, K2 aggregating."""
    return _small_build(case, comp, mesh, engine, device="cuda",
                        judge=judge or tfl.MaxEntropyJudge(),
                        aggregator=tfl.FusedAverageAggregator("cuda"), **kw)


@pytest.mark.parametrize("comp", ["fedavg", "fedentropy-traced"])
def test_card_three_positions_captured_equal_pipelined(cuda, own_small,
                                                       comp):
    """Three shard positions of the card: the block is one captured graph
    (K1's loop and K2 once a round in each replay), bit for bit the
    pipelined engine's ``shard=True`` rounds on the same mesh, and
    ``disable_capture()``'s eager block; the integers are the unsharded
    scan's."""
    mesh = [cuda] * 3
    pip = _run(_card(own_small, comp, mesh, engine="pipelined"))
    scan = _run(_card(own_small, comp, mesh))
    stats = scan.stats()
    assert stats["captured_block"] is True and stats["shards"] == 3
    _assert_bit_equal(pip, scan)
    with tfl.disable_capture():
        eager = _run(_card(own_small, comp, mesh))
        assert eager.stats()["captured_block"] is False
    _assert_bit_equal(eager, scan)
    plain = _run(_card(own_small, comp))
    assert _ints(scan.history) == _ints(plain.history)
    for key, prog in scan._block_graphs._entries.items():
        depth = key[1]
        assert prog.launches.get("masked_weighted_sum") == depth
        assert prog.launches.get("entropy_judge_loop", 0) == depth


def test_card_one_position_equals_unsharded(cuda, own_small):
    """A mesh of the card alone: the captured sharded block is the
    unsharded one bit for bit."""
    plain = _run(_card(own_small, "fedentropy-traced"))
    one = _run(_card(own_small, "fedentropy-traced", [cuda]))
    assert one.stats()["captured_block"] is True
    _assert_bit_equal(plain, one)


def test_card_forced_miss_remat_rewinds_to_stack(cuda, own_small):
    """A forced miss on three positions of the card, captured: ``"remat"``
    rewinds to ``"stack"``'s bits, and both equal the pipelined sharded
    rounds."""
    mesh = [cuda] * 3
    runs = {mode: _run(_card(own_small, "fedentropy", mesh,
                             params_mode=mode, selector="uniform",
                             judge=_WrongSpeculation()))
            for mode in ("stack", "remat")}
    seq = _run(_card(own_small, "fedentropy", mesh, engine="pipelined",
                     selector="uniform"))
    for scan in runs.values():
        assert scan.stats()["captured_block"] is True
        _assert_bit_equal(seq, scan)
    _assert_bit_equal(runs["stack"], runs["remat"])
    if not any(r["negative"] for r in seq.history):
        pytest.skip("no rejecting round to miss")
    assert any(not r["spec_hit"] for r in runs["remat"].history)


def test_card_counts_per_replay(cuda, own_small):
    """A second block on three positions replays the first one's graph:
    K1's loop and K2 move by R each."""
    scan = _card(own_small, "fedentropy-traced", [cuda] * 3)
    _run(scan, R)
    if not all(r["spec_hit"] for r in scan.history):
        pytest.skip("a natural miss in the first block")
    before = (entropy_judge_loop.launches, masked_weighted_sum.launches)
    _run(scan, R)
    if all(r["spec_hit"] for r in scan.history[R:]):
        assert (entropy_judge_loop.launches - before[0],
                masked_weighted_sum.launches - before[1]) == (R, R)
