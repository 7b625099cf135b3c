"""The client axis over several devices in the port
(``repro_torch.fl.runtime.sharding``, ``ClientCorpus.shard``,
``HostCorpus.shard``, ``RuntimeConfig(shard=True)``), case for case with
``tests/test_uneven_shard.py``, ``tests/test_runtime_edges.py``'s
sharded-wrapper cases and ``tests/test_runtime_engine.py``'s
forced-shard cases, on the CPU.

The reference forces 8 host devices to form a mesh on the CPU; the port
forms one by naming the CPU several times (``make_client_mesh(["cpu"] *
3)``): each shard position holds its own corpus block and runs its own
client program, as on a mesh of distinct devices.

At the golden's sizes (``tests/golden/uneven_history.json``: N = 100,
cohorts of 10, 16x16 images, 10 classes, ``LocalSpec(epochs=1,
batch_size=10)``; the init params drawn under
``jax.threefry_partitionable(False)``, ROADMAP F1, and converted):

* padding (``pad_client_axis``, ``pad_to_multiple``) and cohort gathers
  through the padded layout: bit for bit against the reference and the
  host slice;
* the golden histories on a 3-shard mesh (and fedentropy on 8) with
  speculation off and on: integer records exact, entropy within 1e-6 of
  the golden (the port's policy; a shard vmaps 4 clients where the
  recorder vmapped 10); speculation on and off bit for bit (the same
  programs);
* a 1-shard mesh: bit for bit the unsharded engine;
* other engines and planes on 3 shards against their unsharded runs:
  integer records exact, entropy within 1e-6, params within 1e-5.

The ``test_card_*`` cases need a card and skip without one; they take
the port's own init params and import nothing of JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_shard.py -k card
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.configs import ARCHS
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.data.corpus import ClientCorpus, pad_client_axis
from repro_torch.data.partition import partition, stack_clients
from repro_torch.data.stream import HostCorpus
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.runtime import (AsyncConfig, ClientMesh, RuntimeConfig,
                                    client_mesh_from,
                                    disable_process_cache,
                                    enable_process_cache, make_client_mesh,
                                    make_sharded_client_fn, pad_to_multiple)
from repro_torch.fl.runtime.sharding import ShardBlocks
from repro_torch.fl.server import _make_client_fn
from repro_torch.kernels.entropy_judge import entropy_judge_loop
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import (fl_clients_for, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models import cnn as tcnn
from repro_torch.models.api import build_model

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "uneven_history.json")
PAPER_N, CLASSES = 100, 10
ENT_ATOL = 1e-6
PARAMS_ATOL = 1e-5
VARIANTS = {"fedentropy": "fedentropy", "fedcat_maxent": "fedcat+maxent",
            "fedentropy_queue": "fedentropy+queue"}


def cpu_mesh(n: int) -> ClientMesh:
    return make_client_mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import repro.fl as rfl
    from repro.data import corpus as jcorpus
    from repro.fl.runtime import sharding as jsharding
    from repro.models import cnn as jcnn
    return SimpleNamespace(jax=jax, fl=rfl, corpus=jcorpus,
                           sharding=jsharding, cnn=jcnn)


def _paper_data():
    """tests/golden/record_uneven.py's corpus (the port's numpy
    transcriptions draw the same arrays)."""
    (xtr, ytr), _ = make_image_dataset(
        num_classes=CLASSES, train_per_class=2 * PAPER_N,
        test_per_class=10, hw=16, noise=0.9, seed=0)
    parts = partition("case1", ytr, PAPER_N, CLASSES, seed=0)
    return stack_clients(xtr, ytr, parts, batch_multiple=10)


@pytest.fixture(scope="module")
def paper(ref):
    """The golden's data and init params (F1: the pre-partitionable
    threefry), converted."""
    with ref.jax.threefry_partitionable(False):
        params = ref.cnn.init(ref.jax.random.PRNGKey(0), image_hw=16,
                              num_classes=CLASSES)
    return _paper_data(), cnn_params_from_numpy(
        ref.jax.tree.map(np.asarray, params))


def _tiny_data():
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    return stack_clients(xtr, ytr, partition("case1", ytr, 8, 4, seed=0),
                         batch_multiple=20)


@pytest.fixture(scope="module")
def tiny():
    """tests/test_runtime_engine.py's fixture with the port's own init
    params (port against port)."""
    return _tiny_data(), tcnn.init(torch.Generator().manual_seed(0),
                                   image_hw=16, num_classes=4)


def _paper_build(case, comp, device="cpu", **kw):
    data, params = case
    strategy = tfl.get("composition", comp).strategy
    return tfl.build(comp, tcnn.apply, params, data,
                     tfl.ServerConfig(num_clients=PAPER_N, participation=0.1,
                                      seed=0, group_size=2),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=10),
                     device=device, **kw)


def _tiny_build(case, comp="fedentropy", device="cpu", clusters=1, **kw):
    data, params = case
    strategy = tfl.get("composition", comp).strategy
    return tfl.build(comp, tcnn.apply, params, data,
                     tfl.ServerConfig(num_clients=8, participation=0.5,
                                      seed=0, num_clusters=clusters),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     device=device, **kw)


def _run(server, rounds=3):
    for _ in range(rounds):
        server.round()
    return server


def _ints(h):
    return [(r["selected"], r["positive"], r["negative"],
             r["comm"]["total_bytes"]) for r in h]


def _assert_bit_equal(a, b):
    """Records (the speculation flags apart) and params bit for bit."""
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        for key in set(x) & set(y):
            if key == "entropy" and np.isnan(x[key]):
                assert np.isnan(y[key])
            else:
                assert x[key] == y[key], (x["round"], key)
    for s, t in zip(pytree.tree_leaves(a.global_params),
                    pytree.tree_leaves(b.global_params), strict=True):
        assert torch.equal(s, t)


def _assert_close(got, want):
    """Integer records exact, entropy within ENT_ATOL, params within
    PARAMS_ATOL: the port's policy across program shapes."""
    assert _ints(got.history) == _ints(want.history)
    for x, y in zip(got.history, want.history):
        if np.isnan(y["entropy"]):
            assert np.isnan(x["entropy"])
        else:
            assert x["entropy"] == pytest.approx(y["entropy"], abs=ENT_ATOL)
    for s, t in zip(pytree.tree_leaves(got.global_params),
                    pytree.tree_leaves(want.global_params), strict=True):
        torch.testing.assert_close(s, t, rtol=0, atol=PARAMS_ATOL)


# ------------------------------------------------------- padding (any mesh)

@pytest.mark.parametrize("pad", [0, 1, 3])
def test_pad_client_axis_matches_reference(ref, pad):
    """Pad rows are zeros in every array, real rows and dtypes untouched,
    the reference's bits; identity (the same tensors) at pad 0."""
    rng = np.random.default_rng(pad)
    arrays = {"x": rng.integers(0, 255, (4, 6, 3)).astype(np.uint8),
              "y": rng.integers(0, 4, (4, 6)).astype(np.int32),
              "w": rng.random((4, 6)).astype(np.float32)}
    got = pad_client_axis({k: torch.as_tensor(v)
                           for k, v in arrays.items()}, pad)
    want = ref.corpus.pad_client_axis(
        {k: ref.jax.numpy.asarray(v) for k, v in arrays.items()}, pad)
    for k in arrays:
        assert got[k].shape[0] == 4 + pad
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    if pad == 0:
        same = {k: torch.as_tensor(v) for k, v in arrays.items()}
        assert all(pad_client_axis(same, 0)[k] is same[k] for k in same)


@pytest.mark.parametrize("rows,multiple", [(5, 4), (5, 5), (10, 3),
                                           (10, 8), (1, 3)])
def test_pad_to_multiple_matches_reference(ref, rows, multiple):
    """Edge repeat of the leading axis, the reference's bits, for tensors
    and numpy arrays; None leaves pass."""
    rng = np.random.default_rng(rows * 10 + multiple)
    tree = {"x": rng.normal(size=(rows, 2)).astype(np.float32),
            "y": np.arange(rows, dtype=np.int64)}
    want = ref.sharding.pad_to_multiple(
        {k: ref.jax.numpy.asarray(v) for k, v in tree.items()}, multiple)
    got_t = pad_to_multiple({k: torch.as_tensor(v) for k, v in tree.items()},
                            multiple)
    got_n = pad_to_multiple(tree, multiple)
    for k in tree:
        np.testing.assert_array_equal(got_t[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(got_n[k], np.asarray(want[k]))
    assert got_t["x"].shape[0] % multiple == 0
    assert pad_to_multiple({"a": None}, 3) == {"a": None}


# ------------------------------------------------------ the padded layout

@pytest.mark.parametrize("shards,padded", [(3, 102), (8, 104)])
def test_padded_shard_layout_real_n_control_plane(ref, shards, padded):
    """N = 100 on 3 and 8 CPU shards: every array split into equal
    blocks (padded to 102 and 104), each block its share of the bytes,
    the real-N control plane equal to the reference's corpus, the pad
    rows zero and invalid, and a signature apart from the unsharded
    one."""
    data = _paper_data()
    corpus = ClientCorpus(dict(data), device="cpu")
    want = ref.corpus.ClientCorpus.from_stacked(dict(data))
    unsharded_sig = corpus.signature()
    mesh = cpu_mesh(shards)
    assert corpus.shard(mesh) is corpus
    corpus.shard(mesh)                                    # idempotent
    assert corpus.padded_num_clients == padded
    assert corpus.num_clients == PAPER_N and corpus.mesh == mesh
    per = padded // shards
    assert len(corpus._blocks) == shards
    for blk in corpus._blocks:
        for k, v in blk.items():
            assert v.shape[0] == per, k
    sizes = corpus.block_nbytes()
    assert len(sizes) == shards and len(set(sizes)) == 1
    assert sizes[0] * shards == corpus.nbytes
    # every block on the CPU: the busiest device holds them all
    assert corpus.device_nbytes() == corpus.nbytes
    # the pad rows are zero; the real rows the input's
    for k, v in data.items():
        full = corpus[k].numpy()
        np.testing.assert_array_equal(full[:PAPER_N], v)
        assert not full[PAPER_N:].any()
    valid = corpus.client_valid
    assert valid.shape == (padded,) and valid.sum() == PAPER_N
    assert valid[:PAPER_N].all() and not valid[PAPER_N:].any()
    np.testing.assert_array_equal(corpus.sizes(), want.sizes())
    np.testing.assert_array_equal(corpus.label_histograms(),
                                  want.label_histograms())
    np.testing.assert_array_equal(corpus.label_entropy(),
                                  want.label_entropy())
    for k, v in want.as_numpy().items():
        np.testing.assert_array_equal(corpus.as_numpy()[k], v)
    assert corpus.signature() != unsharded_sig
    assert corpus.signature()[2] == padded - PAPER_N
    assert corpus.memory_report()["num_clients"] == PAPER_N


def test_reshard_onto_different_mesh_rederives_pad():
    """3 shards (102 rows) then 8 (104): the pad is re-derived from the
    real rows (no pad on pad), and cohorts still equal the host slice."""
    data = _paper_data()
    corpus = ClientCorpus(dict(data), device="cpu")
    corpus.shard(cpu_mesh(3))
    assert corpus.padded_num_clients == 102
    corpus.shard(cpu_mesh(8))
    assert corpus.padded_num_clients == 104 and corpus.num_clients == PAPER_N
    assert corpus.signature()[2] == 4
    idx = np.array([3, 57, 99])
    got = corpus.cohort(idx)
    for k, v in data.items():
        np.testing.assert_array_equal(got[k].numpy(), v[idx])


@pytest.mark.parametrize("queued", [False, True])
def test_padded_cohort_matches_host_slice(queued):
    """Global ids across shard boundaries through the padded layout equal
    the host slice bit for bit, with and without a queue's ``active``
    mask; ``cohort_blocks`` fills each block with its layout's rows and
    counts the rows it copied between blocks."""
    data = _paper_data()
    corpus = ClientCorpus(dict(data), device="cpu")
    plain = ClientCorpus(dict(data), device="cpu")
    corpus.shard(cpu_mesh(3))                       # 34 rows a block
    idx = np.array([0, 7, 99, 42, 13, 98])
    active = np.array([1, 5, 10, 2, 20, 3]) if queued else None
    got = corpus.cohort(idx, active)
    want = plain.cohort(idx, active)
    for k in data:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
        if k != "w" or not queued:
            np.testing.assert_array_equal(got[k].numpy(), data[k][idx])
    if queued:
        live = np.arange(data["w"].shape[1])[None, :] < active[:, None]
        np.testing.assert_array_equal(got["w"].numpy(),
                                      data["w"][idx] * live)
    # blocks of two rows each, rows from blocks 0, 0 | 2, 1 | 0, 2
    corpus.block_copy_nbytes = 0
    layout = np.arange(6).reshape(3, 2)
    blocks = corpus.cohort_blocks(idx, active, layout, corpus.mesh.devices)
    for b, blk in enumerate(blocks):
        for k in data:
            np.testing.assert_array_equal(
                blk[k].numpy(), want[k].numpy()[layout[b]])
    row = sum(v[0].nbytes for v in data.values())
    # block 1 takes 99 (block 2) and 42 (block 1); block 2 takes 13
    # (block 0) and 98 (block 2): two rows crossed blocks
    assert corpus.block_copy_nbytes == 2 * row


def test_drift_keeps_the_layout():
    """``with_rows`` (a drift event) keeps the mesh and the pad, replaces
    the rows in their blocks, and leaves the source corpus untouched."""
    data = _paper_data()
    corpus = ClientCorpus(dict(data), device="cpu").shard(cpu_mesh(3))
    clients = [5, 40, 99]
    rows = {k: np.flip(v[[1, 2, 3]], axis=1).copy() for k, v in data.items()}
    new = corpus.with_rows(clients, rows)
    assert new.mesh == corpus.mesh and new.padded_num_clients == 102
    assert new.signature() == corpus.signature()
    got = new.cohort(np.array(clients + [0]))
    for k, v in data.items():
        np.testing.assert_array_equal(got[k].numpy()[:3], rows[k])
        np.testing.assert_array_equal(got[k].numpy()[3], v[0])
        np.testing.assert_array_equal(corpus.cohort(np.array(clients))[k]
                                      .numpy(), v[clients])


def test_host_corpus_uploads_each_block():
    """The streaming plane records the mesh and uploads each block from a
    host gather; a staged prefetch of the same cohort gives the same
    bits."""
    data = _paper_data()
    host = HostCorpus(dict(data), device="cpu").shard(cpu_mesh(3))
    idx = np.array([0, 7, 99, 42, 13])
    layout = pad_to_multiple(np.arange(5), 3).reshape(3, 2)   # [4, 4] last
    blocks = host.cohort_blocks(idx, None, layout, host.mesh.devices)
    for b, blk in enumerate(blocks):
        for k, v in data.items():
            np.testing.assert_array_equal(blk[k].numpy(),
                                          v[idx[layout[b]]])
    host.prefetch(idx)
    staged = host.cohort_blocks(idx, None, layout, host.mesh.devices)
    assert host.prefetch_stats()["hits"] == 1
    for a, b in zip(blocks, staged):
        for k in data:
            assert torch.equal(a[k], b[k])


# ------------------------------------------------ golden round equivalence

@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


def _check_golden(server, golden_variant):
    want = golden_variant["history"]
    assert _ints(server.history) == [
        (g["selected"], g["positive"], g["negative"], g["total_bytes"])
        for g in want]
    for rec, g in zip(server.history, want):
        assert rec["entropy"] == pytest.approx(float(g["entropy"]),
                                               abs=ENT_ATOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_uneven_golden_histories_on_three_shards(paper, golden, variant):
    """At N = 100 on a 3-shard mesh (corpus padded to 102, cohorts to 12,
    4 a shard; fedcat+maxent's 5 chains of 2 to 6 groups, 2 a shard),
    the sequential ``Server`` and ``PipelinedServer`` with speculation
    off and on reproduce the recorded histories: integers exact, entropy
    within 1e-6; speculation on and off bit for bit."""
    comp = VARIANTS[variant]
    mesh = cpu_mesh(3)
    engines = {
        "seq": _paper_build(paper, comp),
        "off": _paper_build(paper, comp, mesh=mesh,
                            runtime=RuntimeConfig(shard=True)),
        "spec": _paper_build(paper, comp, mesh=mesh,
                             runtime=RuntimeConfig(shard=True,
                                                   speculate=True)),
    }
    for server in engines.values():
        _run(server, len(golden[variant]["history"]))
        _check_golden(server, golden[variant])
    for name in ("off", "spec"):
        corpus = engines[name].corpus
        assert corpus.padded_num_clients == 102 and corpus.mesh == mesh
        assert engines[name].client_mesh() == mesh
    assert engines["seq"].corpus.padded_num_clients == PAPER_N
    _assert_bit_equal(engines["off"], engines["spec"])


def test_uneven_golden_fedentropy_on_eight_shards(paper, golden):
    """fedentropy on 8 shards (104 rows, cohorts of 10 padded to 16):
    the golden, speculation on and off bit for bit."""
    mesh = cpu_mesh(8)
    off = _run(_paper_build(paper, "fedentropy", mesh=mesh,
                            runtime=RuntimeConfig(shard=True)))
    spec = _run(_paper_build(paper, "fedentropy", mesh=mesh,
                             runtime=RuntimeConfig(shard=True,
                                                   speculate=True)))
    for server in (off, spec):
        _check_golden(server, golden["fedentropy"])
        assert server.corpus.padded_num_clients == 104
    _assert_bit_equal(off, spec)


@pytest.mark.parametrize("speculate", [False, True])
def test_one_shard_mesh_is_bit_for_bit_unsharded(tiny, speculate):
    """shard=True on a mesh of one CPU shard runs the fan-out (one block,
    no pad) and equals the unsharded engine bit for bit, records, entropy
    and params (the reference's test_forced_shard_map_matches_sequential
    holds it within 1e-6; here the program is the same)."""
    rt = dict(speculate=speculate)
    plain = _run(_tiny_build(tiny, engine="pipelined",
                             runtime=RuntimeConfig(shard=False, **rt)))
    one = _tiny_build(tiny, mesh=cpu_mesh(1),
                      runtime=RuntimeConfig(shard=True, **rt))
    calls = []
    fanout = one._run_sharded
    one._run_sharded = lambda *a: calls.append(1) or fanout(*a)
    _run(one)
    assert calls                     # the fan-out ran
    assert one.corpus.mesh == cpu_mesh(1)
    assert one.corpus.signature() == plain.corpus.signature()
    _assert_bit_equal(plain, one)


def test_fedcat_padded_group_is_inert(tiny):
    """3 chain groups on a 2-shard mesh pad to 4 (the last group
    repeated); poisoning the pad group's data moves no real output bit,
    and the real groups equal the unsharded chain program within 1e-6."""
    data, params = tiny
    strat = tfl.CatChainStrategy(tfl.LocalSpec("catchain", epochs=1,
                                               batch_size=20), 2)
    corpus = ClientCorpus(dict(data), device="cpu")
    cohort = corpus.cohort(np.arange(6))
    gdata, aux = strat.prepare_round(cohort, None)          # (3, 2, ...)
    program = strat.make_client_fn(tcnn.apply)
    want = program(params, gdata, None, None, None, aux["valid"])
    mesh = cpu_mesh(2)
    fn = make_sharded_client_fn(tcnn.apply, strat.spec,
                                strat.client_in_axes(), mesh,
                                inner=program)
    got = fn(params, gdata, None, None, None, aux["valid"])
    for a, b in zip(pytree.tree_leaves(got), pytree.tree_leaves(want)):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    padded = pad_to_multiple(gdata, 2)
    assert padded["x"].shape[0] == 4
    blocks = [{k: v[:2] for k, v in padded.items()},
              {k: v[2:] for k, v in padded.items()}]
    poisoned = [blocks[0], {k: v.clone() for k, v in blocks[1].items()}]
    for k in poisoned[1]:
        poisoned[1][k][1] = padded[k][0]
    a = fn(params, ShardBlocks(blocks, 3), None, None, None, aux["valid"])
    b = fn(params, ShardBlocks(poisoned, 3), None, None, None, aux["valid"])
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)):
        assert x.shape[0] == 3 and torch.equal(x, y)
    for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(got)):
        assert torch.equal(x, y)


def test_sharded_wrapper_pads_and_cuts_the_vmap_path(tiny):
    """The plain vmapped path: an uneven cohort of 3 on 2 shards pads to
    4 and comes back with 3 rows, within 1e-6 of the vmapped program
    (tests/test_runtime_edges.py's regression guard)."""
    data, params = tiny
    strat = tfl.FedAvgStrategy(tfl.LocalSpec(epochs=1, batch_size=20))
    cohort = ClientCorpus(dict(data), device="cpu").cohort([0, 1, 2])
    fn = make_sharded_client_fn(tcnn.apply, strat.spec,
                                strat.client_in_axes(), cpu_mesh(2))
    assert fn.mesh == cpu_mesh(2)
    out = fn(params, cohort, None, None, None)
    assert out["soft_label"].shape[0] == 3
    want = _make_client_fn(tcnn.apply, strat.spec, strat.client_in_axes())(
        params, cohort, None, None, None)
    for a, b in zip(pytree.tree_leaves(out), pytree.tree_leaves(want)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_client_mesh_from_host_mesh(tiny):
    """A ``launch.mesh`` host grid reduces to its client rows (one per
    ("pod", "data") row) and drives a sharded round."""
    grid = make_host_mesh()
    cm = client_mesh_from(grid)
    assert cm.shape == {"clients": fl_clients_for(grid)}
    assert cm.devices == (torch.device("cpu"),)
    assert client_mesh_from(cm) is cm
    server = _tiny_build(tiny, engine="pipelined",
                         runtime=RuntimeConfig(shard=True), mesh=grid)
    rec = server.round()
    assert server.client_mesh() == cm
    assert len(rec["positive"]) + len(rec["negative"]) == 4
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="gradient-level mesh step"):
        make_production_mesh(multi_pod=True)


# ------------------------------------ other engines, planes and strategies

def test_ifca_maxent_pipelined_on_three_shards(tiny):
    """A clustered server (K = 3, the params slot on axis 0, split with
    the cohort rows), speculation on, 3 shards against unsharded."""
    kw = dict(comp="ifca+maxent", clusters=3, engine="pipelined")
    plain = _run(_tiny_build(tiny, runtime=RuntimeConfig(speculate=True),
                             **kw))
    shard = _run(_tiny_build(tiny, mesh=cpu_mesh(3), runtime=RuntimeConfig(
        shard=True, speculate=True), **kw))
    assert shard.corpus.padded_num_clients == 9
    _assert_close(shard, plain)
    for x, y in zip(shard.history, plain.history):
        assert x["cluster"] == y["cluster"]


def test_async_on_three_shards(tiny):
    """The async engine forwards ``AsyncConfig.shard`` to the fan-out."""
    plain = _run(_tiny_build(tiny, runtime=AsyncConfig(
        clock="straggler", staleness_alpha=0.5)))
    shard = _run(_tiny_build(tiny, mesh=cpu_mesh(3), runtime=AsyncConfig(
        clock="straggler", staleness_alpha=0.5, shard=True)))
    assert shard.corpus.mesh == cpu_mesh(3)
    _assert_close(shard, plain)


def test_streaming_plane_on_three_shards(tiny):
    """The streaming plane: each block uploaded to its shard from the
    host (staged ahead under speculation), the host corpus unmoved."""
    plain = _run(_tiny_build(tiny, data_plane="streaming",
                             runtime=RuntimeConfig(speculate=True)))
    shard = _run(_tiny_build(tiny, data_plane="streaming", mesh=cpu_mesh(3),
                             runtime=RuntimeConfig(shard=True,
                                                   speculate=True)))
    assert isinstance(shard.corpus, HostCorpus)
    assert shard.corpus.mesh == cpu_mesh(3)
    assert shard.corpus.prefetch_stats()["hits"] >= 1
    _assert_close(shard, plain)


def test_lmstep_on_three_shards():
    """lmstep's five-argument client (``inner_axes=()``) at reduced
    qwen3-0.6b: 8 clients of 4 windows, cohorts of 4 padded to 6 on 3
    shards, speculation on, against unsharded."""
    cfg = ARCHS["qwen3-0.6b"].reduced()
    model = build_model(cfg, device="cpu", kernels="torch", seed=0)
    corpus, idx = ttrain.build_fl_corpus(cfg, 8, "case1", 12, 0)
    data = ttrain.stack_lm_clients(corpus, idx, 4, 12, 0)
    params = {k: v.detach() for k, v in model.params().items()}
    apply = ttrain.lm_window_apply(model, cfg)

    def build(**kw):
        return tfl.build("fedentropy", apply, params, data,
                         tfl.ServerConfig(num_clients=8, participation=0.5,
                                          seed=0),
                         tfl.LocalSpec(epochs=1, lr=0.01, batch_size=2),
                         strategy="lmstep", device="cpu", **kw)

    plain = _run(build(runtime=RuntimeConfig(speculate=True)), 2)
    shard = _run(build(mesh=cpu_mesh(3), runtime=RuntimeConfig(
        shard=True, speculate=True)), 2)
    assert shard.corpus.padded_num_clients == 9
    _assert_close(shard, plain)


def test_process_cache_keys_sharded_and_unsharded_apart(tiny):
    """One entry for the unsharded program, one a shard position for the
    3-shard fan-out, none shared; a second sharded server hits all
    three."""
    cache = enable_process_cache(maxsize=16)
    try:
        _tiny_build(tiny, engine="pipelined",
                    runtime=RuntimeConfig(shard=False)).round()
        assert cache.stats()["entries"] == 1
        _tiny_build(tiny, mesh=cpu_mesh(3),
                    runtime=RuntimeConfig(shard=True)).round()
        assert cache.stats()["entries"] == 4
        hits = cache.stats()["hits"]
        _tiny_build(tiny, mesh=cpu_mesh(3),
                    runtime=RuntimeConfig(shard=True)).round()
        assert cache.stats()["entries"] == 4
        assert cache.stats()["hits"] == hits + 3
        _tiny_build(tiny, mesh=cpu_mesh(2),
                    runtime=RuntimeConfig(shard=True)).round()
        assert cache.stats()["entries"] == 6
    finally:
        disable_process_cache()


def test_servers_sharing_a_corpus_lay_out_their_own(tiny):
    """Servers on one corpus object, round by round in turns: each sharded
    server lays out its own copy once, at construction, and the shared
    corpus stays unlaid, so a 2-shard, a 3-shard, an unsharded and a scan
    server each run as they run alone; a corpus already laid out over a
    server's mesh is taken as it is; the default mesh on the CPU is the
    server's device alone."""
    corpus = ClientCorpus(dict(tiny[0]), device="cpu")
    rt = RuntimeConfig(shard=True, speculate=True)
    two = _tiny_build((corpus, tiny[1]), mesh=cpu_mesh(2), runtime=rt)
    three = _tiny_build((corpus, tiny[1]), mesh=cpu_mesh(3), runtime=rt)
    plain = _tiny_build((corpus, tiny[1]), engine="pipelined",
                        runtime=RuntimeConfig(speculate=True))
    scan = _tiny_build((corpus, tiny[1]), engine="scan",
                       runtime=tfl.ScanConfig(rounds_per_scan=1))
    servers = (two, three, plain, scan)
    layouts = [s.corpus._blocks for s in servers[:2]]
    for _ in range(3):
        for server in servers:
            server.round()
    assert corpus.mesh is None and corpus.padded_num_clients == 8
    assert plain.corpus is corpus and scan.corpus is corpus
    assert (two.corpus.padded_num_clients,
            three.corpus.padded_num_clients) == (8, 9)
    assert [s.corpus._blocks for s in servers[:2]] == layouts
    alone = {n: _run(_tiny_build(tiny, mesh=cpu_mesh(n), runtime=rt))
             for n in (2, 3)}
    _assert_bit_equal(alone[2], two)
    _assert_bit_equal(alone[3], three)
    _assert_bit_equal(_run(_tiny_build(tiny, engine="pipelined",
                                       runtime=RuntimeConfig(
                                           speculate=True))), plain)
    _assert_close(three, plain)
    _assert_close(scan, plain)
    laid = ClientCorpus(dict(tiny[0]), device="cpu").shard(cpu_mesh(3))
    assert _tiny_build((laid, tiny[1]), mesh=cpu_mesh(3),
                       runtime=rt).corpus is laid
    default = _tiny_build(tiny, runtime=RuntimeConfig(shard=True))
    assert default.client_mesh() == make_client_mesh(["cpu"])
    assert default.corpus.mesh == make_client_mesh(["cpu"])


# ------------------------------------------------------------ no fallback

def test_a_mesh_that_cannot_serve_raises(tiny):
    """A mesh of another kind of device, or not starting at the server's,
    raises at construction; a failing shard raises; nothing runs
    unsharded in their place."""
    meta = SimpleNamespace(devices=(torch.device("meta"),),
                           axis_name="clients")
    with pytest.raises(ValueError, match="a mesh of CPU shards"):
        ClientCorpus(dict(tiny[0]), device="cpu").shard(meta)
    with pytest.raises(ValueError, match="all cards or all CPU"):
        ClientMesh(("cpu", "meta"))
    with pytest.raises(ValueError, match="a mesh of CPU shards"):
        HostCorpus(dict(tiny[0]), device="cpu").shard(ClientMesh(("meta",)))
    with pytest.raises(ValueError, match="a mesh of CPU shards"):
        _tiny_build(tiny, mesh=("meta",), runtime=RuntimeConfig(shard=True))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_client_mesh(["cuda:0"])
    else:
        with pytest.raises(RuntimeError, match="visible"):
            make_client_mesh([f"cuda:{torch.cuda.device_count()}"])
    data, params = tiny
    strat = tfl.FedAvgStrategy(tfl.LocalSpec(epochs=1, batch_size=20))

    def fail(*args):
        raise RuntimeError("shard 1 failed")

    def program(j, args):
        return fail if j == 1 else (lambda *a: {"size": torch.ones(2)})
    fn = make_sharded_client_fn(tcnn.apply, strat.spec,
                                strat.client_in_axes(), cpu_mesh(2),
                                program=program)
    cohort = ClientCorpus(dict(data), device="cpu").cohort([0, 1, 2])
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        fn(params, cohort, None, None, None)


# --------------------------------------------------------------- card only

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and K1 have no CPU "
                    "mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


def _card_build(case, comp, **kw):
    data, params = case
    strategy = tfl.get("composition", comp).strategy
    if comp != "fedcat+maxent":
        kw["aggregator"] = tfl.FusedAverageAggregator("cuda")
    return tfl.build(comp, tcnn.apply, params, data,
                     tfl.ServerConfig(num_clients=8, participation=0.5,
                                      seed=0, group_size=2),
                     tfl.LocalSpec(strategy, epochs=1, batch_size=20),
                     judge=tfl.MaxEntropyJudge(), device="cuda", **kw)


def test_card_one_card_mesh_equals_unsharded(cuda, tiny):
    """A mesh of the one card, captured, speculation through K1's loop:
    bit for bit the unsharded pipelined engine, one graph."""
    spec = RuntimeConfig(speculate=True)
    plain = _run(_card_build(tiny, "fedentropy", runtime=spec))
    k1 = entropy_judge_loop.launches
    one = _run(_card_build(tiny, "fedentropy", mesh=[cuda],
                           runtime=RuntimeConfig(shard=True,
                                                 speculate=True)))
    assert entropy_judge_loop.launches - k1 == 3
    assert one.graphs_captured == 1
    _assert_bit_equal(plain, one)


@pytest.mark.parametrize("comp", ["fedentropy", "fedcat+maxent"])
def test_card_three_shards_on_one_card(cuda, tiny, comp):
    """Three shard positions on the one card (three graphs), speculation
    on: records and params bit for bit those of a sequential server whose
    program runs the same three blocks in turn, and integer records equal
    to the plain sequential server's (its params part by the vmap's
    width: the cohort of 4 pads to 6, 2 a shard, and cuDNN sums in
    another order at 2 clients than at 4); K2 aggregates fedentropy's
    rounds after the gather. The blocked server is ``chip_smoke.py``'s,
    which phase 22 holds the same way."""
    from chip_smoke import blocked_server
    seq = _run(_card_build(tiny, comp))
    blocked = _run(blocked_server(_card_build(tiny, comp), 3))
    chain = comp == "fedcat+maxent"
    k2 = masked_weighted_sum.launches
    three = _run(_card_build(tiny, comp, mesh=[cuda] * 3,
                             runtime=RuntimeConfig(shard=True,
                                                   speculate=True)))
    if not chain:
        assert masked_weighted_sum.launches - k2 >= 3
    assert three.graphs_captured == 3
    assert three.corpus.padded_num_clients == 9
    _assert_bit_equal(blocked, three)
    assert _ints(three.history) == _ints(seq.history)
