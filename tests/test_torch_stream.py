"""The port's streaming data plane (``repro_torch.data.stream``).

On the CPU, on seeded numpy inputs, against the live reference
(``repro.data.stream``) and inside the port:

* ``HostCorpus``'s open-time stats equal the reference's ``HostCorpus``
  and the port's ``ClientCorpus`` bit for bit at any chunk size (a
  hypothesis property and a fixed twin);
* cohorts are equal bit for bit across the port's two planes, queued and
  not, with and without a transform, and within 1e-6 of the reference's
  (float32 normalisation in another library);
* ``save``/``open`` memory-map the store; ``signature`` keys the plane;
  ``as_data_plane``'s modes, ``"auto"`` deciding exactly where the
  reference's does (F6); ``memory_report`` has the reference's keys and
  byte counts;
* the prefetcher's hit, miss and cancel counts equal the reference's on
  the same call sequence (depth 1 and the depth-2 ring), its ring stays
  bounded, and a worker's exception is raised on ``take``;
* on the streaming plane, ``Server``, ``PipelinedServer`` with
  speculation off and on (prefetch hits == speculation hits), a forced
  miss, ``fedentropy+queue``, a drift and the async engine equal the same
  runs on the resident plane bit for bit, and the live reference's
  streaming runs under the port's policy (integers exact, entropy within
  1e-6, the params digest within a relative 1e-6);
* a ``ScanServer`` on a ``HostCorpus`` falls back with the reference's
  ``host-data-plane`` flags;
* ``BoundedGraphCache`` and ``ProcessCompileCache`` build once per key
  under threads.

The ``test_card_*`` cases need a card and skip without one: pinned
staging, the depth-2 ring under back-to-back starts, a capture while a
prefetch is in flight, and the pipelined engine under capture on the
streaming plane with a forced miss. They import nothing of JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_stream.py -k card
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as tfl
from repro_torch.convert import cnn_params_from_numpy
from repro_torch.data.corpus import ClientCorpus, Normalize
from repro_torch.data.partition import (drift_schedule, partition,
                                        stack_clients)
from repro_torch.data.stream import (RESIDENT_BUDGET_BYTES, HostCorpus,
                                     as_data_plane, plane_of)
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.fl.graph_cache import BoundedGraphCache, CapturedProgram
from repro_torch.fl.runtime import (AsyncConfig, RuntimeConfig, ScanConfig,
                                    disable_process_cache,
                                    enable_process_cache)
from repro_torch.models import cnn as tcnn

try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # the property case skips without hypothesis
    given = None

ROUNDS = 3
ENT_ATOL = 1e-6
DIGEST_RTOL = 1e-6
NORM = Normalize(scale=1 / 255.0, mean=(0.4, 0.5, 0.6), std=(0.2, 0.3, 0.4))


def _split():
    """tests/test_fl_api.py's data (the port's numpy transcriptions draw
    the same arrays as repro's), with the raw split."""
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
        pytest.skip("needs a CUDA device: pinned staging, side streams and "
                    "CUDA graphs have no CPU mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


def _uint8_corpus(rng, n, s, c, hw=2):
    """A stacked dict with the stack_clients contract (0/1 float32 w) and
    uint8 images, the storage dtype real ingest gives."""
    return {"x": rng.integers(0, 256, (n, s, hw, hw, 3), dtype=np.uint8),
            "y": rng.integers(0, c, (n, s)).astype(np.int32),
            "w": (rng.random((n, s)) < 0.8).astype(np.float32)}


def _np(tree: dict) -> dict:
    return {k: np.asarray(v.cpu()) if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}


def _assert_same_cohort(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


# ------------------------------------------------------- streamed stats

def _assert_stats_equal(data, chunk):
    from repro.data.corpus import ClientCorpus as JCorpus
    from repro.data.stream import HostCorpus as JHost
    host = HostCorpus(dict(data), stats_chunk=chunk, device="cpu")
    dense = ClientCorpus(dict(data), device="cpu")
    ref = JHost(dict(data), stats_chunk=chunk)
    ref_dense = JCorpus(dict(data))
    c = int(np.asarray(data["y"]).max()) + 4
    for other in (dense, ref, ref_dense):
        np.testing.assert_array_equal(host.sizes(), other.sizes())
        np.testing.assert_array_equal(host.label_histograms(),
                                      other.label_histograms())
        np.testing.assert_array_equal(host.label_entropy(),
                                      other.label_entropy())
        np.testing.assert_array_equal(host.label_histograms(c),
                                      other.label_histograms(c))
    assert host.label_histograms(c) is host.label_histograms(c)


if given is not None:
    @settings(max_examples=12, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), n=st.integers(1, 20),
           s=st.integers(1, 10), c=st.integers(2, 10),
           chunk=st.integers(1, 24))
    def test_streamed_stats_equal_reference_and_dense(seed, n, s, c, chunk):
        pytest.importorskip("jax")
        _assert_stats_equal(_uint8_corpus(np.random.default_rng(seed),
                                          n, s, c), chunk)
else:
    @pytest.mark.skip(reason="hypothesis is not installed")
    def test_streamed_stats_equal_reference_and_dense():
        pass


@pytest.mark.parametrize("chunk", [1, 3, 8, 4096])
def test_streamed_stats_fixed_chunks(tiny, chunk):
    _assert_stats_equal(tiny[1], chunk)


# ------------------------------------------------------------- cohorts

@pytest.mark.parametrize("transform", [False, True])
@pytest.mark.parametrize("queued", [False, True])
def test_cohort_equal_across_planes_and_to_reference(transform, queued):
    from repro.data.stream import HostCorpus as JHost
    data = _uint8_corpus(np.random.default_rng(1), 9, 12, 5)
    t = NORM if transform else None
    dense = ClientCorpus(dict(data), transform=t, device="cpu")
    host = HostCorpus(dict(data), transform=t, device="cpu")
    idx = np.asarray([5, 0, 3, 3, 8])
    act = np.asarray([7, 1, 12, 4, 0]) if queued else None
    want = dense.cohort(idx, active=act)
    _assert_same_cohort(host.cohort(idx, active=act), want)
    host.prefetch(idx, act)                         # the staged route
    _assert_same_cohort(host.cohort(idx, active=act), want)
    assert host.prefetch_stats()["hits"] == 1
    ref = _np(JHost(dict(data), transform=None if t is None else
                    _jnorm(t)).cohort(idx, active=act))
    got = _np(want)
    for k in ("y", "w"):
        np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_allclose(got["x"], ref["x"], rtol=1e-6, atol=1e-6)


def _jnorm(t: Normalize):
    from repro.data.corpus import Normalize as JNorm
    return JNorm(scale=t.scale, mean=t.mean, std=t.std)


def test_save_open_memory_maps(tiny, tmp_path):
    data = tiny[1]
    src = HostCorpus(dict(data), transform=NORM, device="cpu")
    mapped = HostCorpus.open(src.save(str(tmp_path / "corpus")),
                             device="cpu")
    assert mapped.transform == NORM
    assert mapped.memory_report()["host_is_mmap"]
    assert isinstance(mapped["x"], np.memmap)
    np.testing.assert_array_equal(mapped.sizes(), src.sizes())
    np.testing.assert_array_equal(mapped.label_entropy(),
                                  src.label_entropy())
    idx = np.asarray([1, 4, 2])
    _assert_same_cohort(mapped.cohort(idx), src.cohort(idx))
    mapped.prefetch(idx)
    _assert_same_cohort(mapped.cohort(idx), src.cohort(idx))
    # the reference opens the same layout
    from repro.data.stream import HostCorpus as JHost
    ref = JHost.open(str(tmp_path / "corpus"))
    assert ref.transform.mean == NORM.mean
    np.testing.assert_array_equal(ref.sizes(), mapped.sizes())


def test_signature_keys_the_plane(tiny):
    from repro_torch.fl.runtime import make_client_mesh
    data = tiny[1]
    dense = ClientCorpus(dict(data), device="cpu")
    host = HostCorpus(dict(data), device="cpu")
    before = host.nbytes
    assert host.signature() != dense.signature()
    assert host.signature()[0] == "stream"
    assert as_data_plane(host, "resident", device="cpu").signature() \
        == dense.signature()
    assert plane_of(host) == "streaming" and plane_of(dense) == "resident"
    assert plane_of(dict(data)) == "resident"
    mesh = make_client_mesh(["cpu"] * 3)
    for corpus in (host, dense):
        assert corpus.mesh is None
        assert corpus.shard(mesh) is corpus and corpus.mesh == mesh
    # the host corpus records the mesh and never moves; the resident one
    # pads 8 clients to 9 on it, and its signature keys the pad
    assert host.signature()[0] == "stream" and host.nbytes == before
    assert dense.padded_num_clients == 9 and dense.signature()[2] == 1


def test_as_data_plane_modes(tiny):
    from repro.data.stream import as_data_plane as j_as_data_plane
    data = dict(tiny[1])
    nbytes = sum(v.nbytes for v in data.values())
    assert RESIDENT_BUDGET_BYTES == 1 << 30
    assert isinstance(as_data_plane(data, device="cpu"), ClientCorpus)
    assert isinstance(as_data_plane(data, "streaming", device="cpu"),
                      HostCorpus)
    host = HostCorpus(data, device="cpu")
    dense = ClientCorpus(data, device="cpu")
    assert as_data_plane(host, device="cpu") is host
    assert as_data_plane(dense, device="cpu") is dense
    assert isinstance(as_data_plane(host, "resident", device="cpu"),
                      ClientCorpus)
    assert isinstance(as_data_plane(dense, "streaming", device="cpu"),
                      HostCorpus)
    # "auto" streams past the budget exactly where the reference does
    for budget in (nbytes - 1, nbytes, nbytes + 1, 16):
        got = as_data_plane(data, resident_budget=budget, device="cpu")
        want = j_as_data_plane(data, resident_budget=budget)
        assert got.plane == want.plane
        assert got.plane == ("resident" if nbytes <= budget
                             else "streaming")
    with pytest.raises(ValueError, match="unknown data plane"):
        as_data_plane(data, "hybrid", device="cpu")
    with pytest.raises(ValueError, match="uploads to"):
        HostCorpus.from_stacked(HostCorpus(data, device="meta"),
                                device="cpu")


def test_memory_report_matches_reference():
    from repro.data.corpus import ClientCorpus as JCorpus
    from repro.data.stream import HostCorpus as JHost
    data = _uint8_corpus(np.random.default_rng(0), 64, 16, 10, hw=4)
    pairs = [(ClientCorpus(dict(data), device="cpu"),
              JCorpus(dict(data))),
             (HostCorpus(dict(data), device="cpu"), JHost(dict(data)))]
    for port, ref in pairs:
        assert port.memory_report() == ref.memory_report()
        assert port.cohort_nbytes(8) == ref.cohort_nbytes(8)
    host, ref = pairs[1]
    for corpus in (host, ref):
        corpus.cohort(np.arange(8))
        corpus.prefetch(np.arange(8, 16))
        corpus.cohort(np.arange(8, 16))
    assert host.memory_report() == ref.memory_report()
    rep = host.memory_report()
    assert rep["device_resident_bytes"] == host.cohort_nbytes(8) \
        == 8 * 16 * (48 + 4 + 4)
    assert rep["device_resident_bytes"] * 8 == host.nbytes


# ------------------------------------------------------------ prefetcher

def _replay(corpus, calls, settle: bool = False):
    """Apply ``calls`` to a corpus of either package; return the stats
    after each call (without the timings) and the cohorts taken.

    With ``settle``, each ``prefetch`` first waits until every staging
    thread started before it has finished. The reference's prefetcher
    needs it: its ring of ``depth + 1`` buffers hands a buffer out again
    while the thread of an evicted or cancelled stage may still be
    writing it, and ``np.take(..., out=buf)`` marks ``buf`` read-only
    while it writes through a copy, so a second thread's take into the
    same buffer then raises "WRITEBACKIFCOPY base is read-only". The
    counts depend only on the order of the calls, so the wait leaves
    them as they are."""
    out, cohorts, started = [], [], []
    for op, *args in calls:
        if op == "prefetch":
            if settle:
                for done in started:
                    done.wait()
            corpus.prefetch(*args)
            if settle:
                started.append(corpus.prefetcher()._pending[-1][1])
        elif op == "cohort":
            cohorts.append(_np(corpus.cohort(*args)))
        else:
            corpus.cancel_prefetch()
        s = corpus.prefetch_stats()
        out.append({k: s[k] for k in ("hits", "misses", "cancelled",
                                      "hit_rate")})
    return out, cohorts


a, b, c = (np.asarray([0, 1]), np.asarray([2, 3]), np.asarray([4, 5]))
_DEPTH1 = [("cohort", a), ("prefetch", a), ("cohort", a),
           ("prefetch", b), ("cohort", a),                  # miss
           ("prefetch", a, np.asarray([1, 2])),
           ("cohort", a, np.asarray([2, 1])),               # key: queue
           ("prefetch", a), ("cancel",), ("cohort", a),
           ("prefetch", a), ("prefetch", b), ("cohort", b)]  # overwrite
_DEPTH2 = [("prefetch", a), ("prefetch", b), ("cohort", a), ("cohort", b),
           ("prefetch", a), ("prefetch", b), ("prefetch", c),  # evicts a
           ("cohort", c),                                      # b stale
           ("prefetch", a), ("prefetch", b), ("cancel",),
           ("prefetch", c), ("prefetch", a), ("cohort", a)]


@pytest.mark.parametrize("depth,calls", [(1, _DEPTH1), (2, _DEPTH2)],
                         ids=["depth1", "depth2"])
def test_prefetcher_counts_equal_reference(tiny, depth, calls):
    from repro.data.stream import HostCorpus as JHost
    data = tiny[1]
    port = HostCorpus(dict(data), prefetch_depth=depth, device="cpu")
    ref = JHost(dict(data), prefetch_depth=depth)
    got, got_cohorts = _replay(port, calls)
    want, want_cohorts = _replay(ref, calls, settle=True)
    assert got == want
    for g, w in zip(got_cohorts, want_cohorts, strict=True):
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
    assert port.prefetcher().depth == depth
    # the ring stays at depth + 1 buffers under sustained traffic
    for _ in range(3):
        for i in (a, b):
            port.prefetch(i)
        port.cohort(a)
        port.cohort(b)
    nb = port.prefetcher().staging_nbytes
    for _ in range(3):
        for i in (a, b):
            port.prefetch(i)
        port.cohort(a)
        port.cohort(b)
    assert port.prefetcher().staging_nbytes == nb
    assert sum(x is not None for x in port.prefetcher()._buffers) \
        <= depth + 1
    with pytest.raises(ValueError, match="depth"):
        HostCorpus(dict(data), prefetch_depth=0, device="cpu")


def test_prefetch_worker_error_raises_on_take(tiny):
    host = HostCorpus(dict(tiny[1]), device="cpu")
    host.prefetch(np.asarray([0, 1]))
    host.cohort(np.asarray([0, 1]))
    bad = np.asarray([0, 10 ** 6])
    host.prefetch(bad)
    with pytest.raises(IndexError):
        host.cohort(bad)
    # negative ids follow numpy's rule on both routes
    host.prefetch(np.asarray([-1, 2]))
    _assert_same_cohort(host.cohort(np.asarray([-1, 2])),
                        host.cohort(np.asarray([7, 2])))


# ------------------------------------------- engines on the streaming plane

class _WrongSpeculation(tfl.MaxEntropyJudge):
    """The oracle is the real maxent; the traced form admits everyone, so
    every round that rejects a device misses."""

    def traced(self, backend=None):
        return tfl.PassThroughJudge().traced()


def _wrong_reference_judge():
    import repro.fl as rfl

    class Wrong(rfl.MaxEntropyJudge):
        def traced(self):
            return rfl.PassThroughJudge().traced()
    return Wrong()


STRAGGLER = dict(clock="straggler", latency_scale=1.0, staleness_alpha=0.5)

# case: (composition, port kwargs, reference kwargs, rounds); built lazily
_CASES = ["server", "pipelined-off", "pipelined-on", "forced-miss", "queue",
          "drift", "async"]


def _case_kwargs(case, split, data, reference: bool):
    if reference:
        from repro.fl.runtime import AsyncConfig as RAsync
        from repro.fl.runtime import RuntimeConfig as RRuntime
        runtime_cls, async_cls = RRuntime, RAsync
    else:
        runtime_cls, async_cls = RuntimeConfig, AsyncConfig
    name, kw, rounds = "fedentropy", {}, ROUNDS
    if case == "pipelined-off":
        kw["engine"] = "pipelined"
    elif case == "pipelined-on":
        kw["runtime"] = (runtime_cls(speculate=True, spec_backend="xla")
                         if reference else runtime_cls(speculate=True))
    elif case == "forced-miss":
        kw["runtime"] = runtime_cls(speculate=True)
        kw["judge"] = (_wrong_reference_judge() if reference
                       else _WrongSpeculation())
    elif case == "queue":
        name = "fedentropy+queue"
        kw["runtime"] = (runtime_cls(speculate=True, spec_backend="xla")
                         if reference else runtime_cls(speculate=True))
    elif case == "drift":
        xtr, ytr = split
        kw["drift"] = drift_schedule(
            xtr, ytr, 8, 4, at=2, samples_per_client=int(data["y"].shape[1]))
        kw["runtime"] = (runtime_cls(speculate=True, spec_backend="xla")
                         if reference else runtime_cls(speculate=True))
        rounds = 4
    elif case == "async":
        kw["runtime"] = async_cls(**STRAGGLER)
    return name, kw, rounds


def _port_run(tiny, case, plane, device="cpu"):
    split, data, params, _ = tiny
    name, kw, rounds = _case_kwargs(case, split, data, reference=False)
    server = tfl.build(name, tcnn.apply, params, dict(data),
                       tfl.ServerConfig(num_clients=8, participation=0.5),
                       tfl.LocalSpec(epochs=1, batch_size=20),
                       data_plane=plane, device=device, **kw)
    for _ in range(rounds):
        server.round()
    return server


def _digest(params) -> float:
    return float(sum(x.double().abs().sum()
                     for x in pytree.tree_leaves(params)))


def _assert_equal(a, b) -> None:
    """Records equal to the bit and params equal bit for bit."""
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        assert set(x) == set(y)
        for key in x:
            if key == "entropy" and np.isnan(x[key]):
                assert np.isnan(y[key])
            else:
                assert x[key] == y[key], (x["round"], key)
    for p, q in zip(pytree.tree_leaves(a.global_params),
                    pytree.tree_leaves(b.global_params), strict=True):
        assert torch.equal(p, q)


@pytest.mark.parametrize("case", _CASES)
def test_streaming_plane_equals_resident_and_reference(tiny, case):
    import jax
    import repro.fl as rfl
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.data.stream import HostCorpus as JHost
    from repro.models import cnn as jcnn
    stream = _port_run(tiny, case, "streaming")
    assert isinstance(stream.corpus, HostCorpus)
    _assert_equal(stream, _port_run(tiny, case, "resident"))

    split, data, _, jparams = tiny
    name, kw, rounds = _case_kwargs(case, split, data, reference=True)
    ref = rfl.build(name, jcnn.apply, jparams, dict(data),
                    rfl.ServerConfig(num_clients=8, participation=0.5),
                    JLocalSpec(epochs=1, batch_size=20),
                    data_plane="streaming", **kw)
    assert isinstance(ref.corpus, JHost)
    for _ in range(rounds):
        ref.round()
    keys = {"round", "selected", "positive", "negative", "comm",
            "spec_hit", "redispatched", "staleness", "seq", "drift"}
    for want, got in zip(ref.history, stream.history, strict=True):
        assert set(got) == set(want)
        for key in keys & set(want):
            assert got[key] == want[key], (want["round"], key)
        if np.isnan(want["entropy"]):
            assert np.isnan(got["entropy"])
        else:
            assert got["entropy"] == pytest.approx(want["entropy"],
                                                   abs=ENT_ATOL)
    digest = float(sum(np.abs(np.asarray(x)).sum(dtype=np.float64)
                       for x in jax.tree.leaves(ref.global_params)))
    assert _digest(stream.global_params) == pytest.approx(digest,
                                                          rel=DIGEST_RTOL)
    # the prefetcher's counts are the reference's: each confirmed
    # speculation is a prefetch hit, each miss a cancel
    got, want = stream.corpus.prefetch_stats(), ref.corpus.prefetch_stats()
    assert {k: got[k] for k in ("hits", "misses", "cancelled")} == \
        {k: want[k] for k in ("hits", "misses", "cancelled")}
    spec = [r for r in stream.history if "spec_hit" in r]
    if case in ("pipelined-on", "queue"):
        assert got["hits"] == sum(r["spec_hit"] for r in spec) > 0
    if case == "forced-miss":
        assert got["cancelled"] == sum(not r["spec_hit"] for r in spec) > 0
    if case in ("server", "pipelined-off", "async"):
        assert got["hits"] == got["cancelled"] == 0
    if case == "drift":
        # the drifted corpus is rebuilt on the streaming plane
        assert isinstance(stream.corpus, HostCorpus)
        assert not np.array_equal(stream.corpus["y"], data["y"])


@pytest.mark.parametrize("speculate", [False, True])
def test_clustered_rounds_on_the_streaming_plane(tiny, speculate):
    """``ifca+maxent`` at K = 2 (the IFCA losses gather the cohort too;
    the clustered dispatch stays eager, no prefetch) equals the resident
    plane bit for bit."""
    _, data, params, _ = tiny
    runs = []
    for plane in ("streaming", "resident"):
        server = tfl.build(
            "ifca+maxent", tcnn.apply, params, dict(data),
            tfl.ServerConfig(num_clients=8, participation=0.5,
                             num_clusters=2),
            tfl.LocalSpec(epochs=1, batch_size=20), data_plane=plane,
            runtime=RuntimeConfig(speculate=speculate), device="cpu")
        for _ in range(ROUNDS):
            server.round()
        runs.append(server)
    _assert_equal(*runs)
    assert runs[0].corpus.prefetch_stats()["hits"] == 0


def test_drift_copies_only_rewritten_arrays(tiny, tmp_path):
    (xtr, ytr), data, _, _ = tiny
    mapped = HostCorpus.open(
        HostCorpus(dict(data), device="cpu").save(str(tmp_path / "c")),
        device="cpu")
    ev = drift_schedule(xtr, ytr, 8, 4, at=1,
                        samples_per_client=int(data["y"].shape[1]))[0]
    rows = {k: v for k, v in ev.data.items() if k != "x"}
    new = mapped.with_rows(ev.clients, rows)
    assert new["x"] is mapped["x"]               # shared, still mapped
    assert not isinstance(new["y"], np.memmap)
    dense = ClientCorpus(dict(data), device="cpu").with_rows(ev.clients,
                                                             rows)
    for k in ("y", "w"):
        np.testing.assert_array_equal(new[k], dense[k].numpy())
    np.testing.assert_array_equal(new.label_entropy(), dense.label_entropy())
    np.testing.assert_array_equal(np.asarray(mapped["y"]), data["y"])


def test_scan_server_on_host_corpus_falls_back_like_reference(tiny):
    import repro.fl as rfl
    from repro.core.strategies import LocalSpec as JLocalSpec
    from repro.fl.runtime import ScanConfig as JScanConfig
    from repro.models import cnn as jcnn
    _, data, params, jparams = tiny
    ref = rfl.build("fedentropy-traced", jcnn.apply, jparams, dict(data),
                    rfl.ServerConfig(num_clients=8, participation=0.5),
                    JLocalSpec(epochs=1, batch_size=20), engine="scan",
                    runtime=JScanConfig(rounds_per_scan=4),
                    data_plane="streaming")
    port = tfl.build("fedentropy-traced", tcnn.apply, params, dict(data),
                     tfl.ServerConfig(num_clients=8, participation=0.5),
                     tfl.LocalSpec(epochs=1, batch_size=20), engine="scan",
                     runtime=ScanConfig(rounds_per_scan=4),
                     data_plane="streaming", device="cpu")
    assert ref.scan_rounds() == port.scan_rounds() == 1
    want = [(r["code"], r["component"]) for r in ref.fallback_reasons]
    got = [(r["code"], r["component"]) for r in port.fallback_reasons]
    assert got == want == [("host-data-plane", "HostCorpus")]
    rec, want_rec = port.round(), ref.round()
    assert rec["scan_fallback"] == want_rec["scan_fallback"] \
        == ["host-data-plane"]
    for key in ("selected", "positive", "negative", "comm"):
        assert rec[key] == want_rec[key]
    assert port.block_ys_shapes(1)["soft"].shape == (1, 4, 4)


# ------------------------------------------------------- caches, threads

def _threads(target, n):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=target, args=(t,))
                   for t in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)


def test_bounded_graph_cache_thread_safe():
    """Concurrent gets of one key build exactly once; distinct keys never
    corrupt the LRU (servers on several threads share the process cache)."""
    cache = BoundedGraphCache(maxsize=64)
    built, errors = [], []
    barrier = threading.Barrier(8, timeout=60)

    def work(tid):
        try:
            barrier.wait()
            for i in range(200):
                def make(i=i):
                    time.sleep(1e-4)             # a build takes a while
                    built.append(i % 10)
                    return i % 10
                assert cache.get(("shared", i % 10), make) == i % 10
        except Exception as e:  # recorded, asserted below
            errors.append(e)

    _threads(work, 8)
    assert not errors
    assert sorted(built) == list(range(10))     # one build per key
    assert len(cache) == 10 and cache.captures == 10


def test_process_cache_counts_under_threads():
    cache = enable_process_cache(maxsize=32)
    try:
        _threads(lambda t: [cache.get(("k", i % 4), lambda: object())
                            for i in range(100)], 4)
        s = cache.stats()
        assert s["hits"] + s["misses"] == 400
        assert s["misses"] == 4 == s["entries"]  # one build per key
    finally:
        disable_process_cache()


# ------------------------------------------------------------- card only

def _card_corpus(n=48, s=64, hw=32, seed=0):
    """uint8 CIFAR-shaped clients, big enough that a cohort's copy is
    still running when the next call comes."""
    return _uint8_corpus(np.random.default_rng(seed), n, s, 10, hw=hw)


def test_card_pinned_staging(cuda):
    data = _card_corpus()
    host = HostCorpus(dict(data), transform=NORM, device=cuda)
    dense = ClientCorpus(dict(data), transform=NORM, device=cuda)
    idx = np.asarray([3, 40, 7, 7, 0])
    act = np.asarray([1, 64, 30, 5, 64])
    for active in (None, act):
        host.prefetch(idx, active)
        got = host.cohort(idx, active=active)
        assert all(t.is_cuda for t in got.values())
        _assert_same_cohort(got, dense.cohort(idx, active=active))
        _assert_same_cohort(host.cohort(idx, active=active), got)  # sync
    buffers = [b for b in host.prefetcher()._buffers if b is not None]
    assert buffers and all(t.is_pinned() for b in buffers
                           for t in b.values())
    assert host.prefetch_stats()["hits"] == 2
    rep = host.memory_report()
    assert rep["staging_nbytes"] == sum(
        t.numel() * t.element_size() for b in buffers for t in b.values())


def test_card_depth2_ring_back_to_back(cuda):
    """Back-to-back starts on a depth-2 ring: every slot is rewritten
    only after its last copy ended, so each taken cohort equals the
    resident gather of its ids, also when the side stream is held back
    so that a slot comes round again while its copy still waits."""
    data = _card_corpus(n=64, s=128)
    host = HostCorpus(dict(data), prefetch_depth=2, device=cuda)
    dense = ClientCorpus(dict(data), device=cuda)
    rng = np.random.default_rng(0)
    for _ in range(20):
        ids = [rng.choice(64, 16, replace=False) for _ in range(3)]
        for i in ids:
            host.prefetch(i)                 # the third evicts the first
        for i in ids[1:]:
            got = host.cohort(i)
            x = got["x"].float().sum()       # consumer work on the stream
            _assert_same_cohort(got, dense.cohort(i))
            assert float(x) == float(dense.cohort(i)["x"].float().sum())
    stats = host.prefetch_stats()
    assert stats["hits"] == 40 and stats["cancelled"] == 20
    assert stats["misses"] == 0
    # hold the copies back (about 0.1 s) and take four cohorts in turn:
    # the fourth start writes the first's ring slot while the first's
    # copy still waits behind the hold
    with torch.cuda.stream(host.prefetcher()._stream):
        torch.cuda._sleep(200_000_000)
    ids = [rng.choice(64, 16, replace=False) for _ in range(4)]
    taken = []
    for i in ids:
        host.prefetch(i)
        taken.append(host.cohort(i))
    for i, got in zip(ids, taken):
        _assert_same_cohort(got, dense.cohort(i))


def test_card_capture_while_prefetch_in_flight(cuda):
    """A prefetch started inside a capture: its worker's CUDA calls wait
    for the capture's end (the capture lock); the capture and the staged
    cohort are both right."""
    from repro_torch.fl import graph_cache
    data = _card_corpus()
    host = HostCorpus(dict(data), device=cuda)
    dense = ClientCorpus(dict(data), device=cuda)
    idx = np.asarray([5, 6, 7, 8])
    host.prefetcher()                        # made before the capture
    calls = []

    def fn(x):
        calls.append(time.perf_counter())
        if len(calls) == graph_cache.WARMUP_RUNS + 1:   # the capture
            host.prefetch(idx)
            time.sleep(0.1)
        return x * 2 + 1

    x = torch.arange(1024, dtype=torch.float32, device=cuda)
    prog = CapturedProgram(fn, (x,))
    held = time.perf_counter() - calls[-1]
    got = host.cohort(idx)
    _assert_same_cohort(got, dense.cohort(idx))
    stats = host.prefetch_stats()
    assert stats["hits"] == 1
    # the worker's copy waited through the rest of the capture
    assert stats["stage_s"] >= 0.09 and held >= 0.09
    y = torch.randn(1024, device=cuda)
    assert torch.equal(prog(y), y * 2 + 1)


def test_card_pipelined_streaming_under_capture(cuda, tiny_card):
    """The pipelined engine on the streaming plane under capture equals
    the sequential server on either plane bit for bit, with speculation
    hits taken as prefetch hits and a forced miss cancelling."""
    for case in ("pipelined-on", "forced-miss"):
        seq = _port_run(tiny_card, "server", "streaming", device=cuda)
        res = _port_run(tiny_card, "server", "resident", device=cuda)
        pip = _port_run(tiny_card, case, "streaming", device=cuda)
        assert pip.graphs_captured == 1
        for a, b in ((seq, res), (seq, pip)):
            assert len(a.history) == len(b.history)
            for x, y in zip(a.history, b.history):
                for key in x:
                    assert x[key] == y[key] or (
                        key == "entropy" and np.isnan(x[key])
                        and np.isnan(y[key])), (x["round"], key)
            for p, q in zip(pytree.tree_leaves(a.global_params),
                            pytree.tree_leaves(b.global_params),
                            strict=True):
                assert torch.equal(p, q)
        stats = pip.corpus.prefetch_stats()
        hits = sum(r["spec_hit"] for r in pip.history)
        misses = sum(not r["spec_hit"] for r in pip.history)
        if case == "forced-miss":
            assert misses and stats["cancelled"] == misses
        else:
            assert stats["hits"] == hits > 0
