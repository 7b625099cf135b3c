"""The captured client program (``repro_torch.fl.graph_cache``).

On a CUDA card the server captures the vmapped client program into a CUDA
graph the first round a key is seen and replays it after; the captured
route must equal the eager route (``disable_capture()``) bit for bit. The
``test_card_*`` cases need a card and skip without one; they import
nothing of JAX, so they run where JAX is not installed::

    PYTHONPATH=src python -m pytest -q tests/test_torch_capture.py

The LRU itself is plain Python and is checked here on the CPU too.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import os
import subprocess
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import repro_torch.fl as fl
from repro_torch.data.partition import partition, stack_clients
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.core.simulator import FedEntropyTrainer, FLConfig
from repro_torch.fl.graph_cache import BoundedGraphCache, CapturedProgram
from repro_torch.kernels.entropy_judge import (entropy_judge_loop,
                                               entropy_judge_sweep)
from repro_torch.kernels.fused_aggregate import masked_weighted_sum
from repro_torch.models import cnn

ROUNDS = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs have no CPU mode")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def tiny():
    """tests/test_fl_api.py's fixture (8 clients, 4 classes, 16x16)."""
    (xtr, ytr), _ = make_image_dataset(
        num_classes=4, train_per_class=60, test_per_class=15, hw=16,
        noise=0.4, seed=0)
    parts = partition("case1", ytr, 8, 4, seed=0)
    data = stack_clients(xtr, ytr, parts, batch_multiple=20)
    params = cnn.init(torch.Generator().manual_seed(0), image_hw=16,
                      num_classes=4)
    return data, params


def _server(tiny, name, cache_size=4):
    data, params = tiny
    strategy = fl.get("composition", name).strategy
    return fl.build(name, cnn.apply, params, data,
                    fl.ServerConfig(num_clients=8, participation=0.5,
                                    jit_cache_size=cache_size),
                    fl.LocalSpec(strategy, epochs=1, batch_size=20),
                    device="cuda")


def _equal_trees(a, b) -> bool:
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    return len(la) == len(lb) and all(
        x is y if x is None or y is None else torch.equal(x, y)
        for x, y in zip(la, lb))


# ------------------------------------------------------------------- CPU

def test_bounded_graph_cache_evicts_lru():
    cache = BoundedGraphCache(2)
    makes = []
    for key in ("a", "b", "a", "c", "b"):
        assert cache.get(key, lambda k=key: makes.append(k) or k) == key
    # "a" was refreshed before "c" evicted "b"; re-getting "b" rebuilds
    assert makes == ["a", "b", "c", "b"]
    assert len(cache) == 2 and cache.captures == 4


def test_bounded_graph_cache_keeps_nothing_of_a_failed_build():
    cache = BoundedGraphCache(0)           # bounded to at least one entry
    assert cache.maxsize == 1

    def fail():
        raise RuntimeError("capture failed")

    with pytest.raises(RuntimeError, match="capture failed"):
        cache.get("a", fail)
    assert len(cache) == 0 and cache.captures == 0
    assert cache.get("a", lambda: 1) == 1


def test_bounded_graph_cache_clear_drops_every_entry():
    cache = BoundedGraphCache(2)
    for key in ("a", "b"):
        cache.get(key, lambda k=key: k)
    cache.clear()
    assert len(cache) == 0 and cache.captures == 2
    made = []
    assert cache.get("a", lambda: made.append(1) or "a") == "a"
    assert made == [1] and cache.captures == 3


# ------------------------------------------------------------- card only

@pytest.mark.parametrize("name", ["fedentropy", "moon", "scaffold"])
def test_card_captured_route_equals_eager(cuda, tiny, name):
    captured, eager = _server(tiny, name), _server(tiny, name)
    for _ in range(ROUNDS):
        got = captured.round()
        with fl.disable_capture():
            want = eager.round()
        for key in ("selected", "positive", "negative", "comm"):
            assert got[key] == want[key]
        np.testing.assert_array_equal(got["entropy"], want["entropy"])
    assert _equal_trees(captured.global_params, eager.global_params)
    assert _equal_trees(captured.state, eager.state)
    assert captured.graphs_captured == 1 and len(captured._graphs) == 1
    assert eager.graphs_captured == 0


def test_card_drop_graphs_recaptures(cuda, tiny):
    server = _server(tiny, "fedentropy")
    server.round()
    server.drop_graphs()
    assert len(server._graphs) == 0
    server.round()
    assert server.graphs_captured == 2 and len(server._graphs) == 1


def test_card_one_graph_per_key_and_the_lru_bound(cuda, tiny):
    server = _server(tiny, "fedentropy", cache_size=1)
    for _ in range(3):
        server.round()
    assert server.graphs_captured == 1
    four = server.config
    server.config = replace(four, participation=0.25)   # cohort of 2: a key
    server.round()
    assert server.graphs_captured == 2 and len(server._graphs) == 1
    server.config = four                # evicted: captured again
    server.round()
    assert server.graphs_captured == 3 and len(server._graphs) == 1


def test_card_captured_program_replays_new_inputs(cuda):
    x = torch.arange(6.0, device=cuda)
    prog = CapturedProgram(lambda t, s: {"y": t * 2 + s["b"]},
                           (x, {"b": torch.ones(6, device=cuda)}))
    for k in range(3):
        out = prog(x + k, {"b": torch.full((6,), float(k), device=cuda)})
        assert torch.equal(out["y"], (x + k) * 2 + k)
    with pytest.raises(ValueError, match="does not fit"):
        prog(torch.zeros(5, device=cuda), {"b": torch.ones(6, device=cuda)})
    with pytest.raises(ValueError, match="structure"):
        prog(x, {"c": torch.ones(6, device=cuda)})


def test_card_failed_capture_raises(cuda):
    """A program that reads the device from the host cannot be captured;
    the capture raises and nothing runs it eagerly instead."""
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        CapturedProgram(lambda t: t * float(t.sum()), (x,))
    torch.cuda.synchronize()


_DEAD_GRAPH = """
import gc
import torch
from repro_torch.fl.graph_cache import CapturedProgram


class Cycle:
    def __init__(self):
        self.me = self


def dead_graph():
    # a captured graph that only a reference cycle holds
    c = Cycle()
    c.x = torch.ones(1024, device="cuda")
    c.graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(c.graph):
        c.y = c.x * 2


def program(x):
    # the warm-up leaves a dead graph; inside the capture a collection
    # falls where the collector is on, as an automatic one could
    if not torch.cuda.is_current_stream_capturing():
        dead_graph()
    elif gc.isenabled():
        gc.collect()
    return (x + 1) * 2


x = torch.ones(1024, device="cuda")
captured = CapturedProgram(program, (x,))
assert torch.equal(captured(x), torch.full_like(x, 4.0))
print("program captured", flush=True)
gc.disable()
dead_graph()
try:
    with torch.cuda.graph(torch.cuda.CUDAGraph()):
        y = x + 1
        gc.collect()
    print("plain capture captured")
except Exception as e:
    print("plain capture failed:", type(e).__name__, str(e).splitlines()[0])
"""


def test_card_capture_survives_collecting_a_dead_graph(cuda):
    """A collection inside a capture that destroys a dead cycle's captured
    graph invalidates the capture (a plain ``torch.cuda.graph``, which
    collects before a capture only under ``torch.compiler.config.
    force_cudagraph_gc``, False by default). ``CapturedProgram`` holds
    the collector off during its capture, so a program whose warm-up
    leaves such garbage still captures. Run in a child process: the
    failed capture is the point of the second half. Should the plain
    capture ever survive, ``CapturedProgram`` need not hold the collector
    off."""
    out = subprocess.run([sys.executable, "-c", _DEAD_GRAPH],
                         capture_output=True, text=True, timeout=300,
                         env=os.environ.copy())
    assert "plain capture failed" in out.stdout, out.stdout + out.stderr
    assert "program captured" in out.stdout, out.stdout + out.stderr


@pytest.mark.parametrize("strategy,use_judgment,use_pools", [
    ("fedavg", True, True), ("fedavg", False, False),
    ("scaffold", True, True), ("moon", True, False)])
def test_card_shim_runs_the_kernels(cuda, tiny, strategy, use_judgment,
                                    use_pools):
    """On the card the shim judges in K1's loop (one launch a round, the
    sweep never) and, except for scaffold, averages in K2."""
    data, params = tiny
    tr = FedEntropyTrainer(
        cnn.apply, params, data,
        FLConfig(num_clients=8, participation=0.5,
                 use_judgment=use_judgment, use_pools=use_pools, seed=0),
        fl.LocalSpec(strategy=strategy, epochs=1, batch_size=20),
        device="cuda")
    for fn in (entropy_judge_loop, entropy_judge_sweep, masked_weighted_sum):
        fn.launches = 0
    for _ in range(ROUNDS):
        tr.round()
    assert entropy_judge_loop.launches == (ROUNDS if use_judgment else 0)
    assert entropy_judge_sweep.launches == 0
    assert masked_weighted_sum.launches == (
        0 if strategy == "scaffold" else ROUNDS)
    assert all(bool(torch.isfinite(t).all())
               for t in pytree.tree_leaves(tr.global_params))
