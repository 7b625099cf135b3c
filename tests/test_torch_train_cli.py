"""``python -m repro_torch.launch.train`` on the CPU: every engine runs,
the token corpus and its client windows equal the reference's bit for
bit, every refusal of the reference's ``main`` is the port's too, and
the cuda route of the attention and SSD kernels (K3, K4, K5) refuses
autograd.

The ``test_card_*`` case needs a card and skips without one::

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_cli.py -k card
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_chunked
from repro_torch.launch import train
from repro_torch.models.api import build_model

ROOT = Path(__file__).resolve().parents[1]
_BASE = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "2", "--clients",
         "2", "--logical-clients", "4", "--seq-len", "16",
         "--samples-per-client", "2"]
ENGINE_ARGS = {
    "mesh": [],
    "sequential": ["--engine", "sequential"],
    "pipelined": ["--engine", "pipelined", "--speculate",
                  "--judge-backend", "cuda"],
    "async": ["--engine", "async", "--lm-objective", "window"],
    "scan": ["--engine", "scan", "--selector", "pools-traced",
             "--rounds-per-scan", "2", "--lm-objective", "window"],
}
# every SystemExit of the reference's main (and the port's --mesh)
REFUSALS = {
    "async+speculate": ["--engine", "async", "--speculate"],
    "scan+speculate": ["--engine", "scan", "--speculate"],
    "method+selector": ["--engine", "sequential", "--method", "fedcat",
                        "--selector", "uniform"],
    "method+judge": ["--engine", "sequential", "--method", "fedcat",
                     "--judge", "none"],
    "window+method": ["--engine", "sequential", "--method", "fedcat",
                      "--lm-objective", "window"],
    "clusters+window": ["--engine", "sequential", "--num-clusters", "2",
                        "--lm-objective", "window"],
    "mesh+data-plane": ["--data-plane", "resident"],
    "mesh+dryrun": ["--dryrun"],
    "mesh+queue": ["--selector", "queue"],
    "mesh+method": ["--method", "fedcat"],
    "mesh+clusters": ["--num-clusters", "2"],
    "mesh+drift": ["--drift-at", "1"],
}


@pytest.fixture(scope="module")
def jtrain():
    pytest.importorskip("jax")
    from repro.launch import train as jtrain
    return jtrain


@pytest.mark.parametrize("engine", list(ENGINE_ARGS))
def test_every_engine_runs_on_the_cpu(engine):
    records = train.main(_BASE + ENGINE_ARGS[engine] + ["--device", "cpu"])
    assert len(records) == 2
    for rec in records:
        assert set(rec["positive"]) | set(rec["negative"]) == \
            set(rec["selected"])
        assert np.isfinite(rec["entropy"])
    if engine == "mesh":
        assert all(np.isfinite(r["loss"]) and r["num_positive"] >= 1
                   for r in records)


@pytest.mark.parametrize("engine", ["sequential", "pipelined"])
def test_judge_backend_leaves_the_composition_aggregator(monkeypatch,
                                                         engine):
    """``--judge-backend`` picks the device judge only, as the
    reference's flag does: the server engines build with no aggregator of
    the CLI's, so each takes its composition's, on either backend."""
    built = []
    build = train.fl.build

    def recording(*args, **kw):
        server = build(*args, **kw)
        built.append((kw.get("aggregator"), server.aggregator))
        return server
    monkeypatch.setattr(train.fl, "build", recording)
    extra = ["--speculate"] if engine == "pipelined" else []
    for backend in ("torch", "cuda"):
        train.main(_BASE + ["--engine", engine, "--judge-backend", backend,
                            "--device", "cpu"] + extra)
    (given_t, agg_t), (given_c, agg_c) = built
    assert given_t is None and given_c is None
    assert type(agg_c) is type(agg_t)
    assert not isinstance(agg_c, train.fl.FusedAverageAggregator)


def test_cli_module_runs_and_the_default_device_is_the_card():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *_BASE,
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step    1 loss=" in out.stdout and "done: 2 rounds" in out.stdout
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train.main(_BASE)


@pytest.mark.parametrize("case", ["case1", "case2", "case3"])
def test_corpus_and_windows_equal_reference(jtrain, case):
    cfg = ARCHS["qwen3-0.6b"].reduced()
    x, idx = train.build_fl_corpus(cfg, 6, case, 20, seed=3)
    jx, jidx = jtrain.build_fl_corpus(cfg, 6, case, 20, seed=3)
    np.testing.assert_array_equal(x, jx)
    assert len(idx) == len(jidx) == 6
    for a, b in zip(idx, jidx):
        np.testing.assert_array_equal(a, b)
    got = train.stack_lm_clients(x, idx, 5, 20, seed=4)
    want = jtrain.stack_lm_clients(jx, jidx, 5, 20, seed=4)
    for k in ("x", "y", "w"):
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    assert got["x"].shape == (6, 5, 21)


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_match_reference(jtrain, monkeypatch, name):
    argv = _BASE + REFUSALS[name]
    monkeypatch.setattr(sys, "argv", ["train"] + argv)
    with pytest.raises(SystemExit) as ref_exit:
        jtrain.main()
    with pytest.raises(SystemExit) as port_exit:
        train.main(argv + ["--device", "cpu"])
    assert isinstance(ref_exit.value.code, str)
    assert isinstance(port_exit.value.code, str)
    # the same refusal: its message names the same flags
    flag = ref_exit.value.code.split()[0]
    assert port_exit.value.code.split()[0] == flag


def test_mesh_other_than_host_is_refused():
    with pytest.raises(SystemExit, match="the only mesh is host"):
        train.main(_BASE + ["--mesh", "pod", "--device", "cpu"])


# ---------------------------------------------- the cuda route's autograd

def _attn_inputs(grad: bool):
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 2, 8, generator=g) for _ in range(3))
    if grad:
        q.requires_grad_(True)
    return q, k, v


def _ssd_inputs(grad: bool):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 2, 4, generator=g, requires_grad=grad)
    dt = torch.rand(1, 8, 2, generator=g)
    a = -torch.rand(2, generator=g)
    b, c = (torch.randn(1, 8, 1, 4, generator=g) for _ in range(2))
    return x, dt, a, b, c


def test_cuda_route_refuses_autograd_through_attention_and_ssd():
    q, k, v = _attn_inputs(grad=True)
    pos = torch.arange(4, dtype=torch.int32)[None]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, k, v, backend="cuda")                    # K3
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q[:, :1], k, v, q_offset=3, kv_positions=pos,
                      backend="cuda")                             # K4
    x, dt, a, b, c = _ssd_inputs(grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(x, dt, a, b, c, chunk=4, backend="cuda")          # K5
    for fn, args in ((flash_attention, (q, k, v)),
                     (decode_attention, (q[:, :1], k, v, pos, 3)),
                     (ssd_chunked, (x, dt, a, b, c))):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(*args)
    # no grad mode, or no input that requires grad: the plain versions
    # run as before, and the torch route differentiates
    with torch.no_grad():
        ops.attention(q, k, v, backend="cuda")
        ops.ssd(x, dt, a, b, c, chunk=4, backend="cuda")
    ops.attention(*_attn_inputs(grad=False), backend="cuda")
    out = ops.attention(q, k, v, backend="torch")
    out.sum().backward()
    assert q.grad is not None and bool(q.grad.abs().sum() > 0)


def test_model_on_the_cuda_route_refuses_to_train():
    """A model built with kernels="cuda" refuses ``loss.backward()``'s
    forward; serving it (inference mode) and the torch route's training
    are unaffected."""
    cfg = ARCHS["zamba2-2.7b"].reduced()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 12)).astype(np.int32))
    model = build_model(cfg, device="cpu", kernels="cuda")
    with pytest.raises(RuntimeError, match="no backward"):
        model.loss(model.params(), {"tokens": toks})
    model.prefill({"tokens": toks})
    plain = build_model(cfg, device="cpu", kernels="torch")
    loss, _ = plain.loss(plain.params(), {"tokens": toks})
    loss.backward()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_card_cuda_route_refuses_autograd(cuda):
    q, k, v = (t.to(cuda) for t in _attn_inputs(grad=False))
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, k, v, backend="cuda")
    x, dt, a, b, c = (t.to(cuda) for t in _ssd_inputs(grad=False))
    x.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd(x, dt, a, b, c, chunk=4, backend="cuda")
