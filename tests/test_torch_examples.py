"""The four example twins (``examples/torch_*.py``) against the
reference's examples, on the CPU (``--device cpu``) at small arguments.

Each reference example is loaded from its path with ``importlib`` (the
file is not edited); its ``fl.build`` is wrapped to keep the servers it
builds, and ``ROUNDS`` is cut to 2 in both modules. Both sides start
from the same weights: the reference's seeded init, converted with
``repro_torch.convert``.

* quickstart and compare_strategies: the same corpus line, and every
  server's round records equal under the port's policy (integers exact,
  entropy within 1e-6);
* fl_llm_finetune: ``build_setup``/``build_server`` give equal data and
  equal histories over 2 rounds of a scan block of 2 (the scan engine,
  ``pools-traced``, lmstep, ``params_mode="remat"``); the twin's
  ``--verify`` holds the scan against the sequential server bit for bit;
* serve_lm: the same greedy tokens at its default arch (zamba2-2.7b
  reduced), on the ``torch`` and ``cuda`` routes (plain versions on the
  CPU).
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import importlib.util
import os
import re
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.convert import cnn_params_from_numpy, lm_params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENT_ATOL = 1e-6
INT_KEYS = ("round", "selected", "positive", "negative")


def _load(name: str):
    """The module of ``examples/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Recording:
    """A stand-in for a module's ``fl`` that keeps every server ``build``
    makes."""

    def __init__(self, fl):
        self._fl, self.built = fl, []

    def __getattr__(self, name):
        return getattr(self._fl, name)

    def build(self, *args, **kw):
        server = self._fl.build(*args, **kw)
        self.built.append(server)
        return server


@pytest.fixture(scope="module")
def jax():
    return pytest.importorskip("jax")


def _assert_records_match(got, want):
    assert len(got) == len(want) > 0
    for x, y in zip(got, want):
        for key in INT_KEYS + ("spec_hit",):
            assert x.get(key) == y.get(key), (x["round"], key)
        assert x["comm"]["total_bytes"] == y["comm"]["total_bytes"]
        if np.isnan(y["entropy"]):           # nothing judged (fedavg)
            assert np.isnan(x["entropy"])
        else:
            assert x["entropy"] == pytest.approx(y["entropy"],
                                                 abs=ENT_ATOL)


def _cnn_params(jax, hw, classes):
    from repro.models import cnn
    params = cnn.init(jax.random.PRNGKey(0), image_hw=hw,
                      num_classes=classes)
    return cnn_params_from_numpy(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("name", ["quickstart", "compare_strategies"])
def test_cnn_twin_matches_reference(jax, monkeypatch, capsys, name):
    ref, twin = _load(name), _load(f"torch_{name}")
    for mod in (ref, twin):
        monkeypatch.setattr(mod, "ROUNDS", 2)
    rec = _Recording(ref.fl)
    monkeypatch.setattr(ref, "fl", rec)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    ref.main()
    want = capsys.readouterr().out
    hw, classes = 16, 4
    servers = twin.main(["--device", "cpu"],
                        params=_cnn_params(jax, hw, classes))
    got = capsys.readouterr().out
    assert len(servers) == len(rec.built) == (2 if name == "quickstart"
                                              else 8)
    for server, ref_server in zip(servers.values(), rec.built):
        assert server.device.type == "cpu"
        _assert_records_match(server.history, ref_server.history)
    # the same lines, numbers aside (accuracies come from another conv)
    shape = re.compile(r"[-\d.]+%?")
    assert [shape.sub("#", ln) for ln in got.splitlines()] == \
        [shape.sub("#", ln) for ln in want.splitlines()]
    if name == "quickstart":
        assert got.splitlines()[0] == want.splitlines()[0]    # the corpus


def test_fl_llm_finetune_twin_matches_reference(jax):
    ref, twin = _load("fl_llm_finetune"), _load("torch_fl_llm_finetune")
    argv = ["--rounds", "2", "--rounds-per-scan", "2", "--seq-len", "16",
            "--device", "cpu"]
    args = twin.parser().parse_args(argv)
    rargs = SimpleNamespace(arch=args.arch, seq_len=args.seq_len)
    rsetup = ref.build_setup(rargs)
    cfg, model, data, config, local, _ = twin.build_setup(args)
    for k in ("x", "y", "w"):
        np.testing.assert_array_equal(data[k], np.asarray(rsetup[2][k]))
    params = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, rsetup[5]))
    model.net.load_state_dict(params)
    setup = (cfg, model, data, config, local,
             {k: v.detach() for k, v in model.params().items()})

    def runtime(fl):
        return fl.ScanConfig(rounds_per_scan=2, params_mode="remat")

    want = ref.build_server(rargs, rsetup, engine="scan",
                            runtime=runtime(ref.fl))
    got = twin.build_server(args, setup, engine="scan",
                            runtime=runtime(twin.fl))
    assert got.scan_rounds() == want.scan_rounds() == 2
    for _ in range(2):
        want.round(), got.round()
    _assert_records_match(got.history, want.history)
    assert got.stats()["blocks"] == want.stats()["blocks"] == 1
    server = twin.main(argv + ["--verify"])         # scan == sequential
    assert len(server.history) == 2


@pytest.mark.parametrize("kernels", ["torch", "cuda"])
def test_serve_lm_twin_matches_reference(jax, monkeypatch, capsys,
                                         kernels):
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models.api import build_model as jbuild
    ref, twin = _load("serve_lm"), _load("torch_serve_lm")
    monkeypatch.setattr(sys, "argv", ["serve_lm.py"])
    ref.main()
    want = capsys.readouterr().out.splitlines()
    arch = "zamba2-2.7b"
    jcfg = JAX_ARCHS[arch].reduced().replace(
        remat="none", param_dtype="float32", dtype="float32")
    params = jbuild(jcfg).init(jax.random.PRNGKey(0))
    cfg = ARCHS[arch].reduced().replace(
        remat="none", param_dtype="float32", dtype="float32")
    state = lm_params_from_numpy(cfg, jax.tree.map(np.asarray, params))
    out = twin.main(["--device", "cpu", "--kernels", kernels],
                    params=state)
    got = capsys.readouterr().out.splitlines()
    assert want[-1] == got[-1] == f"generated: {out[0].tolist()}"
    assert out.shape == (2, 8)
    assert got[0].split("logits ")[1] == want[0].split("logits ")[1]


def test_twins_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_serve_lm").main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("torch_quickstart").main([])
