"""The port stands alone: importing every ``repro_torch`` module,
``chip_smoke.py`` and the example twins (``examples/torch_*.py``) loads
neither ``jax`` nor the JAX package ``repro``,
and the entry points refuse to run on the CPU in place of a missing
card."""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = textwrap.dedent("""
    import importlib, pkgutil, sys
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    assert {"repro_torch.launch.dryrun",
            "repro_torch.launch.cost_analysis",
            "repro_torch.launch.mesh",
            "repro_torch.fl.runtime.sharding"} <= set(names)
    import chip_smoke
    import importlib.util
    for name in ("torch_quickstart", "torch_compare_strategies",
                 "torch_fl_llm_finetune", "torch_serve_lm"):
        spec = importlib.util.spec_from_file_location(
            name, f"examples/{name}.py")
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    print(len(names), bad)
""")


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    count, bad = out.stdout.split(maxsplit=1)
    assert int(count) >= 25          # every module of the slice was imported
    assert bad.strip() == "[]"


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    import repro_torch.fl as fl
    from repro_torch.models import cnn
    data = {"x": np.zeros((2, 4, 16, 16, 3), np.float32),
            "y": np.zeros((2, 4), np.int32), "w": np.ones((2, 4), np.float32)}
    params = cnn.init(torch.Generator().manual_seed(0), image_hw=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl.build("fedentropy", cnn.apply, params, data,
                 fl.ServerConfig(num_clients=2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fl.ClientCorpus(data)
    server = fl.build("fedentropy", cnn.apply, params, data,
                      fl.ServerConfig(num_clients=2), device="cpu")
    assert server.device.type == "cpu"


def test_lm_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models.api import build_model
    cfg = ARCHS["zamba2-2.7b"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(ARCHS["whisper-large-v3"].reduced())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "zamba2-2.7b", "--reduced"])
    model = build_model(cfg, device="cpu")
    assert model.device.type == "cpu" and model.kernels == "cuda"
