"""The port's checkpoints (``repro_torch.checkpoint``): save, restore,
retention and the shape check, the file format shared with the JAX
package (each package's ``load`` reads the other's files to the same flat
arrays and meta), and ``launch.serve --ckpt-dir`` serving what
``launch.train --ckpt-dir`` saved, on the CPU."""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import (all_steps, latest_step, load, restore,
                                    save)
from repro_torch.configs import ARCHS
from repro_torch.launch import serve, train
from repro_torch.models.api import build_model

_TRAIN = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
          "--steps", "2", "--clients", "2", "--logical-clients", "4",
          "--seq-len", "16"]
_SERVE = ["--arch", "qwen3-0.6b", "--reduced", "--device", "cpu",
          "--batch", "2", "--prompt-len", "8", "--gen", "4",
          "--temperature", "0"]


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"layers.0.w": torch.randn(3, 4, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32),
                       "list": [torch.randn(2, generator=g),
                                torch.ones(1, dtype=torch.float64)]}}


def _same(a, b):
    for x, y in zip(torch.utils._pytree.tree_leaves(a),
                    torch.utils._pytree.tree_leaves(b), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip_and_meta(tmp_path):
    tree = _tree()
    path = save(str(tmp_path), 7, tree, meta={"arch": "x", "pos": [1, 2]})
    assert os.path.basename(path) == "step_00000007.npz"
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    got, meta, step = restore(str(tmp_path), tree)
    assert step == 7 and meta == {"arch": "x", "pos": [1, 2]}
    _same(got, tree)
    flat, _ = load(str(tmp_path), 7)
    assert set(flat) == {"layers.0.w", "nested/b", "nested/list/0",
                         "nested/list/1"}


def test_restore_casts_to_the_template(tmp_path):
    tree = _tree()
    save(str(tmp_path), 1, tree)
    like = {"layers.0.w": torch.zeros(3, 4, dtype=torch.float64),
            "nested": {"b": torch.zeros(5, dtype=torch.int64),
                       "list": [torch.zeros(2), torch.zeros(1)]}}
    got, _, _ = restore(str(tmp_path), like)
    assert got["layers.0.w"].dtype == torch.float64
    np.testing.assert_array_equal(got["layers.0.w"].numpy(),
                                  tree["layers.0.w"].double().numpy())


def test_retention_keeps_the_newest_steps(tmp_path):
    for s in (1, 5, 3, 9):
        save(str(tmp_path), s, _tree(s), keep=2)
    assert sorted(all_steps(str(tmp_path))) == [5, 9]
    assert latest_step(str(tmp_path)) == 9
    got, _, step = restore(str(tmp_path), _tree(), step=5)
    assert step == 5
    _same(got, _tree(5))


def test_restore_refuses_what_does_not_fit(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        restore(str(tmp_path), _tree())
    save(str(tmp_path), 1, _tree())
    bad = _tree()
    bad["layers.0.w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="checkpoint shape"):
        restore(str(tmp_path), bad)
    more = _tree()
    more["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="missing keys"):
        restore(str(tmp_path), more)


def test_files_cross_between_the_packages(tmp_path):
    jax = pytest.importorskip("jax")
    from repro.checkpoint import load as jload, restore as jrestore, \
        save as jsave
    tree = _tree()
    save(str(tmp_path / "port"), 3, tree, meta={"by": "port"})
    jflat, jmeta = jload(str(tmp_path / "port"), 3)
    flat, meta = load(str(tmp_path / "port"), 3)
    assert jmeta == meta == {"by": "port"}
    assert set(jflat) == set(flat)
    for k in flat:
        assert jflat[k].dtype == flat[k].dtype
        np.testing.assert_array_equal(jflat[k], flat[k])
    jtree = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()), tree)
    back, _, _ = jrestore(str(tmp_path / "port"), jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    jsave(str(tmp_path / "ref"), 4, jtree, meta={"by": "ref"})
    jflat, jmeta = jload(str(tmp_path / "ref"), 4)
    flat, meta = load(str(tmp_path / "ref"), 4)
    assert jmeta == meta == {"by": "ref"}
    assert set(jflat) == set(flat)
    for k in flat:
        np.testing.assert_array_equal(jflat[k], flat[k])
    got, _, step = restore(str(tmp_path / "ref"), tree)
    assert step == 4
    _same(got, tree)


def test_serve_serves_what_train_saved(tmp_path):
    """The mesh step's trained weights, saved by ``train --ckpt-dir``,
    restored by ``serve --ckpt-dir`` into ``Model.params()``: greedy
    tokens equal to serving those weights loaded by hand, and not the
    random init's."""
    ckpt = str(tmp_path / "ckpt")
    train.main(_TRAIN + ["--ckpt-dir", ckpt, "--lr", "0.5"])
    assert latest_step(ckpt) == 2
    served = serve.main(_SERVE + ["--ckpt-dir", ckpt])
    cfg = ARCHS["qwen3-0.6b"].reduced()
    model = build_model(cfg, device="cpu")
    params, meta, _ = restore(ckpt, model.params())
    assert meta["arch"] == cfg.name
    init = {k: v.detach().clone() for k, v in model.params().items()}
    model.net.load_state_dict(params)
    assert any(not torch.equal(init[k], v) for k, v in params.items())
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 8)))
    logits, cache = model.prefill({"tokens": prompts}, cache_len=12)
    tok = logits[:, -1:].argmax(-1)
    want = [tok]
    for _ in range(3):
        logits, cache = model.decode_step(cache, tok)
        tok = logits[:, -1:].argmax(-1)
        want.append(tok)
    np.testing.assert_array_equal(served, torch.cat(want, 1).numpy())


def test_serve_refuses_a_checkpoint_of_another_model(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    train.main(_TRAIN + ["--ckpt-dir", ckpt, "--engine", "sequential",
                         "--samples-per-client", "2"])
    with pytest.raises(ValueError, match="checkpoint shape|missing keys"):
        serve.main(["--arch", "mamba2-130m", "--reduced", "--device",
                    "cpu", "--ckpt-dir", ckpt])
