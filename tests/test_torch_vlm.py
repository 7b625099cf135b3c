"""The port's ``vlm`` family and its config, internvl2-1b, against the live
JAX reference, on the CPU, at ``reduced()`` sizes (2 layers, d_model 256,
8 patches).

The reference's weights cross to the port as numpy
(``convert.lm_params_from_numpy``); both sides then run the same tokens
and random patch embeddings:

* the config equals the reference's field for field, full and reduced;
* the weights carry across key for key both ways (``patch_proj`` a plain
  leaf), and a round trip gives the same bits;
* ``forward``: logits over the text positions within ``LOGIT_ATOL``
  (``tests/test_torch_lm.py``'s policy);
* serve, a prefill and 3 greedy decode steps, against the reference's
  ``xla`` and ``pallas`` (interpret) routes: greedy tokens equal, logits
  within ``LOGIT_ATOL``, the cache index num_patches + S and then
  num_patches + S + 3;
* ``serve.main`` returns the reference's ``serve.main`` greedy tokens for
  the same seed and weights (the reference's random init carried across
  in a checkpoint): the patches drawn after the prompts, the cache of
  S + num_patches + gen slots;
* the training adapters ``lm_window_apply`` and ``lm_client_apply`` (zero
  patches) within ``LOGIT_ATOL`` of the reference's, and the
  microbatched step splitting the patches with the tokens.

``tests/test_torch_encdec.py`` runs the same checks on the encdec family
with the helpers of this file.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_vlm.py
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import dataclasses
import json
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ops as jax_ops
from repro.models.api import build_model as jax_build_model
from repro_torch.checkpoint import save
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core import distributed as tdist
from repro_torch.launch import serve, train
from repro_torch.models.api import build_model
from repro_torch.optim import sgd

LOGIT_ATOL = 1e-4
GEN = 3                  # greedy decode steps after the prefill
ARCH = "internvl2-1b"


def extras(cfg, b: int, rng) -> dict:
    """The family's random frontend embeddings for ``b`` rows, numpy."""
    if cfg.family == "vlm":
        return {"patches": rng.normal(
            size=(b, cfg.num_patches, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.normal(
            size=(b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)}
    return {}


def build_reference(arch: str):
    """(JAX model, its params, the params as numpy, port config, batch of
    2 prompts of 12 tokens and the family's extras) at ``reduced()``."""
    jcfg = JAX_ARCHS[arch].reduced()
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, jcfg.vocab_size,
                                    (2, 12)).astype(np.int32),
             **extras(jcfg, 2, rng)}
    return (jm, params, jax.tree.map(np.asarray, params),
            ARCHS[arch].reduced(), batch)


@pytest.fixture(scope="module")
def reference():
    return build_reference(ARCH)


@pytest.fixture
def jax_backend():
    """Sets the JAX package's kernel backend; restores it afterwards."""
    prev = (jax_ops._DEFAULT, jax_ops._INTERPRET)
    yield jax_ops.set_default_backend
    jax_ops.set_default_backend(*prev)


def port_model(tcfg, tree, kernels="cuda"):
    model = build_model(tcfg, device="cpu", kernels=kernels)
    model.net.load_state_dict(lm_params_from_numpy(tcfg, tree))
    return model


def _prefix(cfg) -> int:
    return cfg.num_patches if cfg.family == "vlm" else 0


def serve_jax(jm, params, batch, gen):
    """Prefill + ``gen`` greedy steps: (logits per step, tokens, cache
    index after the prefill and after the last step)."""
    cache_len = batch["tokens"].shape[1] + _prefix(jm.cfg) + gen
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    # fresh lambdas: a trace must not outlive a change of backend
    lg, cache = jax.jit(lambda p, b: jm.prefill(
        p, b, cache_len=cache_len))(params, jbatch)
    index = [int(cache["index"])]
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    logits, tokens = [np.asarray(lg)], []
    tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
    for _ in range(gen):
        tokens.append(np.asarray(tok))
        lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
    return logits, tokens, index + [int(cache["index"])]


def serve_port(model, batch, gen):
    cache_len = batch["tokens"].shape[1] + _prefix(model.cfg) + gen
    lg, cache = model.prefill({k: torch.from_numpy(v)
                               for k, v in batch.items()},
                              cache_len=cache_len)
    index = [cache["index"]]
    logits, tokens = [lg.numpy()], []
    tok = lg[:, -1:].argmax(-1)
    for _ in range(gen):
        tokens.append(tok.numpy())
        lg, cache = model.decode_step(cache, tok)
        logits.append(lg.numpy())
        tok = lg[:, -1:].argmax(-1)
    return logits, tokens, index + [cache["index"]]


# ------------------------------------------------------------ the checks,
# shared with tests/test_torch_encdec.py

def check_config(arch):
    assert dataclasses.asdict(ARCHS[arch]) == \
        dataclasses.asdict(JAX_ARCHS[arch])
    assert dataclasses.asdict(ARCHS[arch].reduced()) == \
        dataclasses.asdict(JAX_ARCHS[arch].reduced())


def check_params(reference, stacked: dict):
    """Key for key both ways, the counts equal, the same bits back;
    ``stacked``: each stacked subtree of the tree -> its layer count."""
    _, _, tree, tcfg, _ = reference
    model = port_model(tcfg, tree)
    assert model.num_params() == sum(np.size(x)
                                     for x in jax.tree.leaves(tree))
    back = lm_params_to_numpy(tcfg, model.params())
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(a, b)
    for name, n in stacked.items():
        assert len(getattr(model.net, name)) == n
        np.testing.assert_array_equal(
            getattr(model.net, name)[n - 1].attn.w_q.w.detach().numpy(),
            tree[name]["attn"]["w_q"]["w"][n - 1])
    with pytest.raises(ValueError, match="stacked axes"):
        lm_params_from_numpy(tcfg.replace(num_layers=5), tree)


def check_forward(reference):
    jm, params, tree, tcfg, batch = reference
    want, _ = jax.jit(lambda p, b: jm.forward(p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got, aux = port_model(tcfg, tree).forward(
            {k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux) == 0.0
    s = batch["tokens"].shape[1]
    assert got.shape == (2, s, tcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


def check_serve(reference):
    jm, params, tree, tcfg, batch = reference
    want_logits, want_tokens, want_index = serve_jax(jm, params, batch, GEN)
    got_logits, got_tokens, got_index = serve_port(port_model(tcfg, tree),
                                                   batch, GEN)
    s = batch["tokens"].shape[1] + _prefix(tcfg)
    assert got_index == want_index == [s, s + GEN]
    assert got_logits[0].shape == (2, batch["tokens"].shape[1],
                                   tcfg.padded_vocab)
    for step, (got, want) in enumerate(zip(got_logits, want_logits)):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
    for got, want in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(got, want)


def check_serve_entry_point(reference, arch, tmp_path, monkeypatch, capsys):
    """Both packages' ``serve.main`` on the same seed: the reference's
    random init (its weights at seed 0 are the fixture's) served by the
    port from a checkpoint; the greedy tokens of both rows equal."""
    from repro.launch import serve as jax_serve
    _, _, tree, tcfg, _ = reference
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
            "12", "--gen", "4", "--temperature", "0", "--seed", "0"]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    capsys.readouterr()
    jax_serve.main()
    printed = capsys.readouterr().out
    want = np.array([json.loads(m) for m in re.findall(
        r"seq\d: (\[.*\])", printed)])
    ckpt = str(tmp_path / "ckpt")
    save(ckpt, 0, lm_params_from_numpy(tcfg, tree))
    got = serve.main(argv + ["--device", "cpu", "--ckpt-dir", ckpt])
    assert want.shape == got.shape == (2, 4)
    np.testing.assert_array_equal(got, want)


def check_adapters(reference):
    """``lm_window_apply`` and ``lm_client_apply`` on (B, L+1) windows,
    the family's extras zero, against the reference's adapters."""
    from repro.launch import train as jax_train
    jm, params, tree, tcfg, _ = reference
    model = port_model(tcfg, tree, kernels="torch")
    x = np.random.default_rng(3).integers(
        0, tcfg.vocab_size, (3, 10)).astype(np.int32)
    for name in ("lm_window_apply", "lm_client_apply"):
        want = jax.jit(getattr(jax_train, name)(jm, jm.cfg))(
            params, jnp.asarray(x))
        with torch.no_grad():
            got = getattr(train, name)(model, tcfg)(model.params(),
                                                    torch.from_numpy(x))
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=LOGIT_ATOL, err_msg=name)


def check_microbatched_step(reference):
    """The gradient step over 2 microbatches splits the extras with the
    tokens (``distributed._split``): the full step's mask, and its update
    within ``tests/test_torch_train.py``'s 5e-6 or a relative 1e-6 (the
    update at lr 1 reaches |w| of about 66, where a float32 spacing is
    7.6e-6; measured 1.2e-7 relative)."""
    _, _, tree, tcfg, _ = reference
    model = port_model(tcfg, tree, kernels="torch")
    m, per, s = 2, 2, 9
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (m * per, s)))
    batch = {"tokens": toks,
             **train.batch_extras(tcfg, m * per, toks.device)}
    parts = tdist._split(batch, m, 2)
    assert [sorted(p) for p in parts] == [sorted(batch)] * 2
    assert all(v.shape[0] == m * per // 2 for p in parts for v in p.values())
    opt = sgd(lr=1.0, momentum=0.0)
    fed = tdist.FedSpec(num_clients=m)
    params = {k: v.detach() for k, v in model.params().items()}
    p1, _, m1 = tdist.make_train_step(model, opt, fed)(
        params, opt.init(params), batch)
    p2, _, m2 = tdist.make_microbatched_train_step(model, opt, fed, 2)(
        params, opt.init(params), batch)
    assert torch.equal(m1["mask"], m2["mask"])
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=1e-6, atol=5e-6)


# ------------------------------------------------------------ the vlm family

def test_config_equals_reference():
    check_config(ARCH)


def test_params_carry_over_key_for_key(reference):
    check_params(reference, {"layers": 2})
    _, _, tree, tcfg, _ = reference
    model = port_model(tcfg, tree)
    np.testing.assert_array_equal(model.net.patch_proj.w.detach().numpy(),
                                  tree["patch_proj"]["w"])


def test_forward_matches_reference(reference):
    check_forward(reference)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_serve_matches_reference(reference, jax_backend, backend):
    jax_backend(backend)
    check_serve(reference)


def test_serve_entry_point_matches_reference(reference, tmp_path,
                                             monkeypatch, capsys):
    check_serve_entry_point(reference, ARCH, tmp_path, monkeypatch, capsys)


def test_training_adapters_match_reference(reference):
    check_adapters(reference)


def test_microbatched_step_splits_the_patches(reference):
    check_microbatched_step(reference)
