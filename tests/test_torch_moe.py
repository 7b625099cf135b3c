"""The port's ``moe`` family and the five LM configs of this slice against
the live JAX reference, on the CPU, at ``reduced()`` sizes.

* ``repro_torch.models.moe`` against ``repro.models.moe``'s single-device
  path (``moe_block_pjit``, ``_route``, ``_dispatch_indices``,
  ``_capacity``) on the same numpy inputs and weights, for
  qwen3-moe-235b-a22b and kimi-k2-1t-a32b reduced (4 experts, top 2), at
  capacity factors 1.25 (the default), E / k (nothing dropped) and 0.01
  (most assignments dropped, as ``tests/test_moe_shardmap.py`` does):
  the routing integers exact (top-k ids, the stable sort's order,
  positions in expert, the kept mask), gate probabilities and the aux
  loss within ``AUX_ATOL``, outputs within ``OUT_RTOL`` of max |out| (the
  port sums a token's k contributions in slot order, the reference
  scatter-adds them in sort order);
* the reduced qwen3-moe model (prefill, greedy decode, a ring cache of
  a window) and the three dense configs chatglm3-6b, gemma-7b and
  granite-8b against the reference on its ``xla`` route: greedy tokens
  equal, logits within ``LOGIT_ATOL`` (``tests/test_torch_lm.py``'s
  bound);
* the moe model's loss (with ``router_aux_weight`` times the layers'
  aux) within ``LOSS_ATOL`` and its gradients within ``GRAD_RTOL`` of
  each leaf's max |grad| (``tests/test_torch_train.py``'s bounds);
* weights carried key for key both ways, and the configs equal field for
  field.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_moe.py
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import moe as jmoe
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import moe
from repro_torch.models.api import build_model

OUT_RTOL = 1e-5          # of max |out|
AUX_ATOL = 1e-6
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
GEN = 3
MOE_ARCHS = ["qwen3-moe-235b-a22b", "kimi-k2-1t-a32b"]
DENSE_ARCHS = ["chatglm3-6b", "gemma-7b", "granite-8b"]
NEW_ARCHS = MOE_ARCHS + DENSE_ARCHS


@pytest.fixture(scope="module")
def reference():
    """arch -> (JAX model, its params, the params as numpy, port config,
    prompts (2, 24)), built once per arch at ``reduced()``."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = JAX_ARCHS[arch].reduced()
            jm = jax_build_model(jcfg)
            params = jm.init(jax.random.PRNGKey(0))
            toks = np.random.default_rng(1).integers(
                0, jcfg.vocab_size, (2, 24)).astype(np.int32)
            built[arch] = (jm, params, jax.tree.map(np.asarray, params),
                           ARCHS[arch].reduced(), toks)
        return built[arch]
    return get


def _port_model(tcfg, tree, kernels="cuda"):
    model = build_model(tcfg, device="cpu", kernels=kernels)
    model.net.load_state_dict(lm_params_from_numpy(tcfg, tree))
    return model


# ------------------------------------------------------------- the block

def _block_case(arch, cf):
    cfg = ARCHS[arch].reduced()
    cf = cfg.num_experts / cfg.experts_per_token if cf == "E/k" else cf
    cfg = cfg.replace(moe_capacity_factor=cf)
    jcfg = JAX_ARCHS[arch].reduced().replace(moe_capacity_factor=cf)
    p = jax.tree.map(np.array, jmoe.moe_init(jax.random.PRNGKey(3), jcfg))
    block = moe.MoE(cfg, torch.Generator().manual_seed(0))
    block.load_state_dict({"router.w": torch.from_numpy(p["router"]["w"]),
                           **{k: torch.from_numpy(p[k])
                              for k in ("w_in", "w_gate", "w_out")}})
    x = np.random.default_rng(4).normal(size=(2, 16, cfg.d_model)) \
        .astype(np.float32)
    return cfg, jcfg, p, block, x


@pytest.mark.parametrize("cf", [1.25, "E/k", 0.01])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_block_matches_reference(arch, cf):
    cfg, jcfg, p, block, x = _block_case(arch, cf)
    t, k = 2 * 16, cfg.experts_per_token
    xt = x.reshape(t, -1)
    cap = moe.capacity(cfg, t)
    assert cap == jmoe._capacity(jcfg, t)

    jtop_p, jtop_i, jaux = jmoe._route(jcfg, jnp.asarray(p["router"]["w"]),
                                       jnp.asarray(xt))
    with torch.no_grad():
        top_p, top_i, aux, _ = moe.route(cfg, block.router.w,
                                         torch.from_numpy(xt))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), rtol=0,
                               atol=AUX_ATOL)
    assert float(aux) == pytest.approx(float(jaux), abs=AUX_ATOL)

    want = jmoe._dispatch_indices(jcfg, jtop_i)
    got = moe.dispatch_indices(top_i)
    for name, w, g in zip(("order", "sorted_e", "pos", "token_of"), want,
                          got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    jpos = np.asarray(want[2])
    kept_sorted = jpos < cap
    pos = moe.positions(top_i).numpy()
    row, kept = moe.dispatch(cfg, top_i, cap)
    order = np.asarray(want[0])
    np.testing.assert_array_equal(pos[order], jpos)
    np.testing.assert_array_equal(kept.numpy()[order], kept_sorted)
    e = cfg.num_experts
    np.testing.assert_array_equal(
        row.numpy(), np.where(kept, top_i.numpy().reshape(-1) * cap + pos,
                              e * cap))
    dropped = int((~kept_sorted).sum())
    if cf == "E/k":
        assert dropped == 0
    if cf == 0.01:
        assert dropped > t * k // 2          # most assignments dropped

    jout, jaux2 = jmoe.moe_block_pjit(jcfg, jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    with torch.no_grad():
        out, aux2 = block(torch.from_numpy(x))
    jout = np.asarray(jout)
    assert out.shape == jout.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), jout, rtol=0,
                               atol=OUT_RTOL * np.abs(jout).max())
    assert float(aux2) == pytest.approx(float(jaux2), abs=AUX_ATOL)
    # a token whose every assignment is dropped gets no output at all
    none_kept = ~kept.numpy().reshape(t, k).any(1)
    assert np.all(out.numpy().reshape(t, -1)[none_kept] == 0)
    if cf == 0.01:
        assert none_kept.any()


def test_moe_block_repeats_and_differentiates():
    """Two calls give the same bits (no atomics), and the gradient flows
    to x, the router and the experts' weights."""
    cfg, _, _, block, x = _block_case("qwen3-moe-235b-a22b", 1.25)
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = block(xt)
    with torch.no_grad():
        again, _ = block(xt)
    assert torch.equal(out, again)
    (out.square().sum() + aux).backward()
    assert float(xt.grad.abs().sum()) > 0
    for name, w in block.named_parameters():
        assert w.grad is not None and float(w.grad.abs().sum()) > 0, name


# ------------------------------------------------------------- the model

def _serve_jax(jm, params, toks, gen, window=None):
    s = toks.shape[1]
    lg, cache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, cache_len=s + gen, window=window))(
            params, jnp.asarray(toks))
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, window=window))
    logits, tokens = [np.asarray(lg)], []
    tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
    for _ in range(gen):
        tokens.append(np.asarray(tok))
        lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
    return logits, tokens


def _serve_port(model, toks, gen, window=None):
    s = toks.shape[1]
    lg, cache = model.prefill({"tokens": torch.from_numpy(toks)},
                              cache_len=s + gen, window=window)
    logits, tokens = [lg.numpy()], []
    tok = lg[:, -1:].argmax(-1)
    for _ in range(gen):
        tokens.append(tok.numpy())
        lg, cache = model.decode_step(cache, tok, window=window)
        logits.append(lg.numpy())
        tok = lg[:, -1:].argmax(-1)
    assert cache["index"] == s + gen
    return logits, tokens


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b"] + DENSE_ARCHS)
def test_serve_matches_reference(reference, arch):
    """Prefill and greedy decode on the reference's xla route; the moe
    case also with a window of 8 over its 24-token prompts."""
    jm, params, tree, tcfg, toks = reference(arch)
    windows = [None, 8] if tcfg.family == "moe" else [None]
    model = _port_model(tcfg, tree)
    for window in windows:
        want_logits, want_tokens = _serve_jax(jm, params, toks, GEN, window)
        got_logits, got_tokens = _serve_port(model, toks, GEN, window)
        assert got_logits[0].shape == (2, 24, tcfg.padded_vocab)
        for step, (got, want) in enumerate(zip(got_logits, want_logits)):
            np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                       err_msg=f"{arch} step {step}")
        for got, want in zip(got_tokens, want_tokens):
            np.testing.assert_array_equal(got, want)


def test_moe_ring_buffer_decode_matches_reference(reference):
    """A ring cache of exactly the window, decoded from empty: each step a
    2-token MoE call (capacity 8), equal to the reference's ring decode."""
    jm, params, tree, tcfg, _ = reference("qwen3-moe-235b-a22b")
    w, steps = 8, 14
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, steps)).astype(np.int32)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, window=w))
    jcache = jm.init_cache(2, w)
    model = _port_model(tcfg, tree)
    cache = model.init_cache(2, w)
    got, want = [], []
    for t in range(steps):
        lg, jcache = step(params, jcache, jnp.asarray(toks[:, t:t + 1]))
        want.append(np.asarray(lg[:, 0]))
        lg, cache = model.decode_step(cache,
                                      torch.from_numpy(toks[:, t:t + 1]),
                                      window=w)
        got.append(lg[:, 0].numpy())
    np.testing.assert_allclose(np.stack(got, 1), np.stack(want, 1), rtol=0,
                               atol=LOGIT_ATOL)
    assert sorted(cache["pos"].tolist()) == list(range(steps - w, steps))


def test_moe_loss_and_grads_match_reference(reference):
    """``Model.loss`` adds ``router_aux_weight`` times the layers' summed
    aux, as the reference's; its gradient per leaf (the router's through
    the gates and the aux) on the torch route."""
    jm, params, tree, tcfg, toks = reference("qwen3-moe-235b-a22b")
    batch = {"tokens": jnp.asarray(toks)}
    jloss, _ = jm.loss(params, batch)
    _, jaux = jm.forward(params, batch)
    jgrads = jax.grad(lambda p: jm.loss(p, batch)[0])(params)
    model = _port_model(tcfg, tree, kernels="torch")
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in model.params().items()}
    loss, _ = model.loss(leaves, {"tokens": torch.from_numpy(toks)})
    with torch.no_grad():
        _, aux = model.apply(leaves, {"tokens": torch.from_numpy(toks)})
    assert float(aux) > 0
    assert float(aux) == pytest.approx(float(jaux), abs=AUX_ATOL)
    assert float(loss.detach()) == pytest.approx(float(jloss),
                                                 abs=LOSS_ATOL)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    got = lm_params_to_numpy(tcfg, dict(zip(leaves, grads)))
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in want] == [p for p, _ in flat]
    for (path, a), (_, b) in zip(want, flat):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        rel = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
        assert rel <= GRAD_RTOL, (jax.tree_util.keystr(path), rel)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_params_carry_over_key_for_key(reference, arch):
    """Every leaf of the reference's tree lands on one parameter of the
    port (``load_state_dict`` is strict), the counts agree, and the way
    back restacks the same bits."""
    _, _, tree, tcfg, _ = reference(arch)
    model = _port_model(tcfg, tree)
    assert model.num_params() == sum(np.size(x)
                                     for x in jax.tree.leaves(tree))
    back = lm_params_to_numpy(tcfg, model.params())
    want = jax.tree_util.tree_flatten_with_path(tree)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    for (_, a), (_, b) in zip(want, got):
        np.testing.assert_array_equal(a, b)
    if tcfg.family == "moe":
        layer = model.net.layers[1].moe
        np.testing.assert_array_equal(layer.w_out.detach().numpy(),
                                      tree["layers"]["moe"]["w_out"][1])
        np.testing.assert_array_equal(
            layer.router.w.detach().numpy(),
            tree["layers"]["moe"]["router"]["w"][1])


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_reference(arch):
    assert dataclasses.asdict(ARCHS[arch]) == \
        dataclasses.asdict(JAX_ARCHS[arch])
    assert dataclasses.asdict(ARCHS[arch].reduced()) == \
        dataclasses.asdict(JAX_ARCHS[arch].reduced())


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b"] + DENSE_ARCHS)
def test_serve_entry_point_on_the_cpu(arch):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--prompt-len", "12", "--gen", "3", "--temperature", "0"]
    greedy = serve.main(argv)
    assert greedy.shape == (2, 3)
    np.testing.assert_array_equal(greedy, serve.main(argv + ["--kernels",
                                                             "torch"]))
