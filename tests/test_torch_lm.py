"""The port's LM serving slice against the live JAX reference.

The reference's weights cross to the port as numpy
(``convert.lm_params_from_numpy``); both sides then prefill the same
prompts and decode greedily. The JAX side runs once with its ``xla``
kernels and once with its Pallas kernels (interpret mode); the port runs
its ``"cuda"`` route, whose wrappers take their plain versions on the CPU.

Greedy tokens must be equal and logits within ``LOGIT_ATOL``: the port
and the reference agree to about 7e-6 on these cases (logits of size
about 4), about the reference's own xla-vs-pallas difference, so 1e-4
leaves room for summation order without hiding a wrong mask or layout.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ops as jax_ops
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.api import build_model

LOGIT_ATOL = 1e-4
GEN = 3                  # greedy decode steps after the prefill

# Zamba2 at reduced depth with the full configuration's per-head shapes
_HD80 = dict(name="zamba2-2.7b-hd80", d_model=320, num_heads=4,
             num_kv_heads=4, head_dim=80, ssm_state=64, ssm_headdim=64,
             ssm_chunk=32, d_ff=640)
# case -> (arch, overrides of the reduced config, prompt length): each
# prompt spans at least 3 SSM chunks with a padded tail
CASES = {
    "zamba2-2.7b": ("zamba2-2.7b", {}, 40),
    "qwen3-0.6b": ("qwen3-0.6b", {}, 40),
    "mamba2-130m": ("mamba2-130m", {}, 40),
    "zamba2-2.7b-hd80": ("zamba2-2.7b", _HD80, 72),
}


def _configs(case):
    arch, kw, s = CASES[case]
    jcfg = JAX_ARCHS[arch].reduced().replace(**kw)
    tcfg = ARCHS[arch].reduced().replace(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg, s


@pytest.fixture(scope="module")
def reference():
    """case -> (JAX model, its params, the params as numpy, port config,
    prompt), built once per case."""
    built = {}

    def get(case):
        if case not in built:
            jcfg, tcfg, s = _configs(case)
            jm = jax_build_model(jcfg)
            params = jm.init(jax.random.PRNGKey(0))
            tree = jax.tree.map(np.asarray, params)
            toks = np.random.default_rng(s).integers(
                0, jcfg.vocab_size, (2, s)).astype(np.int32)
            built[case] = (jm, params, tree, tcfg, toks)
        return built[case]
    return get


@pytest.fixture
def jax_backend():
    """Sets the JAX package's kernel backend; restores it afterwards."""
    prev = (jax_ops._DEFAULT, jax_ops._INTERPRET)
    yield jax_ops.set_default_backend
    jax_ops.set_default_backend(*prev)


def _port_model(tcfg, tree, kernels="cuda"):
    model = build_model(tcfg, device="cpu", kernels=kernels)
    model.net.load_state_dict(lm_params_from_numpy(tcfg, tree))
    return model


def _serve_jax(jm, params, toks, gen):
    """Prefill + ``gen`` greedy steps; (logits per step, tokens)."""
    s = toks.shape[1]
    # fresh lambdas: a trace must not outlive a change of backend
    lg, cache = jax.jit(lambda p, t: jm.prefill(
        p, {"tokens": t}, cache_len=s + gen))(params, jnp.asarray(toks))
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t))
    logits, tokens = [np.asarray(lg)], []
    tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
    for _ in range(gen):
        tokens.append(np.asarray(tok))
        lg, cache = step(params, cache, tok)
        logits.append(np.asarray(lg))
        tok = jnp.argmax(lg[:, -1:], -1).astype(jnp.int32)
    return logits, tokens


def _serve_port(model, toks, gen):
    s = toks.shape[1]
    lg, cache = model.prefill({"tokens": torch.from_numpy(toks)},
                              cache_len=s + gen)
    assert cache["index"] == s
    logits, tokens = [lg.numpy()], []
    tok = lg[:, -1:].argmax(-1)
    for _ in range(gen):
        tokens.append(tok.numpy())
        lg, cache = model.decode_step(cache, tok)
        logits.append(lg.numpy())
        tok = lg[:, -1:].argmax(-1)
    assert cache["index"] == s + gen
    return logits, tokens


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", list(CASES))
def test_serve_matches_reference(reference, jax_backend, case, backend):
    jm, params, tree, tcfg, toks = reference(case)
    jax_backend(backend)
    want_logits, want_tokens = _serve_jax(jm, params, toks, GEN)
    got_logits, got_tokens = _serve_port(_port_model(tcfg, tree), toks, GEN)
    assert got_logits[0].shape == (2, toks.shape[1], tcfg.padded_vocab)
    for step, (got, want) in enumerate(zip(got_logits, want_logits)):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"{case} step {step}")
    for got, want in zip(got_tokens, want_tokens):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", ["zamba2-2.7b", "qwen3-0.6b",
                                  "mamba2-130m"])
def test_forward_matches_reference(reference, case):
    jm, params, tree, tcfg, toks = reference(case)
    want, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(
        params, jnp.asarray(toks))
    model = _port_model(tcfg, tree)
    with torch.no_grad():
        got, aux = model.forward({"tokens": torch.from_numpy(toks)})
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_sliding_window_ring_buffer_decode(reference, jax_backend, backend):
    """A ring cache of exactly the window, decoded from empty, as
    tests/test_models.py does it: equal to the reference's ring decode and
    to the port's own full-sequence windowed forward."""
    jm, params, tree, tcfg, _ = reference("qwen3-0.6b")
    jax_backend(backend)
    w, steps = 8, 20
    toks = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (1, steps)).astype(np.int32)
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, window=w))
    jcache = jm.init_cache(1, w)
    model = _port_model(tcfg, tree)
    cache = model.init_cache(1, w)
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
    with torch.no_grad():
        full, _ = model.forward({"tokens": torch.from_numpy(toks)},
                                window=w)
    np.testing.assert_allclose(np.stack(got, 1), full.numpy(), rtol=0,
                               atol=2e-3)    # tests/test_models.py's bound


def test_torch_route_equals_cuda_route_on_the_cpu(reference):
    """On CPU tensors every kernel wrapper takes its plain version, so the
    two routes give the same logits."""
    _, _, tree, tcfg, toks = reference("zamba2-2.7b")
    a, _ = _serve_port(_port_model(tcfg, tree, "cuda"), toks, 1)
    b, _ = _serve_port(_port_model(tcfg, tree, "torch"), toks, 1)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_params_carry_over_key_for_key(reference):
    """Every leaf of the reference's tree lands on one parameter of the
    port (load_state_dict is strict), and the counts agree."""
    _, _, tree, tcfg, _ = reference("zamba2-2.7b")
    model = _port_model(tcfg, tree)
    n_ref = sum(np.size(x) for x in jax.tree.leaves(tree))
    assert model.num_params() == n_ref
    groups = tcfg.num_layers // tcfg.attn_every
    assert len(model.net.ssm_layers) == groups
    np.testing.assert_array_equal(
        model.net.ssm_layers[1][0].ssm.A_log.detach().numpy(),
        tree["ssm_layers"]["ssm"]["A_log"][1, 0])
    with pytest.raises(ValueError, match="stacked axes"):
        lm_params_from_numpy(tcfg.replace(num_layers=8), tree)


def test_serve_entry_point_on_the_cpu():
    argv = ["--arch", "zamba2-2.7b", "--reduced", "--device", "cpu",
            "--batch", "2", "--prompt-len", "20", "--gen", "4"]
    greedy = serve.main(argv + ["--temperature", "0"])
    assert greedy.shape == (2, 4)
    np.testing.assert_array_equal(greedy,
                                  serve.main(argv + ["--temperature", "0"]))
    sampled = serve.main(argv + ["--kernels", "torch"])
    assert sampled.shape == (2, 4)
    assert ((0 <= sampled) & (sampled < 512)).all()
