"""``cfg.remat`` in the port's models, the gradient step's donation and
the training CLI's ``--remat``, ``--attn`` and ``--layers``, against the
live JAX reference, on the CPU at ``reduced()`` sizes with ``remat``
replaced, one config a family (dense, moe, ssm, hybrid, vlm, encdec).

* ``"full"`` and ``"dots"`` recompute layers in the backward
  (``models.layers.remat``): the gradient step's gradients, new params
  and metrics equal ``"none"``'s bit for bit, and the activations kept
  for the backward (counted by a saved-tensor hook) are fewer, except
  where the reference checkpoints nothing (encdec under ``"dots"``).
* Against the reference's gradient under the same ``remat``: per leaf
  within ``GRAD_RTOL`` = 1e-5 of the leaf's max |grad| and the loss
  within 1e-5 (``tests/test_torch_train.py``'s bounds; whisper's key
  bias, 0 in exact arithmetic, held absolutely as there).
* lmstep differentiates under ``torch.func``, where the layers are
  recomputed by ``kernels.ref.recomputed``'s function of their weights
  and inputs: a ``"full"`` model gives ``"none"``'s records
  (``tests/test_torch_recompute.py`` holds every family and the memory).
* ``make_train_step(..., donate=True)`` (the mesh engine's, the
  reference's ``donate_argnums``) and
  ``make_microbatched_train_step(..., donate=True)`` equal their
  undonated steps bit for bit and return the tensors they were given.
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.fl as tfl
from repro.configs import ARCHS as JAX_ARCHS
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core import distributed as tdist
from repro_torch.launch import train
from repro_torch.models.api import build_model
from repro_torch.optim import Optimizer, adamw, sgd

GRAD_RTOL = 1e-5
LOSS_ATOL = 1e-5
FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "vlm": "internvl2-1b", "encdec": "whisper-large-v3"}
MODES = ["full", "dots"]
M, PER, SEQ = 2, 2, 17


@pytest.fixture(scope="module")
def family():
    """family -> (reference params, port state dict, port reduced
    config, batch as numpy), built once per family."""
    built = {}

    def get(fam):
        if fam not in built:
            arch = FAMILIES[fam]
            jm = jax_build_model(JAX_ARCHS[arch].reduced())
            params = jm.init(jax.random.PRNGKey(0))
            cfg = ARCHS[arch].reduced()
            state = lm_params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                           params))
            corpus, idx = train.build_fl_corpus(cfg, M, "case1", SEQ - 1, 0)
            rng = np.random.default_rng(0)
            toks = np.concatenate([corpus[rng.choice(idx[i], PER)]
                                   for i in range(M)]).astype(np.int32)
            batch = {"tokens": toks, **{k: v.numpy() for k, v in
                                        train.batch_extras(
                                            cfg, M * PER, "cpu").items()}}
            built[fam] = (params, state, cfg, batch)
        return built[fam]
    return get


def _model(cfg, state, remat):
    model = build_model(cfg.replace(remat=remat), device="cpu",
                        kernels="torch")
    model.net.load_state_dict(state)
    return model


def _step(model, batch, enabled=True):
    """One gradient step (sgd, momentum 0.5): (the gradients its update
    received, new params, metrics, bytes kept for the backward)."""
    got = {}
    base = sgd(lr=0.1, momentum=0.5)

    def update(grads, state, params):
        got.update({k: g.clone() for k, g in grads.items()})
        return base.update(grads, state, params)

    step = tdist.make_train_step(
        model, Optimizer(base.init, update),
        tdist.FedSpec(num_clients=M, enabled=enabled),
        judge_fn=tfl.MaxEntropyJudge("torch").traced())
    params = {k: v.detach().clone() for k, v in model.params().items()}
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        new, _, metrics = step(params, base.init(params),
                               {k: torch.from_numpy(v)
                                for k, v in batch.items()})
    return got, new, metrics, kept[0]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_remat_gradients_equal_none_bit_for_bit(family, fam, mode):
    _, state, cfg, batch = family(fam)
    g0, p0, m0, kept0 = _step(_model(cfg, state, "none"), batch)
    g1, p1, m1, kept1 = _step(_model(cfg, state, mode), batch)
    assert list(g0) == list(g1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
        assert torch.equal(p0[k], p1[k]), k
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    if fam == "encdec" and mode == "dots":
        assert kept1 == kept0        # the reference's decoder: "full" only
    else:
        assert kept1 < kept0, (kept1, kept0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_remat_gradients_match_reference(family, fam, mode):
    params, state, cfg, batch = family(fam)
    jm = jax_build_model(JAX_ARCHS[FAMILIES[fam]].reduced().replace(
        remat=mode))
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(params)
    got, _, metrics, _ = _step(_model(cfg, state, mode), batch,
                               enabled=False)
    assert float(metrics["loss"]) == pytest.approx(float(jloss),
                                                   abs=LOSS_ATOL)
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jgrads))[0]
    mine = jax.tree_util.tree_flatten_with_path(
        lm_params_to_numpy(cfg, got))[0]
    assert [p for p, _ in want] == [p for p, _ in mine]
    scale = max(float(np.abs(w).max()) for _, w in want)
    for (path, w), (_, g) in zip(want, mine):
        name = jax.tree_util.keystr(path)
        if cfg.attn_bias and cfg.rope_style == "none" and \
                "['w_k']['b']" in name:
            # 0 in exact arithmetic without RoPE (test_torch_train)
            assert max(np.abs(w).max(), np.abs(g).max()) <= \
                GRAD_RTOL * scale
            continue
        err = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
        assert err <= GRAD_RTOL, (name, err)


def _lmstep_records(cfg, state):
    model = _model(cfg, state, cfg.remat)
    corpus, idx = train.build_fl_corpus(cfg, 8, "case1", 12, 0)
    data = train.stack_lm_clients(corpus, idx, 4, 12, 0)
    server = tfl.build(
        "fedentropy", train.lm_window_apply(model, cfg),
        {k: v.detach() for k, v in model.params().items()}, data,
        tfl.ServerConfig(num_clients=8, participation=0.5, seed=0),
        tfl.LocalSpec(epochs=1, lr=0.01, batch_size=2), strategy="lmstep",
        device="cpu")
    records = [server.round() for _ in range(2)]
    return records, server.global_params


@pytest.mark.parametrize("fam", ["dense", "encdec"])
def test_lmstep_with_remat_full_equals_none(family, fam):
    """lmstep's client program runs under ``vmap`` of a gradient: the
    layers are recomputed there (``kernels.ref.recomputed`` under
    ``torch.func``), and the records and the global params are
    ``"none"``'s, bit for bit."""
    _, state, cfg, _ = family(fam)
    want, wp = _lmstep_records(cfg.replace(remat="none"), state)
    got, gp = _lmstep_records(cfg.replace(remat="full"), state)
    assert got == want
    for k in wp:
        assert torch.equal(gp[k], wp[k]), k


@pytest.mark.parametrize("opt", [sgd(lr=0.1, momentum=0.5),
                                 adamw(lr=1e-2, weight_decay=0.1)],
                         ids=["sgd", "adamw"])
def test_donated_step_equals_undonated(family, opt):
    _hold_donation(family, opt, tdist.make_train_step)


@pytest.mark.parametrize("opt", [sgd(lr=0.1, momentum=0.5),
                                 adamw(lr=1e-2, weight_decay=0.1)],
                         ids=["sgd", "adamw"])
def test_donated_microbatched_step_equals_undonated(family, opt):
    _hold_donation(family, opt, lambda *a, **kw: (
        tdist.make_microbatched_train_step(*a, 2, **kw)))


def _hold_donation(family, opt, make_step) -> None:
    """Two steps of ``make_step(model, opt, fed, donate=True)`` on the
    moe family: the params and optimizer state it returns are the
    tensors it was given, and equal the undonated step's bit for bit."""
    _, state, cfg, batch = family("moe")
    model = _model(cfg, state, "full")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fed = tdist.FedSpec(num_clients=M)
    params = {k: v.detach().clone() for k, v in model.params().items()}
    state0 = opt.init(params)
    want = (params, state0)
    for _ in range(2):
        want = make_step(model, opt, fed)(*want, tb)[:2]
    given = ({k: v.clone() for k, v in params.items()},
             {n: ({k: v.clone() for k, v in s.items()}
                  if isinstance(s, dict) else s.clone())
              for n, s in state0.items()})
    step = make_step(model, opt, fed, donate=True)
    got = given
    for _ in range(2):
        got = step(*got, tb)[:2]
    for k in params:
        assert got[0][k] is given[0][k]
        assert torch.equal(got[0][k], want[0][k]), k
    for n, s in want[1].items():
        if isinstance(s, dict):
            for k in s:
                assert got[1][n][k] is given[1][n][k]
                assert torch.equal(got[1][n][k], s[k]), (n, k)
        else:
            assert torch.equal(got[1][n], s), n


_BASE = ["--arch", "qwen3-0.6b", "--reduced", "--steps", "2", "--clients",
         "2", "--logical-clients", "4", "--seq-len", "16", "--device",
         "cpu"]


def test_cli_remat_and_attn_keep_the_records():
    """``--remat full --attn blockwise`` trains the reduced qwen3 (16
    tokens: the blockwise route takes plain attention) to the default
    run's records; ``--layers`` cuts the depth (encdec: both stacks)."""
    want = train.main(_BASE)
    got = train.main(_BASE + ["--remat", "full", "--attn", "blockwise"])
    for w, g in zip(want, got, strict=True):
        w.pop("seconds"), g.pop("seconds")
        assert g == w
    args = train.parser().parse_args(
        ["--arch", "whisper-large-v3", "--layers", "4", "--remat", "dots"])
    cfg = train.train_config(args)
    assert (cfg.num_layers, cfg.num_encoder_layers, cfg.remat) == (4, 4,
                                                                   "dots")
    assert cfg.d_model == ARCHS["whisper-large-v3"].d_model
    assert train.train_config(train.parser().parse_args(
        ["--arch", "qwen3-0.6b"])).remat == ARCHS["qwen3-0.6b"].remat


def test_random_stub_frontend():
    """``--extras random``: one N(0, 1) draw from ``--seed`` in every row
    of the vlm family's patches (zero patches stay 0 through every layer
    and overflow the gradient at internvl2-1b's depth); the mesh step
    trains on it, to other records than on zeros."""
    cfg = ARCHS["internvl2-1b"].reduced()
    assert train.stub_frontend(cfg, "zeros", 0, "cpu") is None
    assert train.stub_frontend(ARCHS["qwen3-0.6b"], "random", 0,
                               "cpu") is None
    stub = train.stub_frontend(cfg, "random", 0, "cpu")
    assert stub.shape == (cfg.num_patches, cfg.d_model)
    rows = train.batch_extras(cfg, 3, "cpu", stub)["patches"]
    assert rows.shape == (3, cfg.num_patches, cfg.d_model)
    assert all(torch.equal(r, stub) for r in rows)
    argv = ["--arch", "internvl2-1b", "--reduced", "--steps", "1",
            "--clients", "2", "--logical-clients", "4", "--seq-len", "16",
            "--device", "cpu"]
    zeros = train.main(argv)
    drawn = train.main(argv + ["--extras", "random"])
    assert np.isfinite(drawn[0]["grad_norm"])
    assert drawn[0]["loss"] != zeros[0]["loss"]
