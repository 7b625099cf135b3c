"""The port's LM training pieces against the live JAX reference: the
optimizers, the token corpus, ``lm_loss`` / ``Model.loss`` and their
gradients, and the gradient-level FedEntropy step
(``repro_torch.core.distributed``).

The reference's weights cross to the port as numpy
(``convert.lm_params_from_numpy``) and the port's gradients and trained
weights come back the same way (``convert.lm_params_to_numpy``), so every
comparison is leaf by leaf on the reference's tree. Reduced qwen3-0.6b
(dense) and reduced mamba2-130m (ssm), float32, on the CPU; the loss and
its gradients also at reduced internvl2-1b (vlm) and whisper-large-v3
(encdec), with the zero patches or frames of the reference's adapters.

Tolerances, measured on these cases and stated here:

* the optimizers: params and state within a relative 1e-6 of max |value|
  per leaf over 5 steps (float32 arithmetic in the same order; AdamW's
  bias correction raises b to a float32 count in each package's ``pow``);
* ``make_token_dataset``, ``build_fl_corpus``: equal bits (numpy);
* ``lm_loss`` and ``Model.loss``: within 1e-5 (measured 5e-7 to 1e-6 at
  a loss of about 6.7);
* the gradient of ``Model.loss``, per leaf: max |diff| within
  ``GRAD_RTOL`` = 1e-5 of the leaf's max |grad| (measured 1.5e-6 dense,
  3.6e-6 ssm);
* the train step over 3 steps at M = 4: masks and ``num_positive``
  equal, or apart only at a float32 tie (ROADMAP F5: the two masks' group
  entropies, in float64 on the port's soft labels, closer than float32's
  spacing at the entropy); loss and entropy within 1e-5; params within
  ``PARAMS_RTOL`` = 1e-5 of max |value| per leaf (measured 1.7e-7).
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.core import distributed as jdist
from repro.data.synthetic import make_token_dataset as jax_tokens
from repro.models.api import build_model as jax_build_model
from repro.optim import adamw as jadamw, sgd as jsgd
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.core import distributed as tdist
from repro_torch.core.entropy import group_entropy_np
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.fl import MaxEntropyJudge
from repro_torch.launch.train import batch_extras, build_fl_corpus
from repro_torch.models.api import build_model
from repro_torch.optim import adamw, sgd

OPT_RTOL = 1e-6
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-5
PARAMS_RTOL = 1e-5
ARCH_CASES = ["qwen3-0.6b", "mamba2-130m", "internvl2-1b",
              "whisper-large-v3"]


def _extras(cfg, b: int) -> dict:
    """The zero patches or frames of the vlm and encdec families
    (``train.batch_extras``, as the reference's adapters give them), as
    numpy; none for the others."""
    return {k: v.numpy() for k, v in batch_extras(cfg, b, "cpu").items()}


@pytest.fixture(scope="module")
def lm():
    """arch -> (JAX model, its params, port model with the same weights,
    port config), built once per arch."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = JAX_ARCHS[arch].reduced()
            cfg = ARCHS[arch].reduced()
            jm = jax_build_model(jcfg)
            params = jm.init(jax.random.PRNGKey(0))
            model = build_model(cfg, device="cpu", kernels="torch")
            model.net.load_state_dict(lm_params_from_numpy(
                cfg, jax.tree.map(np.asarray, params)))
            built[arch] = (jm, params, model, cfg)
        return built[arch]
    return get


def _leafwise_rel(want_tree, got_tree) -> float:
    """Largest max |diff| / max |want| over the leaves of two trees of
    the same structure."""
    want = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    got = jax.tree_util.tree_flatten_with_path(got_tree)[0]
    assert [p for p, _ in want] == [p for p, _ in got]
    worst = 0.0
    for (_, a), (_, b) in zip(want, got):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert a.shape == b.shape
        worst = max(worst, float(np.abs(a - b).max()
                                 / max(np.abs(a).max(), 1e-30)))
    return worst


def _tokens(cfg, m, per, s, seed=0):
    """Client-major (m * per, s) int32 windows, client i from domain i:
    soft labels that differ, so the judge removes someone."""
    corpus, idx = build_fl_corpus(cfg, m, "case1", s - 1, seed)
    rng = np.random.default_rng(seed)
    return np.concatenate([corpus[rng.choice(idx[i], per)]
                           for i in range(m)]).astype(np.int32)


# ------------------------------------------------------------ optimizers

@pytest.mark.parametrize("kind,kw", [
    ("sgd", dict(lr=0.1, momentum=0.5)),
    ("sgd", dict(lr=0.1, momentum=0.0)),
    ("sgd", dict(lr=0.05, momentum=0.9, weight_decay=0.01)),
    ("adamw", dict(lr=1e-2)),
    ("adamw", dict(lr=1e-2, b1=0.8, b2=0.99, weight_decay=0.1)),
])
def test_optimizers_match_reference(kind, kw):
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.normal(size=(3, 4)).astype(np.float32)},
            "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [jax.tree.map(lambda x: rng.normal(size=x.shape).astype(
        np.float32), tree) for _ in range(5)]
    jopt = (jsgd if kind == "sgd" else jadamw)(**kw)
    topt = (sgd if kind == "sgd" else adamw)(**kw)
    jp = jax.tree.map(jnp.asarray, tree)
    js = jopt.init(jp)
    tp = jax.tree.map(torch.from_numpy, tree)
    ts = topt.init(tp)
    for g in grads:
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(jax.tree.map(torch.from_numpy, g), ts, tp)
    assert _leafwise_rel(jp, jax.tree.map(lambda t: t.numpy(), tp)) \
        <= OPT_RTOL
    assert int(ts["count"]) == int(js["count"]) == 5
    assert ts["count"].dtype == torch.int32
    for name in set(js) - {"count"}:
        assert _leafwise_rel(js[name], jax.tree.map(
            lambda t: t.numpy(), ts[name])) <= OPT_RTOL
        assert all(t.dtype == torch.float32
                   for t in jax.tree.leaves(ts[name]))


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("kw", [
    dict(),
    dict(vocab_size=256, num_domains=4, docs_per_domain=16, seq_len=64,
         seed=3),
    dict(vocab_size=2048, num_domains=5, docs_per_domain=9, seq_len=7,
         seed=11),
])
def test_make_token_dataset_equals_reference(kw):
    x, dom = make_token_dataset(**kw)
    jx, jdom = jax_tokens(**kw)
    assert x.dtype == jx.dtype == np.int32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(dom, jdom)


# ------------------------------------------------------------ loss, grads

@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("arch", ARCH_CASES)
def test_lm_loss_and_model_loss_match_reference(lm, arch, weighted):
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr
    jm, params, model, cfg = lm(arch)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    batch = {"tokens": toks, **_extras(cfg, 2)}
    if weighted:
        batch["loss_weights"] = rng.random((2, 24)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    jloss, jlogits = jm.loss(params, jbatch)
    with torch.no_grad():
        tloss, tlogits = model.loss(model.params(), tbatch)
    assert float(tloss) == pytest.approx(float(jloss), abs=LOSS_ATOL)
    direct = ttr.lm_loss(cfg, tlogits, tbatch["tokens"],
                         tbatch.get("loss_weights"))
    want = jtr.lm_loss(jm.cfg, jnp.asarray(tlogits.numpy()),
                       jbatch["tokens"], jbatch.get("loss_weights"))
    assert float(direct) == pytest.approx(float(want), abs=LOSS_ATOL)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("arch", ARCH_CASES)
def test_model_loss_grads_match_reference_per_leaf(lm, arch):
    jm, params, model, cfg = lm(arch)
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    batch = {"tokens": toks, **_extras(cfg, 2)}
    jgrads = jax.jit(jax.grad(lambda p: jm.loss(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0]))(params)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in model.params().items()}
    loss, _ = model.loss(leaves, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    got = lm_params_to_numpy(cfg, dict(zip(leaves, grads)))
    want = jax.tree.map(np.asarray, jgrads)
    if cfg.attn_bias and cfg.rope_style == "none":
        _check_zero_grad_leaves(want, got)
    worst = _leafwise_rel(want, got)
    assert worst <= GRAD_RTOL, worst


def _check_zero_grad_leaves(want: dict, got: dict) -> None:
    """Takes the key projection's bias (``w_k.b``, whisper's
    ``attn_bias``) out of both gradient trees, after holding it
    absolutely. Without RoPE the bias adds q . b to every score of a
    query, which the softmax does not see, so its gradient is 0 in exact
    arithmetic and
    both packages give rounding noise (about 1e-9 against leaves of about
    1e-2): a ratio to the leaf's own max |grad| compares noise with noise.
    Both sides must lie within GRAD_RTOL of the largest |grad| of the
    model."""
    scale = max(float(np.abs(x).max()) for x in jax.tree.leaves(want))
    for tw, tg in _walk(want, got):
        if "w_k" in tw and "b" in tw["w_k"]:
            for t in (tw, tg):
                zero = t["w_k"].pop("b")
                assert np.abs(zero).max() <= GRAD_RTOL * scale


def _walk(a: dict, b: dict):
    """Pairs of the same subtree of two trees of dicts."""
    yield a, b
    for k, v in a.items():
        if isinstance(v, dict):
            yield from _walk(v, b[k])


# ------------------------------------------------------------ train step

def _tie_or_equal(mask, want_mask, soft, sizes, entropy):
    """Masks equal, or apart at a float32 tie: their group entropies in
    float64 on the port's soft labels closer than float32's spacing at
    the entropy (ROADMAP F5)."""
    if np.array_equal(mask, want_mask):
        return
    p, s = soft.double().numpy(), sizes.double().numpy()
    gap = abs(group_entropy_np(p, s, mask) - group_entropy_np(
        p, s, want_mask))
    assert gap < np.spacing(np.float32(entropy)), (mask, want_mask, gap)


@pytest.mark.parametrize("enabled", [True, False])
def test_train_step_matches_reference(lm, enabled):
    jm, params, model, cfg = lm("qwen3-0.6b")
    m = 4
    toks = _tokens(cfg, m, 2, 17)
    fed_kw = dict(num_clients=m, enabled=enabled)
    jopt, topt = jsgd(lr=0.1, momentum=0.5), sgd(lr=0.1, momentum=0.5)
    jstep = jax.jit(jdist.make_train_step(jm, jopt, jdist.FedSpec(**fed_kw)))
    seen = []

    def judge_fn(soft, sizes):
        seen.append((soft.clone(), sizes.clone()))
        return MaxEntropyJudge("torch").traced()(soft, sizes)

    tstep = tdist.make_train_step(model, topt, tdist.FedSpec(**fed_kw),
                                  judge_fn=judge_fn)
    jp, js = params, jopt.init(params)
    tp = {k: v.detach() for k, v in model.params().items()}
    ts = topt.init(tp)
    removed = 0
    for it in range(3):
        jp, js, jmet = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tmet = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        assert set(tmet) == set(jmet)
        mask, want = tmet["mask"].numpy(), np.asarray(jmet["mask"])
        if enabled:
            _tie_or_equal(mask, want, *seen[it], float(jmet["entropy"]))
        else:
            np.testing.assert_array_equal(mask, np.ones(m, np.float32))
        assert int(tmet["num_positive"]) == int(mask.sum())
        removed += m - int(mask.sum())
        for key in ("loss", "entropy", "entropy_initial", "grad_norm"):
            assert float(tmet[key]) == pytest.approx(
                float(jmet[key]), abs=LOSS_ATOL, rel=LOSS_ATOL), key
        np.testing.assert_allclose(tmet["per_client_loss"].numpy(),
                                   np.asarray(jmet["per_client_loss"]),
                                   atol=LOSS_ATOL)
    assert removed > 0 if enabled else removed == 0
    assert _leafwise_rel(jax.tree.map(np.asarray, jp),
                         lm_params_to_numpy(cfg, tp)) <= PARAMS_RTOL


def test_fedspec_disabled_keeps_all_clients(lm):
    _, _, model, cfg = lm("qwen3-0.6b")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    opt = sgd()
    params = {k: v.detach() for k, v in model.params().items()}
    step = tdist.make_train_step(model, opt, tdist.FedSpec(
        num_clients=4, enabled=False))
    _, _, metrics = step(params, opt.init(params), {"tokens": toks})
    assert int(metrics["num_positive"]) == 4


def test_client_sizes_weight_the_loss(lm):
    """Bigger clients pull the aggregate toward their loss (Eq. 4)."""
    _, _, model, cfg = lm("qwen3-0.6b")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 16)).astype(np.int32))
    opt = sgd()
    params = {k: v.detach() for k, v in model.params().items()}
    step = tdist.make_train_step(model, opt, tdist.FedSpec(
        num_clients=2, enabled=False))
    _, _, m1 = step(params, opt.init(params),
                    {"tokens": toks, "client_sizes": torch.tensor([1., 1.])})
    _, _, m2 = step(params, opt.init(params),
                    {"tokens": toks,
                     "client_sizes": torch.tensor([100., 1.])})
    pc = m1["per_client_loss"].numpy()
    expect = (100 * pc[0] + pc[1]) / 101
    assert float(m2["loss"]) == pytest.approx(expect, rel=1e-4)


def test_chunked_head_stats_match_dense_and_reference(lm):
    jm, params, model, cfg = lm("qwen3-0.6b")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 20)).astype(np.int32)
    t = torch.from_numpy(toks)
    with torch.no_grad():
        h, _ = model.apply_hidden(model.params(), {"tokens": t})
        pcl, soft = tdist.chunked_head_stats(
            cfg, tdist._tok_params(model.params()), h, t, 2, seq_chunk=8)
        logits, _ = model.apply(model.params(), {"tokens": t})
    np.testing.assert_allclose(
        pcl.numpy(), tdist._per_client_loss(cfg, logits, t, 2).numpy(),
        rtol=1e-5)
    np.testing.assert_allclose(
        soft.numpy(), tdist.per_client_soft_labels(logits, 2).numpy(),
        atol=1e-6)
    jh, _ = jm.hidden(params, {"tokens": jnp.asarray(toks)})
    jpcl, jsoft = jdist.chunked_head_stats(
        jm.cfg, params["tok"], jh, jnp.asarray(toks), 2, seq_chunk=8)
    np.testing.assert_allclose(pcl.numpy(), np.asarray(jpcl), rtol=1e-5)
    np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft), atol=1e-6)


def test_chunked_head_step_matches_dense_step(lm):
    """The chunked head (recomputed per chunk in the backward) gives the
    dense step's mask, loss and update."""
    _, _, model, cfg = lm("qwen3-0.6b")
    toks = torch.from_numpy(_tokens(cfg, 4, 2, 17))
    opt = sgd(lr=0.1, momentum=0.5)
    params = {k: v.detach() for k, v in model.params().items()}
    out = []
    for chunked in (False, True):
        step = tdist.make_train_step(model, opt, tdist.FedSpec(
            num_clients=4, chunked_head=chunked, seq_chunk=5))
        out.append(step(params, opt.init(params), {"tokens": toks}))
    (p1, _, m1), (p2, _, m2) = out
    assert torch.equal(m1["mask"], m2["mask"])
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=5e-6)


def test_microbatched_step_matches_full_batch(lm):
    """The two-phase microbatched round gives the fused step's mask and
    update."""
    _, _, model, cfg = lm("qwen3-0.6b")
    m, per, s = 4, 4, 16
    toks = torch.from_numpy(_tokens(cfg, m, per, s))
    opt = sgd(lr=1.0, momentum=0.0)
    fed = tdist.FedSpec(num_clients=m)
    params = {k: v.detach() for k, v in model.params().items()}
    p1, _, m1 = tdist.make_train_step(model, opt, fed)(
        params, opt.init(params), {"tokens": toks})
    p2, _, m2 = tdist.make_microbatched_train_step(model, opt, fed, 2)(
        params, opt.init(params), {"tokens": toks})
    assert torch.equal(m1["mask"], m2["mask"])
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for k in p1:
        torch.testing.assert_close(p1[k], p2[k], rtol=0, atol=5e-6)


def test_serve_steps_roundtrip(lm):
    _, _, model, cfg = lm("mamba2-130m")
    prefill_step, decode_step = tdist.make_serve_steps(model)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    logits, cache = prefill_step({"tokens": toks})
    lg, cache = decode_step(cache, torch.zeros((2, 1), dtype=torch.int32))
    assert lg.shape == (2, 1, cfg.padded_vocab)
    assert int(cache["index"]) == 9
