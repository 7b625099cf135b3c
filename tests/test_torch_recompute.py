"""The recompute under ``torch.func`` (``kernels.ref.recomputed``,
``models.layers.remat``) inside lmstep's client program, on the CPU at
``reduced()`` sizes, one config a family (dense, moe, ssm, hybrid, vlm,
encdec).

* Under lmstep's ``vmap`` of a gradient, ``cfg.remat`` ``"full"`` and
  ``"dots"`` give the first local step's gradients, a round's record and
  the global params bit-equal to ``"none"``'s; the client program's peak
  live bytes (``launch.cost_analysis.CostCounter``) are strictly lower
  under ``"full"`` and no higher under ``"dots"`` (which recomputes as
  ``"full"`` under a transform; encdec's decoder checkpoints under
  ``"full"`` only, as the reference's).
* lmstep under ``remat="full"`` against the reference's lmstep under the
  same remat (``jax.checkpoint`` inside its ``vmap(grad)``) on converted
  params: integer records exact, entropy within 1e-6, params digest
  within a relative 1e-6 (``tests/test_torch_lmstep.py``'s policy).
* The blockwise route: ``ref.mha_blockwise``'s key blocks under the
  client program's ``vmap`` of a gradient against the reference's
  (``jax.vmap(jax.grad)``, its blocks under ``jax.checkpoint``) within
  ``GRAD_RTOL``; lmstep on the ``"blockwise"`` route (the route's key
  block cut to 4 so reduced windows reach it) bit-equal between
  ``"full"`` and ``"none"``.
* A transform the recompute cannot take (``jvp``, ``functionalize``, a
  ``grad`` inside a ``grad``, ``vmap`` inside plain autograd) raises,
  naming it.
* No recomputed body draws random numbers (the RNG state is not saved):
  every family's forward and backward under "full" runs under a
  dispatch mode that raises on a draw.
* The gradient lmstep takes (``fl.strategies.pulled_grad``, through
  ``vjp``) equals ``torch.func.grad``'s bit for bit.

Run as a script, it prints the peaks of the client program at the
reduced dense, vlm and encdec configs under each remat mode and each
gradient form (``grad`` and ``pulled_grad``)::

    PYTHONPATH=src python tests/test_torch_recompute.py
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
from functools import partial

import numpy as np
import pytest
import torch
from torch.func import functionalize, grad, jvp, vmap
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.fl as tfl
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy
from repro_torch.fl import strategies
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.launch.cost_analysis import CostCounter
from repro_torch.models.api import build_model
from repro_torch.models.transformer import token_nll

FAMILIES = {"dense": "qwen3-0.6b", "moe": "qwen3-moe-235b-a22b",
            "ssm": "mamba2-130m", "hybrid": "zamba2-2.7b",
            "vlm": "internvl2-1b", "encdec": "whisper-large-v3"}
MODES = ["full", "dots"]
CLIENTS, SAMPLES, SEQ = 4, 4, 12
GRAD_RTOL = 1e-5
ENT_ATOL, DIGEST_RTOL = 1e-6, 1e-6
INT_KEYS = ("round", "selected", "positive", "negative")


def _local():
    return tfl.LocalSpec(epochs=1, lr=0.01, batch_size=2)


def _data(cfg):
    corpus, idx = train.build_fl_corpus(cfg, 2 * CLIENTS, "case1", SEQ, 0)
    return train.stack_lm_clients(corpus, idx, SAMPLES, SEQ, 0)


def _model(cfg, state, remat, kernels="torch"):
    model = build_model(cfg.replace(remat=remat), device="cpu",
                        kernels=kernels)
    model.net.load_state_dict(state)
    return model


def _nll(apply_fn):
    def nll(p, bx, bw):
        logits, _ = apply_fn(p, bx)
        tok, _ = token_nll(logits, bx[:, 1:])
        return (tok.mean(dim=-1) * bw).sum() / bw.sum().clamp(min=1e-12)
    return nll


def lmstep_run(cfg, state, remat, kernels="torch"):
    """(first local step's gradients, round 0's record, global params,
    peak bytes of the client program above its arguments) of lmstep on
    the sequential server, cohort of CLIENTS."""
    model = _model(cfg, state, remat, kernels)
    apply_fn = train.lm_window_apply(model, cfg)
    data = _data(cfg)
    params = {k: v.detach() for k, v in model.params().items()}
    x = torch.as_tensor(data["x"][:CLIENTS, :2])
    w = torch.as_tensor(data["w"][:CLIENTS, :2])
    grads = vmap(strategies.pulled_grad(_nll(apply_fn)),
                 in_dims=(None, 0, 0))(params, x, w)
    client = strategies.LMWindowStrategy(_local()).make_client_fn(apply_fn)
    cohort = {k: torch.as_tensor(v[:CLIENTS]) for k, v in data.items()}
    counter = CostCounter()
    counter.track((params, cohort))
    with counter:
        client(params, cohort, None, None, None)
    server = tfl.build(
        "fedentropy", apply_fn, params, data,
        tfl.ServerConfig(num_clients=2 * CLIENTS, participation=0.5,
                         seed=0), _local(), strategy="lmstep", device="cpu")
    rec = server.round()
    return (grads, rec, server.global_params,
            counter.peak_bytes - counter.argument_bytes)


@pytest.fixture(scope="module")
def family():
    """fam -> (port reduced config, its seeded weights, the "none"
    run), built once per family."""
    built = {}

    def get(fam):
        if fam not in built:
            cfg = ARCHS[FAMILIES[fam]].reduced()
            state = build_model(cfg, device="cpu", kernels="torch"
                                ).net.state_dict()
            built[fam] = (cfg, state, lmstep_run(cfg, state, "none"))
        return built[fam]
    return get


def _assert_equal(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_lmstep_remat_equals_none_bit_for_bit(family, fam, mode):
    cfg, state, (g0, r0, p0, peak0) = family(fam)
    g1, r1, p1, peak1 = lmstep_run(cfg, state, mode)
    _assert_equal(g1, g0)
    assert r1 == r0
    _assert_equal(p1, p0)
    if fam == "encdec" and mode == "dots":
        assert peak1 == peak0        # the reference's decoder: "full" only
    elif mode == "dots":
        assert peak1 <= peak0, (peak1, peak0)
    else:
        assert peak1 < peak0, (peak1, peak0)


def test_pulled_grad_equals_grad(family):
    cfg, state, _ = family("hybrid")
    model = _model(cfg, state, "full")
    apply_fn = train.lm_window_apply(model, cfg)
    params = {k: v.detach() for k, v in model.params().items()}
    data = _data(cfg)
    x, w = (torch.as_tensor(data[k][:CLIENTS, :2]) for k in ("x", "w"))
    nll = _nll(apply_fn)
    per_client = {k: v.expand(CLIENTS, *v.shape).clone()
                  for k, v in params.items()}
    for p, dims in ((params, (None, 0, 0)), (per_client, (0, 0, 0))):
        _assert_equal(vmap(strategies.pulled_grad(nll), in_dims=dims)(
            p, x, w), vmap(grad(nll), in_dims=dims)(p, x, w))


# ---------------------------------------------------------- the reference

@pytest.fixture(scope="module")
def jref():
    jax = pytest.importorskip("jax")
    import repro.fl as rfl
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.launch import train as jtrain
    from repro.models.api import build_model as jbuild
    return jax, rfl, jtrain, JAX_ARCHS, jbuild


def _digest(leaves) -> float:
    return sum(float(np.abs(np.asarray(x, np.float64)).sum())
               for x in leaves)


@pytest.mark.parametrize("fam", ["dense", "encdec"])
def test_lmstep_remat_full_matches_reference(jref, fam):
    jax, rfl, jtrain, jarchs, jbuild = jref
    arch = FAMILIES[fam]
    jm = jbuild(jarchs[arch].reduced().replace(remat="full"))
    params = jm.init(jax.random.PRNGKey(0))
    cfg = ARCHS[arch].reduced()
    model = _model(cfg, lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)), "full")
    data = _data(cfg)

    def run(fl, apply_fn, p, d, **kw):
        server = fl.build(
            "fedentropy", apply_fn, p, d,
            fl.ServerConfig(num_clients=2 * CLIENTS, participation=0.5,
                            seed=0), fl.LocalSpec(epochs=1, lr=0.01,
                                                  batch_size=2),
            strategy="lmstep", **kw)
        for _ in range(2):
            server.round()
        return server

    want = run(rfl, jtrain.lm_window_apply(jm, jm.cfg), params,
               {k: jax.numpy.asarray(v) for k, v in data.items()})
    got = run(tfl, train.lm_window_apply(model, model.cfg),
              {k: v.detach() for k, v in model.params().items()}, data,
              device="cpu")
    for x, y in zip(got.history, want.history, strict=True):
        for key in INT_KEYS:
            assert x[key] == y[key], (x["round"], key)
        assert x["comm"]["total_bytes"] == y["comm"]["total_bytes"]
        assert x["entropy"] == pytest.approx(y["entropy"], abs=ENT_ATOL)
    assert _digest(t.numpy() for t in got.global_params.values()) == \
        pytest.approx(_digest(jax.tree.leaves(want.global_params)),
                      rel=DIGEST_RTOL)


# ------------------------------------------------------------ blockwise

def test_blockwise_blocks_under_vmap_grad_match_reference(jref):
    jax = jref[0]
    from repro.kernels import ref as jkref
    rng = np.random.default_rng(0)
    m, b, s, h, kh, d = 3, 2, 9, 4, 2, 8
    q, k, v = (rng.normal(size=(m, b, s, n, d)).astype(np.float32)
               for n in (h, kh, kh))
    r = rng.normal(size=(m, b, s, h, d)).astype(np.float32)

    def loss(attn, qkv, rr):
        return (attn(*qkv, causal=True, block_k=4) * rr).sum()

    want = jax.vmap(jax.grad(partial(loss, jkref.mha_blockwise)))(
        (q, k, v), r)
    got = vmap(strategies.pulled_grad(partial(loss, ref.mha_blockwise)))(
        tuple(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(r))
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w)
        assert float(np.abs(g.numpy() - w).max()) <= \
            GRAD_RTOL * float(np.abs(w).max())


def test_lmstep_on_blockwise_route_full_equals_none(family, monkeypatch):
    """The route's key block cut to 4: every attention of a 12-token
    window runs in 3 recomputed blocks, inside the recomputed layers
    under ``"full"``."""
    monkeypatch.setattr(ref, "BLOCK_K", 4)
    monkeypatch.setitem(ref.mha_blockwise.__kwdefaults__, "block_k", 4)
    calls = []
    blocks = ref._online_block
    monkeypatch.setattr(ref, "_online_block",
                        lambda *a: calls.append(1) or blocks(*a))
    cfg, state, _ = family("dense")
    g0, r0, p0, peak0 = lmstep_run(cfg, state, "none", "blockwise")
    assert calls
    g1, r1, p1, peak1 = lmstep_run(cfg, state, "full", "blockwise")
    _assert_equal(g1, g0)
    assert r1 == r0
    _assert_equal(p1, p0)
    assert peak1 < peak0


# -------------------------------------------------------------- refusals

def _layer(w, x):
    return torch.tanh(torch.tanh(x @ w) @ w)


def test_transforms_it_cannot_take_raise():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(4, 4, generator=g)
    x = torch.randn(3, 5, 4, generator=g)

    def f(w):
        return ref.recomputed(_layer, w, x[0])

    with pytest.raises(NotImplementedError, match="Jvp"):
        jvp(f, (w,), (w,))
    with pytest.raises(NotImplementedError, match="Grad > Grad"):
        grad(lambda u: grad(lambda v: f(v).sum())(u).sum())(w)
    with pytest.raises(NotImplementedError, match="Functionalize"):
        functionalize(f)(w)
    wg = w.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="Vmap inside autograd"):
        vmap(lambda xi: ref.recomputed(_layer, wg, xi))(x)
    with torch.no_grad():                       # serving: plain
        assert torch.equal(vmap(lambda xi: ref.recomputed(_layer, w, xi))(x),
                           vmap(lambda xi: _layer(w, xi))(x))


class _NoDraws(TorchDispatchMode):
    """Raises on an op that draws random numbers (ATen's
    ``nondeterministic_seeded`` tag): ``recomputed`` saves no RNG state,
    so a recomputed body must give the same values twice."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if torch.Tag.nondeterministic_seeded in func.tags:
            raise RuntimeError(f"{func} draws random numbers")
        return func(*args, **(kwargs or {}))


def test_recomputed_body_that_draws_raises():
    """The check below sees a draw inside a recomputed body, in its
    forward and its recompute, under lmstep's transforms and under plain
    autograd."""
    x = torch.ones(3, 4)
    with _NoDraws(), pytest.raises(RuntimeError, match="draws random"):
        grad(lambda t: ref.recomputed(
            lambda u: u * torch.rand_like(u), t).sum())(x)
    with _NoDraws(), pytest.raises(RuntimeError, match="draws random"):
        ref.recomputed(lambda u: u + torch.randn_like(u),
                       x.clone().requires_grad_()).sum().backward()


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_no_recomputed_body_draws(family, fam):
    """Every family's forward and backward under remat "full", under
    lmstep's ``vmap`` of a gradient and under plain autograd (the
    checkpoint), draws no random numbers."""
    cfg, state, _ = family(fam)
    model = _model(cfg, state, "full")
    nll = _nll(train.lm_window_apply(model, cfg))
    params = {k: v.detach() for k, v in model.params().items()}
    data = _data(cfg)
    x, w = (torch.as_tensor(data[k][:CLIENTS, :2]) for k in ("x", "w"))
    with _NoDraws():
        vmap(strategies.pulled_grad(nll), in_dims=(None, 0, 0))(params, x, w)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        nll(leaves, x[0], w[0]).backward()
    assert all(v.grad is not None for v in leaves.values()
               if v.is_floating_point())


# ---------------------------------------------------------------- script

def _peaks(arch: str) -> list[tuple]:
    """(remat, form, peak MiB, equal to grad/"none") of the client
    program at ``arch``'s reduced config."""
    cfg = ARCHS[arch].reduced()
    state = build_model(cfg, device="cpu", kernels="torch").net.state_dict()
    data = {k: torch.as_tensor(v[:CLIENTS]) for k, v in _data(cfg).items()}
    rows, first = [], None
    for remat in ("none", "full", "dots"):
        for form, fn in (("grad", grad), ("pulled_grad",
                                          strategies.pulled_grad)):
            model = _model(cfg, state, remat)
            saved = strategies.pulled_grad
            strategies.pulled_grad = fn
            try:
                client = strategies.LMWindowStrategy(_local()).make_client_fn(
                    train.lm_window_apply(model, cfg))
            finally:
                strategies.pulled_grad = saved
            params = {k: v.detach() for k, v in model.params().items()}
            counter = CostCounter()
            counter.track((params, data))
            with counter:
                out = client(params, data, None, None, None)
            first = first or out
            same = all(torch.equal(out["params"][k], first["params"][k])
                       for k in out["params"]) and torch.equal(
                out["soft_label"], first["soft_label"])
            rows.append((remat, form, (counter.peak_bytes
                                       - counter.argument_bytes) / 2**20,
                         same))
    return rows


if __name__ == "__main__":
    torch.set_num_threads(4)
    print(f"lmstep client program, cohort {CLIENTS}, {SAMPLES} windows of "
          f"{SEQ + 1} tokens, batch 2 (2 local steps), CPU, torch "
          f"{torch.__version__}: peak MiB above the arguments "
          "(CostCounter)")
    for arch in ("qwen3-0.6b", "internvl2-1b", "whisper-large-v3"):
        for remat, form, mib, same in _peaks(arch):
            print(f"{arch:18s} {remat:5s} {form:12s} {mib:9.3f} "
                  f"{'same bits' if same else 'OTHER BITS'}")
