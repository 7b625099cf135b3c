"""The blockwise attention route against the live JAX reference:
``kernels.ref.mha_blockwise`` against the reference's
``ref.mha_blockwise`` and against both packages' ``mha_reference``, on
values and on the gradients of q, k and v; ``ops.attention(...,
backend="blockwise")`` switching at more than 512 keys as the
reference's ``ops.attention`` does; the rest of the route (SSD, judge,
aggregation) equal to the ``"torch"`` route's; and a whisper model with
1,500 frames built with ``kernels="blockwise"`` against the reference's
under ``set_default_backend("blockwise")``.

Inputs are float32 normals from numpy seeds. Tolerances, stated:

* values within ``VAL_ATOL`` = 2e-6 (outputs of about 1; the online
  softmax sums in another order than the one-pass softmax, and the two
  packages' float32 ``exp`` part in the last bit);
* gradients within ``GRAD_ATOL`` = 1e-5 of the leaf's max |grad| (about
  1), for the same reasons through the backward;
* the model's loss within 1e-5 and its gradients per leaf within
  ``GRAD_RTOL`` = 1e-5 of the leaf's max |grad| (``test_torch_train``'s
  bounds).
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.api import build_model as jax_build_model
from repro_torch.configs import ARCHS
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.launch.train import batch_extras
from repro_torch.models.api import build_model

VAL_ATOL = 2e-6
GRAD_ATOL = 1e-5
GRAD_RTOL = 1e-5

# (B, S, H, KH, D, T, causal, window, q_offset, tags): ``tags`` "ring"
# gives (B, T) kv positions with -1 slots (every query still sees a
# key); q_offset "rows" one offset a row
CASES = {
    "T513-self-causal-gqa": (1, 513, 4, 2, 16, 513, True, 0, 0, None),
    "T1024-cross": (2, 64, 2, 2, 16, 1024, False, 0, 0, None),
    "T1500-encoder": (1, 1500, 2, 1, 8, 1500, False, 0, 0, None),
    "T1500-window-offset": (1, 16, 4, 1, 16, 1500, True, 700, 1484, None),
    "T1024-tags-rows-window": (2, 4, 4, 2, 16, 1024, True, 600, "rows",
                               "ring"),
}


def _inputs(b, s, h, kh, d, t, q_offset, tags, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32) for shape in (
        (b, s, h, d), (b, t, kh, d), (b, t, kh, d)))
    off = (np.array([t - s, t - s - 37][:b], np.int32) if q_offset == "rows"
           else q_offset)
    pos = None
    if tags == "ring":
        # a ring of T slots written up to each row's last position, the
        # slots past it empty (-1) and a stretch in the middle evicted
        pos = np.tile(np.arange(t, dtype=np.int32), (b, 1))
        pos[:, 300:700] = -1
        pos[:, t - 20:] = -1
    cot = rng.standard_normal((b, s, h, d)).astype(np.float32)
    return q, k, v, off, pos, cot


def _port(fn, q, k, v, off, pos, cot, **kw):
    """(out, (dq, dk, dv)) of the port's ``fn`` with cotangent ``cot``."""
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = fn(qt, kt, vt, q_offset=(torch.from_numpy(off)
                                   if isinstance(off, np.ndarray) else off),
             kv_positions=None if pos is None else torch.from_numpy(pos),
             **kw)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(cot))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _ref(fn, q, k, v, off, pos, cot, **kw):
    def f(q, k, v):
        return fn(q, k, v, q_offset=jnp.asarray(off),
                  kv_positions=None if pos is None else jnp.asarray(pos),
                  **kw)
    out, vjp = jax.vjp(jax.jit(f), *(jnp.asarray(x) for x in (q, k, v)))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(cot))]


def _close_grads(got, want):
    for g, w in zip(got, want):
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_ATOL, err


@pytest.mark.parametrize("case", list(CASES))
def test_mha_blockwise_matches_reference(case):
    b, s, h, kh, d, t, causal, window, q_offset, tags = CASES[case]
    q, k, v, off, pos, cot = _inputs(b, s, h, kh, d, t, q_offset, tags)
    kw = dict(causal=causal, window=window)
    out, grads = _port(ref.mha_blockwise, q, k, v, off, pos, cot, **kw)
    assert out.shape == (b, s, h, d) and np.isfinite(out).all()
    want, want_g = _ref(jref.mha_blockwise, q, k, v, off, pos, cot, **kw)
    np.testing.assert_allclose(out, want, rtol=0, atol=VAL_ATOL)
    _close_grads(grads, want_g)
    # every query sees a key here, so both packages' one-pass softmax
    # gives the same function
    for label, plain in (
            ("port", _port(ref.mha_reference, q, k, v, off, pos, cot, **kw)),
            ("ref", _ref(jref.mha_reference, q, k, v, off, pos, cot,
                         **kw))):
        np.testing.assert_allclose(out, plain[0], rtol=0, atol=VAL_ATOL,
                                   err_msg=label)
        _close_grads(grads, plain[1])


def test_mha_blockwise_query_without_keys_matches_reference():
    """A query that sees no key (every slot of its row -1) averages all
    the padded values, the reference's blockwise as well: not
    ``mha_reference``'s function there, but the reference's."""
    q, k, v, off, pos, cot = _inputs(2, 3, 2, 2, 8, 700, 0, "ring", seed=1)
    pos[1] = -1
    out, grads = _port(ref.mha_blockwise, q, k, v, off, pos, cot,
                       causal=False)
    want, want_g = _ref(jref.mha_blockwise, q, k, v, off, pos, cot,
                        causal=False)
    np.testing.assert_allclose(out, want, rtol=0, atol=VAL_ATOL)
    _close_grads(grads, want_g)
    padded_mean = np.pad(v[1], ((0, 324), (0, 0), (0, 0))).mean(0)
    np.testing.assert_allclose(out[1], np.broadcast_to(
        padded_mean[None], out[1].shape), rtol=0, atol=VAL_ATOL)


@pytest.mark.parametrize("t", [256, 512, 513, 1500])
def test_blockwise_route_switches_above_512_keys(t):
    """``ops.attention(backend="blockwise")`` is ``mha_blockwise`` past
    512 keys and ``mha_reference`` up to 512, bit for bit, as the
    reference's ``ops.attention`` (``k.shape[1] > 512``); the torch route
    stays on ``mha_reference``."""
    q, k, v, _, _, _ = _inputs(1, 8, 2, 1, 8, t, 0, None, seed=2)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got = ops.attention(qt, kt, vt, causal=False, backend="blockwise")
    want = (ref.mha_blockwise if t > 512 else ref.mha_reference)(
        qt, kt, vt, causal=False)
    assert torch.equal(got, want)
    assert torch.equal(ops.attention(qt, kt, vt, causal=False),
                       ref.mha_reference(qt, kt, vt, causal=False))
    jgot = jops.attention(*(jnp.asarray(x) for x in (q, k, v)),
                          causal=False, backend="blockwise")
    jwant = (jref.mha_blockwise if t > 512 else jref.mha_reference)(
        *(jnp.asarray(x) for x in (q, k, v)), causal=False)
    np.testing.assert_array_equal(np.asarray(jgot), np.asarray(jwant))


def test_blockwise_route_is_the_torch_route_elsewhere():
    """The SSD, the judge's loop and sweep and the aggregation take the
    plain versions on the blockwise route, as on ``"torch"``."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 16, 2, 4), np.float32))
    dt = torch.from_numpy(rng.random((1, 16, 2), np.float32))
    a = -torch.from_numpy(rng.random(2, np.float32))
    bm = torch.from_numpy(rng.standard_normal((1, 16, 1, 4), np.float32))
    for want, got in zip(ops.ssd(x, dt, a, bm, bm, chunk=8),
                         ops.ssd(x, dt, a, bm, bm, chunk=8,
                                 backend="blockwise")):
        assert torch.equal(got, want)
    soft = torch.softmax(torch.from_numpy(
        rng.standard_normal((6, 10), np.float32)), -1)
    sizes = torch.ones(6)
    # the packed buffer's -1 pad reads as NaN: compare the bits
    assert torch.equal(ops.entropy_judge_loop(soft, sizes).view(torch.int32),
                       ops.entropy_judge_loop(
                           soft, sizes, backend="blockwise").view(torch.int32))
    mask = torch.ones(6, dtype=torch.bool)
    for want, got in zip(ops.entropy_judge_sweep(soft, sizes, mask),
                         ops.entropy_judge_sweep(soft, sizes, mask,
                                                 backend="blockwise")):
        assert torch.equal(got, want)
    flat, w = torch.randn(6, 40), torch.rand(6)
    assert torch.equal(ops.masked_weighted_sum(flat, w),
                       ops.masked_weighted_sum(flat, w, backend="blockwise"))


@pytest.fixture
def jax_blockwise():
    jops.set_default_backend("blockwise")
    yield
    jops.set_default_backend("xla")


def test_whisper_on_the_blockwise_route_matches_reference(jax_blockwise):
    """Reduced whisper-large-v3 over 1,500 frames (the published
    ``encoder_seq``), so the encoder's self attention and the decoder's
    cross attention take the blockwise route: the loss and every
    gradient against the reference's model under
    ``set_default_backend("blockwise")``, with ``remat="full"``."""
    over = dict(encoder_seq=1500, remat="full")
    jcfg = JAX_ARCHS["whisper-large-v3"].reduced().replace(**over)
    cfg = ARCHS["whisper-large-v3"].reduced().replace(**over)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    model = build_model(cfg, device="cpu", kernels="blockwise")
    model.net.load_state_dict(lm_params_from_numpy(
        cfg, jax.tree.map(np.asarray, params)))
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (1, 12)).astype(np.int32)
    batch = {"tokens": toks, **{k: v.numpy() for k, v in batch_extras(
        cfg, 1, "cpu").items()}}
    batch["frames"] = np.random.default_rng(5).standard_normal(
        batch["frames"].shape).astype(np.float32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm.loss(p, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True))(params)
    leaves = {k: v.detach().requires_grad_(True)
              for k, v in model.params().items()}
    loss, _ = model.loss(leaves, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert float(loss) == pytest.approx(float(jloss), abs=1e-5)
    got = jax.tree_util.tree_flatten_with_path(
        lm_params_to_numpy(cfg, dict(zip(leaves, grads))))[0]
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jgrads))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    scale = max(float(np.abs(w).max()) for _, w in want)
    for (path, g), (_, w) in zip(got, want):
        if "w_k" in jax.tree_util.keystr(path) and \
                jax.tree_util.keystr(path).endswith("['b']"):
            # 0 in exact arithmetic without RoPE (test_torch_train)
            assert np.abs(g).max() <= GRAD_RTOL * scale
            continue
        err = np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= GRAD_RTOL, (jax.tree_util.keystr(path), err)
