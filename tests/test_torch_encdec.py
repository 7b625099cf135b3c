"""The port's ``encdec`` family (``repro_torch.models.encdec``) and its
config, whisper-large-v3, against the live JAX reference, on the CPU, at
``reduced()`` sizes (2 encoder and 2 decoder layers, d_model 256, 32
frames), with the checks of ``tests/test_torch_vlm.py``: the config, the
weights both ways (``enc_layers`` and ``dec_layers`` stacked), ``forward``,
serve on the reference's ``xla`` and ``pallas`` routes with the cross K
and V in the cache, ``serve.main`` against the reference's, the training
adapters with zero frames and the microbatched step splitting them.
Besides: the sinusoidal positions against the reference's, and a ring
cache of the self KV decoded from empty beside the cross cache.

    PYTHONPATH=src JAX_PLATFORMS=cpu python -m pytest -q tests/test_torch_encdec.py
"""
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jax_encdec
from repro_torch.models import encdec
from test_torch_vlm import (  # noqa: F401  (jax_backend: a fixture)
    LOGIT_ATOL, build_reference, check_adapters, check_config,
    check_forward, check_microbatched_step, check_params, check_serve,
    check_serve_entry_point, jax_backend, port_model)

ARCH = "whisper-large-v3"


@pytest.fixture(scope="module")
def reference():
    return build_reference(ARCH)


def test_config_equals_reference():
    check_config(ARCH)


def test_params_carry_over_key_for_key(reference):
    check_params(reference, {"enc_layers": 2, "dec_layers": 2})
    _, _, tree, tcfg, _ = reference
    model = port_model(tcfg, tree)
    assert model.net.dec_layers[0].xattn.q_norm is None
    np.testing.assert_array_equal(
        model.net.dec_layers[1].xattn.w_k.b.detach().numpy(),
        tree["dec_layers"]["xattn"]["w_k"]["b"][1])


@pytest.mark.parametrize("dim", [1280, 256, 2])
def test_sinusoidal_matches_reference(dim):
    """At whisper's 1,500 positions. Both packages take the exponent
    -ln(10000) k / max(half - 1, 1) in float32, but their float32 ``exp``
    parts from the other's in the last bit for some k (at dim 256 on the
    CPU, 14 of the reference's 128 and 2 of the port's are not the
    correctly rounded value),
    so each entry is held to what one spacing of the frequency makes at
    its position: pos x spacing(freq), plus one spacing of the float32
    angle, plus one of sin or cos."""
    pos = np.arange(1500, dtype=np.int32)
    want = np.asarray(jax_encdec.sinusoidal(jnp.asarray(pos), dim))
    got = encdec.sinusoidal(torch.from_numpy(pos), dim).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    half = dim // 2
    freq = np.exp(-np.float32(np.log(10000.0)) * np.arange(
        half, dtype=np.float32) / max(half - 1, 1)).astype(np.float32)
    ang = pos[:, None].astype(np.float32) * freq
    bound = pos[:, None] * np.spacing(freq) + np.spacing(ang) + 2.0 ** -23
    err = np.abs(got - want)
    assert (err <= np.concatenate([bound, bound], axis=1)).all(), err.max()


def test_forward_matches_reference(reference):
    check_forward(reference)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_serve_matches_reference(reference, jax_backend, backend):
    jax_backend(backend)
    check_serve(reference)


def test_cache_holds_the_encoders_kv(reference):
    """The prefill's cross K and V are each decoder layer's projection of
    the encoder output, (L, B, T_enc, KH, hd) as the reference's, and a
    decode step leaves them as they were."""
    jm, params, tree, tcfg, batch = reference
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, jcache = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=16))(
        params, jbatch)
    model = port_model(tcfg, tree)
    _, cache = model.prefill({k: torch.from_numpy(v)
                              for k, v in batch.items()}, cache_len=16)
    shape = (tcfg.num_layers, 2, tcfg.encoder_seq, tcfg.num_kv_heads,
             tcfg.head_dim)
    before = {}
    for n in ("k", "v"):
        assert tuple(cache["cross"][n].shape) == shape
        np.testing.assert_allclose(cache["cross"][n].numpy(),
                                   np.asarray(jcache["cross"][n]), rtol=0,
                                   atol=LOGIT_ATOL)
        before[n] = cache["cross"][n].clone()
    model.decode_step(cache, torch.zeros((2, 1), dtype=torch.int64))
    for n in ("k", "v"):
        assert torch.equal(cache["cross"][n], before[n])
    assert cache["index"] == 13 and cache["pos"].tolist()[:14] == \
        list(range(13)) + [-1]


def test_ring_buffer_decode_matches_reference(reference):
    """A self-KV ring of exactly the window, decoded from empty beside a
    prefilled cross cache, against the reference's ring decode."""
    jm, params, tree, tcfg, batch = reference
    w, steps = 6, 10
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    _, full = jax.jit(lambda p, b: jm.prefill(p, b, cache_len=16))(
        params, jbatch)
    jcache = jm.init_cache(2, w)
    jcache["cross"] = full["cross"]
    model = port_model(tcfg, tree)
    cache = model.init_cache(2, w)
    _, pcache = model.prefill({k: torch.from_numpy(v)
                               for k, v in batch.items()}, cache_len=16)
    cache["cross"] = pcache["cross"]
    toks = batch["tokens"][:, :steps]
    step = jax.jit(lambda p, c, t: jm.decode_step(p, c, t, window=w))
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


def test_serve_entry_point_matches_reference(reference, tmp_path,
                                             monkeypatch, capsys):
    check_serve_entry_point(reference, ARCH, tmp_path, monkeypatch, capsys)


def test_training_adapters_match_reference(reference):
    check_adapters(reference)


def test_microbatched_step_splits_the_frames(reference):
    check_microbatched_step(reference)
