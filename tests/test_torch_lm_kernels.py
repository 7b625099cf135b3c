"""The port's LM kernels (K3 flash attention, K4 decode attention, K5 SSD
chunk scan) against the JAX package's Pallas kernels.

On the CPU each wrapper takes its plain PyTorch version, which is held
here against ``repro.kernels`` run as ``tests/test_kernels.py`` runs it
(``interpret=True``), on the same numpy inputs, at that file's shapes and
tolerances plus Zamba2's head width D = 80. The ``test_card_*`` cases hold
each CUDA kernel against its plain version and skip without a card; they
from _torch_threads import capped_threads  # noqa: F401 (autouse)
import nothing of JAX::

    PYTHONPATH=src python -m pytest -q tests/test_torch_lm_kernels.py -k card
"""
import ctypes
import shutil
import subprocess
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref, ssd_scan
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssd_scan import ssd_chunked

_ATOL = {"float32": 2e-5, "bfloat16": 5e-2}     # tests/test_kernels.py
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def pallas():
    """The JAX package's kernels (imported here, not at the top, so the
    card cases run where JAX is not installed)."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.decode_attention import decode_attention
    from repro.kernels.flash_attention import flash_attention
    from repro.kernels.ssd_scan import ssd_chunked
    return SimpleNamespace(jnp=jnp, flash=flash_attention,
                           decode=decode_attention, ssd=ssd_chunked,
                           ref=jref, ops=jops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _j(pallas, x, dtype="float32"):
    return pallas.jnp.asarray(x, getattr(pallas.jnp, dtype))


def _t(x, dtype="float32"):
    return torch.tensor(np.asarray(x, np.float32), dtype=_TORCH[dtype])


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x, np.float32)


# ------------------------------------------------------------ K3 flash

FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 32),     # GQA 2:1
    (1, 37, 37, 4, 4, 16),     # odd seq (padding path), MHA
    (2, 128, 128, 8, 1, 64),   # MQA
    (1, 16, 80, 4, 2, 32),     # cross-length (q shorter than kv)
    (1, 48, 48, 4, 4, 80),     # Zamba2's head width
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,t,h,kh,d", FLASH_SHAPES)
def test_flash_plain_matches_pallas(pallas, b, s, t, h, kh, d, dtype):
    rng = np.random.default_rng(s * t + d)
    q = rng.normal(size=(b, s, h, d))
    k = rng.normal(size=(b, t, kh, d))
    v = rng.normal(size=(b, t, kh, d))
    causal = s == t
    want = pallas.flash(_j(pallas, q, dtype), _j(pallas, k, dtype),
                        _j(pallas, v, dtype), causal=causal, block_q=16,
                        block_k=16)
    before = flash_attention.launches
    got = flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                          causal=causal)
    assert flash_attention.launches == before      # CPU: no kernel
    assert got.dtype == _TORCH[dtype] and got.shape == (b, s, h, d)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_ATOL[dtype],
                               rtol=1e-2)


@pytest.mark.parametrize("window,d", [(8, 32), (24, 32), (64, 32),
                                      (24, 80)])
def test_flash_window_plain_matches_pallas(pallas, window, d):
    b, s, h = 2, 64, 4
    rng = np.random.default_rng(window + d)
    q = rng.normal(size=(b, s, h, d))
    k = rng.normal(size=(b, s, 2, d))
    v = rng.normal(size=(b, s, 2, d))
    want = pallas.flash(_j(pallas, q), _j(pallas, k), _j(pallas, v),
                        causal=True, window=window, block_q=16, block_k=16)
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, window=window,
                        backend="cuda")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# ------------------------------------------------------------ K4 decode

def _decode_case(rng, b, t, h, kh, d):
    return (rng.normal(size=(b, 1, h, d)), rng.normal(size=(b, t, kh, d)),
            rng.normal(size=(b, t, kh, d)))


@pytest.mark.parametrize("t,h,kh,d,win", [
    (64, 4, 2, 32, 0), (40, 8, 8, 16, 12), (100, 4, 1, 32, 16),
    (72, 4, 4, 80, 0), (72, 4, 4, 80, 20),      # Zamba2's head width
    (48, 16, 1, 32, 0), (48, 32, 2, 16, 12),    # g = 16 (qwen3-moe, chatglm3)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas(pallas, t, h, kh, d, win, dtype):
    rng = np.random.default_rng(t + d)
    b, idx = 2, t - 10
    q, k, v = _decode_case(rng, b, t, h, kh, d)
    tags = np.broadcast_to(np.where(np.arange(t) <= idx, np.arange(t), -1),
                           (b, t)).astype(np.int32)
    want = pallas.decode(_j(pallas, q, dtype), _j(pallas, k, dtype),
                         _j(pallas, v, dtype), pallas.jnp.asarray(tags),
                         idx, window=win, block_k=16)
    before = decode_attention.launches
    got = decode_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                           torch.from_numpy(tags), idx, window=win)
    assert decode_attention.launches == before
    np.testing.assert_allclose(_f32(got), _f32(want), atol=_ATOL[dtype])


def test_decode_ring_buffer_tags_plain_matches_pallas(pallas):
    """Ring-buffer semantics: tags are slot -> position, unordered."""
    rng = np.random.default_rng(5)
    b, t, h, d, idx, win = 1, 32, 2, 16, 100, 24
    q, k, v = _decode_case(rng, b, t, h, h, d)
    perm = np.random.default_rng(1).permutation(32)
    tags = (idx - 31 + perm)[None, :].astype(np.int32)
    want = pallas.decode(_j(pallas, q), _j(pallas, k), _j(pallas, v),
                         pallas.jnp.asarray(tags), idx, window=win,
                         block_k=8)
    got = decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(tags),
                           idx, window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("win", [0, 12])
def test_decode_shared_index_equals_pallas_route(pallas, win):
    """Every row at one position (the serving path): the Pallas route's
    batch-wide max(kv_positions) and the port's per-row index agree."""
    rng = np.random.default_rng(win)
    b, t, h, kh, d, idx = 3, 48, 4, 2, 32, 30
    q, k, v = _decode_case(rng, b, t, h, kh, d)
    tags = np.broadcast_to(np.where(np.arange(t) <= idx, np.arange(t), -1),
                           (b, t)).astype(np.int32)
    offs = np.full((b, 1), idx, np.int32)
    want = pallas.ops.attention(
        _j(pallas, q), _j(pallas, k), _j(pallas, v), causal=True,
        window=win, q_offset=pallas.jnp.asarray(offs),
        kv_positions=pallas.jnp.asarray(tags), backend="pallas")
    got = ops.attention(_t(q), _t(k), _t(v), causal=True, window=win,
                        q_offset=torch.from_numpy(offs[:, 0]),
                        kv_positions=torch.from_numpy(tags), backend="cuda")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("win", [0, 8])
def test_decode_ragged_index_equals_reference(pallas, win):
    """Rows at different positions: the port takes each row's own index,
    as ``ref.mha_reference`` with a per-row ``q_offset`` does."""
    rng = np.random.default_rng(7 + win)
    b, t, h, kh, d = 3, 40, 4, 2, 32
    index = np.array([39, 25, 11], np.int32)
    q, k, v = _decode_case(rng, b, t, h, kh, d)
    tags = np.where(np.arange(t)[None] <= index[:, None], np.arange(t),
                    -1).astype(np.int32)
    want = pallas.ref.mha_reference(
        _j(pallas, q), _j(pallas, k), _j(pallas, v), causal=True,
        window=win, q_offset=pallas.jnp.asarray(index[:, None]),
        kv_positions=pallas.jnp.asarray(tags))
    got = decode_attention(_t(q), _t(k), _t(v), torch.from_numpy(tags),
                           torch.from_numpy(index), window=win)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


# K4's split pass and merge (the kernel's two CUDA kernels), composed:
# (b, t, h, kh, d, splits, window, rows); rows "shared" puts every row at
# index t - 6, "first" at 10 (every later split has no valid slot),
# "empty" leaves row 1 with no valid slot, "ring" tags the slots with
# positions 69..100 in a permuted order at index 100
SPLIT_CASES = {
    "one split": (2, 48, 4, 2, 16, 1, 0, "shared"),
    "two splits": (2, 48, 4, 2, 16, 2, 0, "shared"),
    "17 splits, ragged last": (2, 50, 4, 2, 16, 17, 0, "shared"),
    "a slot a split": (1, 24, 4, 2, 16, 24, 0, "shared"),
    "splits with no valid slot": (2, 48, 4, 2, 16, 4, 0, "first"),
    "a row with no valid slot": (2, 48, 4, 2, 16, 3, 0, "empty"),
    "window shorter than a split": (2, 64, 4, 2, 16, 2, 5, "shared"),
    "ring of tags": (1, 32, 2, 2, 16, 3, 24, "ring"),
    "g = 1": (2, 48, 4, 4, 32, 3, 12, "shared"),
    "g = 16": (2, 48, 16, 1, 32, 5, 12, "shared"),
}


def _split_case(b, t, h, kh, d, rows, seed):
    rng = np.random.default_rng(seed)
    q, k, v = _decode_case(rng, b, t, h, kh, d)
    slots = np.arange(t)
    if rows == "ring":
        idx = np.full(b, 100)
        tags = np.broadcast_to(idx[0] - t + 1 + rng.permutation(t), (b, t))
    else:
        idx = np.full(b, {"shared": t - 6, "first": 10, "empty": 30}[rows])
        if rows == "empty":
            idx[1] = -1
        tags = np.where(slots[None] <= idx[:, None], slots, -1)
    return q, k, v, tags.astype(np.int32), idx.astype(np.int32)


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_decode_split_merge_plain_matches_reference(pallas, case):
    """ref.decode_split_reference then ref.decode_merge_reference (the
    plain counterpart of K4's split and merge kernels) against
    ref.mha_reference in float64 (atol 1e-12) and, where every row shares
    its index, against the Pallas kernel in interpret mode in float32
    (K4's 2e-5; elsewhere against mha_reference in float32)."""
    b, t, h, kh, d, splits, win, rows = SPLIT_CASES[case]
    q, k, v, tags, idx = _split_case(b, t, h, kh, d, rows,
                                     len(case) + splits)
    split_len = -(-t // splits)
    assert -(-t // split_len) == splits
    tg, ix = torch.from_numpy(tags), torch.from_numpy(idx)

    def composed(dtype):
        m, l, acc = ref.decode_split_reference(
            *(torch.tensor(x, dtype=dtype) for x in (q, k, v)), tg, ix,
            split_len=split_len, window=win)
        return m, ref.decode_merge_reference(m, l, acc, dtype)

    m, got = composed(torch.float64)
    want = ref.mha_reference(*(torch.tensor(x) for x in (q, k, v)),
                             causal=True, window=win, q_offset=ix[:, None],
                             kv_positions=tg)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    if rows == "first":     # later splits see no slot and weigh nothing
        assert (m[1:] == ref.NEG_INF).all() and (m[0] > ref.NEG_INF).all()
    _, got32 = composed(torch.float32)
    if rows == "empty":
        want32 = ref.mha_reference(_t(q), _t(k), _t(v), causal=True,
                                   window=win, q_offset=ix[:, None],
                                   kv_positions=tg)
        np.testing.assert_allclose(got.numpy()[1], np.broadcast_to(
            v.mean(1)[1][:, None], (kh, h // kh, d)).reshape(1, h, d),
            atol=1e-12)
    else:
        want32 = pallas.decode(_j(pallas, q), _j(pallas, k), _j(pallas, v),
                               pallas.jnp.asarray(tags), int(idx[0]),
                               window=win, block_k=16)
    np.testing.assert_allclose(got32.numpy(), _f32(want32), rtol=0,
                               atol=_ATOL["float32"])


def test_decode_plan_depends_on_shapes_only():
    """K4's host plan takes only shapes and the SM count (no tensor, so
    two calls on the same shapes run the same grid) and keeps its
    invariants: S splits of split_len slots cover T with no empty split;
    a tile of 8 slots on the tensor cores, 8, 16 or 32 on the CUDA cores;
    a ring of one tile only where each of a block's teams has one; the
    tensor cores from g = 8; no more blocks than four an SM; and a layout
    that fits a block's 232,448 bytes of shared memory at every g and D,
    with all of a KV head's query heads in one block (its cache read once)
    up to g = 64."""
    from repro_torch.kernels.decode_attention import plan
    import inspect
    assert list(inspect.signature(plan).parameters) == [
        "b", "t", "h", "kh", "d", "itemsize", "sms"]
    # qwen3-moe-235b-a22b's and Zamba2-2.7B's decode on 132 SMs
    assert plan(4, 1056, 64, 4, 128, 4, 132)[5:12] == (33, 32, 8, 1, 1,
                                                        16, 1)
    assert plan(4, 1056, 32, 32, 80, 4, 132)[5:12] == (3, 352, 8, 2, 0,
                                                        1, 1)
    # T shorter than a tile: one split, the split kernel writes o
    assert plan(2, 7, 64, 4, 128, 4, 132).splits == 1
    assert plan(2, 7, 4, 4, 80, 2, 132).splits == 1
    for b in (1, 4, 16):
        for t in (1, 7, 1000, 1056, 1057, 4096):
            for h, kh, d in [(64, 4, 128), (32, 32, 80), (16, 16, 256),
                             (16, 8, 128), (4, 1, 17), (32, 1, 64),
                             (128, 1, 128), (64, 1, 256), (48, 1, 256),
                             (128, 1, 80), (272, 1, 16), (512, 2, 256)]:
                for itemsize in (2, 4):
                    p = plan(b, t, h, kh, d, itemsize, 132)
                    g = h // kh
                    assert p == plan(b, t, h, kh, d, itemsize, 132)
                    assert p[:5] == (b, t, h, kh, d)
                    assert (p.splits - 1) * p.split_len < t
                    assert t <= p.splits * p.split_len
                    assert p.tile in ((8,) if p.tensor_cores else
                                      (8, 16, 32))
                    per_team = -(-(-(-p.split_len // p.tile)) // p.teams)
                    assert p.stages == min(2, per_team)
                    assert b * kh * p.hgroups * p.splits <= max(
                        b * kh * p.hgroups, 4 * 132)
                    assert p.tensor_cores == (g >= 8)
                    assert p.smem <= 232448
                    assert (p.hgroups - 1) * p.heads < g <= (
                        p.hgroups * p.heads)
                    assert p.heads <= p.rows and 1 <= p.teams <= 4
                    assert p.teams * p.team_warps <= 16
                    assert p.hgroups == 1 or g > 64


def test_decode_plan_matches_the_kernels_struct():
    """The wrapper's Plan is packed as the kernel's ``struct Plan``: the
    same fields in the same order, every one an int32."""
    import re
    from repro_torch.kernels.decode_attention import Plan
    src = (Path(ref.__file__).parent / "csrc" /
           "decode_attention.cu").read_text()
    body = re.search(r"struct Plan \{(.*?)\};", src, re.S).group(1)
    decls = [re.sub(r"//.*", "", line).strip()
             for line in body.splitlines()]
    fields = []
    for decl in filter(None, decls):
        assert decl.startswith("int ") and decl.endswith(";"), decl
        fields += [f.strip() for f in decl[4:-1].split(",")]
    assert tuple(fields) == Plan._fields


# ------------------------------------------------------------ K5 ssd

SSD_SHAPES = [
    (2, 64, 4, 8, 2, 16, 16),
    (1, 50, 4, 8, 1, 16, 16),      # padded tail
    (2, 32, 6, 16, 2, 8, 8),
    (1, 128, 2, 32, 1, 32, 32),
    (1, 72, 4, 64, 1, 64, 32),     # Zamba2's P = N = 64, padded tail
]


def _ssd_case(rng, b, l, h, p, g, n):
    return (rng.normal(size=(b, l, h, p)),
            rng.uniform(0.001, 0.1, size=(b, l, h)).astype(np.float32),
            -np.exp(rng.normal(size=(h,))).astype(np.float32),
            rng.normal(size=(b, l, g, n)), rng.normal(size=(b, l, g, n)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,p,g,n,q", SSD_SHAPES)
def test_ssd_plain_matches_pallas(pallas, b, l, h, p, g, n, q, dtype):
    x, dt, a, bm, cm = _ssd_case(np.random.default_rng(l + p), b, l, h, p,
                                 g, n)
    jnp = pallas.jnp
    y0, h0 = pallas.ssd(_j(pallas, x, dtype), jnp.asarray(dt),
                        jnp.asarray(a), _j(pallas, bm, dtype),
                        _j(pallas, cm, dtype), chunk=q)
    before = ssd_chunked.launches
    y1, h1 = ssd_chunked(_t(x, dtype), torch.from_numpy(dt),
                         torch.from_numpy(a), _t(bm, dtype), _t(cm, dtype),
                         chunk=q)
    assert ssd_chunked.launches == before
    assert y1.dtype == _TORCH[dtype] and h1.dtype == torch.float32
    np.testing.assert_allclose(_f32(y1), _f32(y0), atol=_ATOL[dtype] * 10,
                               rtol=5e-2)
    np.testing.assert_allclose(_f32(h1), _f32(h0), atol=_ATOL[dtype] * 10,
                               rtol=5e-2)


@pytest.mark.parametrize("b,l,h,p,g,n,q", SSD_SHAPES)
def test_ssd_passes_plain_matches_pallas(pallas, b, l, h, p, g, n, q):
    """K5's three passes in plain PyTorch (chunk states, the state pass,
    chunk outputs) against the Pallas kernel in interpret mode."""
    x, dt, a, bm, cm = _ssd_case(np.random.default_rng(l + p), b, l, h, p,
                                 g, n)
    jnp = pallas.jnp
    y0, h0 = pallas.ssd(_j(pallas, x), jnp.asarray(dt), jnp.asarray(a),
                        _j(pallas, bm), _j(pallas, cm), chunk=q)
    y1, h1 = ref.ssd_chunk_passes_reference(
        _t(x), torch.from_numpy(dt), torch.from_numpy(a), _t(bm), _t(cm),
        chunk=q)
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=2e-4,
                               rtol=5e-2)
    np.testing.assert_allclose(h1.numpy(), np.asarray(h0), atol=2e-4,
                               rtol=5e-2)


@pytest.mark.parametrize("b,l,h,p,g,n,q,strong", [
    (1, 4096, 2, 16, 1, 16, 256, False),     # 16 chunks
    (1, 1024, 4, 16, 2, 16, 256, True),      # a down to -20: cums to -500
    (2, 1, 4, 8, 2, 16, 256, False),         # one token
    (1, 600, 2, 8, 1, 16, 256, False),       # ragged tail of 88 steps
    (1, 600, 2, 8, 1, 16, 256, True),
])
def test_ssd_passes_plain_matches_chunked_reference(b, l, h, p, g, n, q,
                                                    strong):
    """The three passes against the chunked plain version (one sequential
    scan of the chunk states) in float32: the same sums taken in another
    order, so they agree to float32 rounding."""
    rng = np.random.default_rng(l + h)
    x, dt, a, bm, cm = _ssd_case(rng, b, l, h, p, g, n)
    if strong:
        a = rng.uniform(-20.0, -1.0, size=(h,)).astype(np.float32)
    args = (_t(x), torch.from_numpy(dt), torch.from_numpy(a), _t(bm),
            _t(cm))
    y0, h0 = ref.ssd_chunked_reference(*args, chunk=q)
    y1, h1 = ref.ssd_chunk_passes_reference(*args, chunk=q)
    assert y1.shape == (b, l, h, p) and h1.shape == (b, h, p, n)
    assert bool(torch.isfinite(y1).all()) and bool(torch.isfinite(h1).all())
    torch.testing.assert_close(y1, y0, atol=1e-5, rtol=1e-4)
    torch.testing.assert_close(h1, h0, atol=1e-5, rtol=1e-4)


def test_ssd_single_token_plain_matches_reference(pallas):
    """One token goes to the exact sequential step on the torch route."""
    x, dt, a, bm, cm = _ssd_case(np.random.default_rng(3), 2, 1, 4, 8, 2,
                                 16)
    jnp = pallas.jnp
    y0, h0 = pallas.ref.ssd_reference(jnp.asarray(x, jnp.float32),
                                      jnp.asarray(dt), jnp.asarray(a),
                                      jnp.asarray(bm, jnp.float32),
                                      jnp.asarray(cm, jnp.float32))
    y1, h1 = ops.ssd(_t(x), torch.from_numpy(dt), torch.from_numpy(a),
                     _t(bm), _t(cm), chunk=16, backend="torch")
    np.testing.assert_allclose(y1.numpy(), np.asarray(y0), atol=2e-5)
    np.testing.assert_allclose(h1.numpy(), np.asarray(h0), atol=2e-5)


def test_ssd_kernel_refuses_an_initial_state():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(AssertionError, match="zero init state"):
        ssd_chunked(x, torch.zeros(1, 4, 2), torch.zeros(2),
                    torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8),
                    init_state=torch.zeros(1, 2, 8, 8))


def test_cuda_route_refuses_what_the_kernels_cannot_honour():
    q = torch.zeros(1, 4, 2, 8)
    k = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="q_offset"):
        ops.attention(q, k, k, q_offset=3, backend="cuda")
    with pytest.raises(ValueError, match="one query token"):
        ops.attention(q, k, k, backend="cuda",
                      kv_positions=torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="unknown kernel backend"):
        ops.ssd(q, torch.zeros(1, 4, 2), torch.zeros(2), k, k,
                backend="pallas")


# ------------------------------------ K3's tensor-core arithmetic, emulated
#
# csrc/flash_attention.cu runs both products on mma.m16n8k8 with TF32
# operands. These tests emulate, in numpy, the two things the card cannot
# show one by one: the 3xTF32 split's error, and the fragment index maps
# (with the k slots permuted) that hand S's accumulator to P V as it stands.

_K3_F32_TOL = (2e-5, 1e-2)      # (atol, rtol) of K3 in float32


def _tf32_rna(x):
    """float32 -> TF32 (10 mantissa bits), to nearest with ties away: the
    kernel's ``tf32_rna`` on the float32 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    hi = _tf32_rna(x)
    return hi, _tf32_rna(np.float32(x) - hi)


def _mma(acc, a, b):
    """One mma step: exact products of TF32 values, summed and added to
    the float32 accumulator with one rounding."""
    return (acc.astype(np.float64) +
            a.astype(np.float64) @ b.astype(np.float64)).astype(np.float32)


def _tc_product(a, b, passes):
    """a @ b (batched over leading axes) in 8-deep k steps as the kernel
    issues them: ``passes`` 3 is lo*hi + hi*lo + hi*hi (3xTF32), 1 is
    hi*hi (one TF32 pass)."""
    acc = np.zeros(a.shape[:-1] + b.shape[-1:], np.float32)
    for k0 in range(0, a.shape[-1], 8):
        a_hi, a_lo = _split(a[..., k0:k0 + 8])
        b_hi, b_lo = _split(b[..., k0:k0 + 8, :])
        if passes == 3:
            acc = _mma(acc, a_lo, b_hi)
            acc = _mma(acc, a_hi, b_lo)
        acc = _mma(acc, a_hi, b_hi)
    return acc


def _margin(got, want):
    atol, rtol = _K3_F32_TOL
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


@pytest.mark.parametrize("what,m,k,n", [("scores", 64, 80, 64),
                                        ("pv", 64, 64, 80)])
def test_3xtf32_error_sits_inside_k3_tolerance(what, m, k, n):
    """A 64x80 . 80x64 score tile and a 64x64 . 64x80 P V tile at
    unit-normal inputs against float64: 3xTF32 uses under a tenth of K3's
    float32 tolerance (atol + rtol |x|) everywhere; one TF32 pass exceeds it
    (margin = the largest |error| / tolerance)."""
    rng = np.random.default_rng(14)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    three = _margin(_tc_product(a, b, 3), want)
    one = _margin(_tc_product(a, b, 1), want)
    print(f"{what}: margin 3xTF32 {three:.3e}, one pass {one:.3e}")
    assert three < 0.1
    assert one > 1.0


def _tc_attention(q, k, v, passes, keys=64):
    """Causal attention of (H, S, D) float32 q, k, v as the kernel computes
    it: q scaled by scale * log2(e), S and P V on the emulated tensor cores,
    an online softmax in exp2 over 64-key tiles, all state in float32."""
    s_len, d = q.shape[1:]
    qs = q * np.float32(1.4426950408889634 / np.sqrt(d))
    m = np.full((q.shape[0], s_len, 1), -1e30, np.float32)
    l = np.zeros_like(m)
    acc = np.zeros(q.shape, np.float32)
    rows = np.arange(s_len)[:, None]
    for k0 in range(0, s_len, keys):
        s = _tc_product(qs, np.swapaxes(k[:, k0:k0 + keys], 1, 2), passes)
        s = np.where(np.arange(k0, k0 + keys) <= rows, s, np.float32(-1e30))
        mx = np.maximum(m, s.max(-1, keepdims=True))
        alpha = np.exp2(m - mx)
        p = np.exp2(s - mx)
        m = mx
        l = alpha * l + p.sum(-1, keepdims=True, dtype=np.float32)
        acc = acc * alpha + _tc_product(p, v[:, k0:k0 + keys], passes)
    return acc / np.maximum(l, np.float32(1e-30))


def test_3xtf32_attention_sits_inside_k3_tolerance():
    """Whole causal rows at the serve path's length and head width (two
    heads of S = T = 1024, D = 80, unit-normal q, k, v), the scores' error
    carried through the softmax and P V, against float64 attention: 3xTF32
    uses under a tenth of K3's float32 tolerance, and one TF32 pass exceeds
    it (about 1% of the outputs, by up to about 9x), so the averaging over
    keys does not hide a single pass."""
    rng = np.random.default_rng(14)
    q, k, v = (rng.standard_normal((2, 1024, 80)).astype(np.float32)
               for _ in range(3))
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = q64 @ np.swapaxes(k64, 1, 2) / np.sqrt(80)
    s = np.where(np.tril(np.ones((1024, 1024), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    want = (p @ v64) / p.sum(-1, keepdims=True)
    three = _margin(_tc_attention(q, k, v, 3), want)
    one = _margin(_tc_attention(q, k, v, 1), want)
    print(f"attention: margin 3xTF32 {three:.3e}, one pass {one:.3e}")
    assert three < 0.1
    assert one > 1.0


_K5_F32_TOL = (2e-4, 5e-2)      # (atol, rtol) of K5 in float32


def _k5_margin(got, want):
    atol, rtol = _K5_F32_TOL
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def _tc_ssd_chunk(x, dt, a, bm, cm, h_in, passes):
    """One chunk of K5 as its kernels compute it, with the products on the
    emulated tensor cores: cums in float32, the chunk state (w x)^T B with
    w_j = exp(cums_Q - cums_j) dt_j, the scores C B^T scaled by
    exp(cums_i - cums_j) dt_j and masked to j <= i, their product with x,
    and exp(cums_i) C h_in^T. Returns (y, the state after the chunk)."""
    cums = np.cumsum(dt * a, dtype=np.float32)
    w = np.exp(cums[-1] - cums) * dt
    s_c = _tc_product(np.ascontiguousarray((x * w[:, None]).T), bm, passes)
    h_out = np.exp(cums[-1]) * h_in + s_c
    q = len(dt)
    scores = _tc_product(cm, np.ascontiguousarray(bm.T), passes)
    scale = np.exp(cums[:, None] - cums[None, :]) * dt[None, :]
    scores = np.where(np.tril(np.ones((q, q), bool)), scores * scale,
                      np.float32(0)).astype(np.float32)
    carried = np.exp(cums)[:, None] * _tc_product(
        cm, np.ascontiguousarray(h_in.T), passes)
    return carried + _tc_product(scores, x, passes), h_out


def _ssd_chunk_f64(x, dt, a, bm, cm, h_in):
    x, dt, bm, cm, h_in = (v.astype(np.float64) for v in (x, dt, bm, cm,
                                                           h_in))
    cums = np.cumsum(dt * np.float64(a))
    q = len(dt)
    lmat = np.where(np.tril(np.ones((q, q), bool)),
                    np.exp(cums[:, None] - cums[None, :]), 0.0)
    y = ((cm @ bm.T) * lmat * dt[None, :]) @ x + \
        np.exp(cums)[:, None] * (cm @ h_in.T)
    h_out = np.exp(cums[-1]) * h_in + \
        ((x * (np.exp(cums[-1] - cums) * dt)[:, None]).T @ bm)
    return y, h_out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_3xtf32_ssd_chunk_sits_inside_k5_tolerance(seed):
    """One 256-step chunk at P = N = 64 with an incoming state (x, B, C,
    h unit-normal, dt ~ U(0.001, 0.1), a = -exp(N(0, 1))), every product
    of K5 (C B^T, the masked scores times x, C h^T, the chunk state) on
    the emulated tensor cores, against float64 (margin = the largest
    |error| / (atol 2e-4 + rtol 5e-2 |want|), K5's float32 tolerance):
    3xTF32 keeps y and the new state within 0.005-0.011 of it over these
    seeds, and one TF32 pass exceeds it on y by 5.2-8.5x."""
    rng = np.random.default_rng(seed)
    q, p, n = 256, 64, 64
    x = rng.standard_normal((q, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, q).astype(np.float32)
    a = np.float32(-np.exp(rng.standard_normal()))
    bm, cm = (rng.standard_normal((q, n)).astype(np.float32)
              for _ in range(2))
    h_in = rng.standard_normal((p, n)).astype(np.float32)
    y64, h64 = _ssd_chunk_f64(x, dt, a, bm, cm, h_in)
    y3, h3 = _tc_ssd_chunk(x, dt, a, bm, cm, h_in, 3)
    y1, h1 = _tc_ssd_chunk(x, dt, a, bm, cm, h_in, 1)
    three = max(_k5_margin(y3, y64), _k5_margin(h3, h64))
    one = _k5_margin(y1, y64)
    print(f"seed {seed}: margin 3xTF32 {three:.3e}, one pass {one:.3e} "
          f"(state {_k5_margin(h1, h64):.3e})")
    assert three < 0.05
    assert one > 1.0


def _lanes():
    return [divmod(lane, 4) for lane in range(32)]       # (g, t)


def _mma_from_fragments(a_frag, b_frag):
    """The 16x8 product an m16n8k8 computes from its 32 lanes' fragments,
    laid out as the PTX ISA's .tf32 tables say: A a0..a3 at (g, t),
    (g + 8, t), (g, t + 4), (g + 8, t + 4); B b0, b1 at (t, g), (t + 4, g)."""
    a = np.zeros((16, 8))
    b = np.zeros((8, 8))
    for lane, (g, t) in enumerate(_lanes()):
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = a_frag[lane]
        b[t, g], b[t + 4, g] = b_frag[lane]
    return a @ b


def _c_fragment(c, lane):
    """A lane's C fragment of a 16x8 tile: (g, 2t), (g, 2t+1), (g+8, 2t),
    (g+8, 2t+1)."""
    g, t = divmod(lane, 4)
    return c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1]


def test_fragment_maps_hand_s_to_pv_without_moving_data():
    """The kernel's index maps for one warp (16 rows, a 64-key tile, D = 80)
    in float64: Q K^T with d permuted in each step of 8 (slot t = element
    2t, slot t + 4 = 2t + 1), then P V with P's A fragment taken straight
    from S's C fragments as (c0, c2, c1, c3) and V read at keys 2t, 2t + 1.
    Each must equal the plain product."""
    rng = np.random.default_rng(1)
    d, keys = 80, 64
    q = rng.standard_normal((16, d))
    k = rng.standard_normal((keys, d))
    v = rng.standard_normal((keys, d))

    # S = Q K^T: column tile n (8 keys), k step kk (8 of d)
    s_tiles = []
    for n in range(keys // 8):
        c = np.zeros((16, 8))
        for kk in range(d // 8):
            a_frag = [(q[g, 8 * kk + 2 * t], q[g + 8, 8 * kk + 2 * t],
                       q[g, 8 * kk + 2 * t + 1], q[g + 8, 8 * kk + 2 * t + 1])
                      for g, t in _lanes()]
            b_frag = [(k[8 * n + g, 8 * kk + 2 * t],
                       k[8 * n + g, 8 * kk + 2 * t + 1]) for g, t in _lanes()]
            c += _mma_from_fragments(a_frag, b_frag)
        s_tiles.append(c)
    s = np.concatenate(s_tiles, axis=1)
    np.testing.assert_allclose(s, q @ k.T, rtol=1e-12, atol=1e-12)

    # O = P V with P = S as the lanes hold it: no shuffle, no shared tile
    p = s
    out = np.zeros((16, d))
    for n in range(d // 8):
        for j in range(keys // 8):
            a_frag = []
            for lane in range(32):
                c0, c1, c2, c3 = _c_fragment(s_tiles[j], lane)
                a_frag.append((c0, c2, c1, c3))
            b_frag = [(v[8 * j + 2 * t, 8 * n + g],
                       v[8 * j + 2 * t + 1, 8 * n + g]) for g, t in _lanes()]
            out[:, 8 * n:8 * n + 8] += _mma_from_fragments(a_frag, b_frag)
    np.testing.assert_allclose(out, p @ v, rtol=1e-12, atol=1e-12)


# ------------------------------------------------------------- card only

def _randn(shape, gen, dev, dtype=torch.float32):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("b,s,t,h,kh,d,causal,window,dtype", [
    (2, 64, 64, 4, 2, 32, True, 0, torch.float32),
    (1, 37, 37, 4, 4, 16, True, 0, torch.bfloat16),
    (1, 16, 80, 4, 2, 32, False, 0, torch.float32),
    (2, 300, 300, 4, 4, 80, True, 0, torch.float32),
    (2, 200, 200, 16, 8, 128, True, 64, torch.float32),
    (1, 70, 70, 2, 1, 256, True, 0, torch.bfloat16),
    (2, 100, 100, 4, 2, 20, True, 0, torch.float32),    # D % 8 != 0
    (1, 90, 90, 4, 4, 17, True, 0, torch.float32),      # odd D: 4-byte copies
    (1, 90, 90, 4, 4, 17, True, 0, torch.bfloat16),
    (2, 300, 300, 4, 4, 80, True, 24, torch.float32),   # masked leading tiles
    (4, 1024, 1024, 32, 32, 80, True, 0, torch.float32),  # the serve shape
    (2, 200, 200, 16, 16, 256, True, 0, torch.float32),   # gemma-7b's D
])
def test_card_flash_kernel_matches_plain(cuda, b, s, t, h, kh, d, causal,
                                         window, dtype):
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = _randn((b, s, h, d), gen, cuda, dtype)
    k = _randn((b, t, kh, d), gen, cuda, dtype)
    v = _randn((b, t, kh, d), gen, cuda, dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.mha_reference(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=1e-2)


def _card_index(b, t, rows, dev):
    """Each row's index: t - 5 ("shared"), t - 5 - 7 b ("ragged"), 10
    ("first": every valid slot in the first split) or t - 5 with row 0
    left with no valid slot ("empty")."""
    index = torch.full((b,), 10 if rows == "first" else t - 5,
                       dtype=torch.int32, device=dev)
    if rows == "ragged":
        index -= torch.arange(b, dtype=torch.int32, device=dev) * 7
    if rows == "empty":
        index[0] = -1
    return index


@pytest.mark.parametrize("b,t,h,kh,d,window,rows,dtype", [
    (2, 64, 4, 2, 32, 0, "shared", torch.float32),
    (4, 1056, 32, 32, 80, 0, "shared", torch.float32),
    (4, 300, 16, 8, 128, 64, "ragged", torch.float32),
    (3, 100, 4, 1, 32, 16, "ragged", torch.bfloat16),
    # g = 16: qwen3-moe-235b-a22b, chatglm3-6b
    (4, 1056, 64, 4, 128, 0, "ragged", torch.float32),
    (4, 1056, 64, 4, 128, 256, "ragged", torch.bfloat16),
    (2, 300, 32, 2, 128, 0, "ragged", torch.bfloat16),
    (2, 200, 48, 4, 64, 32, "ragged", torch.float32),       # g = 12
    # T not a multiple of the split, and shorter than one tile
    (4, 1000, 64, 4, 128, 0, "ragged", torch.float32),
    (4, 1057, 32, 32, 80, 0, "ragged", torch.float32),
    (4, 1057, 64, 4, 128, 0, "shared", torch.bfloat16),
    (2, 7, 64, 4, 128, 0, "ragged", torch.float32),
    (2, 7, 4, 4, 80, 0, "shared", torch.bfloat16),
    (4, 1056, 16, 16, 256, 0, "shared", torch.float32),    # gemma-7b
    (4, 1056, 16, 16, 256, 0, "ragged", torch.bfloat16),
    (4, 1056, 64, 4, 128, 20, "ragged", torch.float32),    # window < split
    (4, 1056, 64, 4, 128, 0, "first", torch.float32),
    (4, 1056, 32, 32, 80, 0, "first", torch.bfloat16),
    (4, 1056, 64, 4, 128, 0, "empty", torch.float32),      # no valid slot
    (4, 1056, 32, 32, 80, 16, "empty", torch.float32),
    # D not a multiple of 16 bytes: element copies, odd columns
    (2, 300, 16, 4, 17, 0, "ragged", torch.float32),
    (2, 300, 16, 4, 17, 24, "ragged", torch.bfloat16),
    (2, 200, 32, 2, 20, 16, "ragged", torch.float32),      # K's pad columns
    # teams of several warps (g > 16); a group of 128 or 64 wide heads in
    # one block of fewer teams; a group over two blocks (g > 256)
    (2, 300, 32, 1, 64, 16, "ragged", torch.float32),
    (2, 100, 128, 1, 32, 0, "ragged", torch.bfloat16),
    (1, 64, 128, 1, 128, 0, "shared", torch.float32),
    (1, 64, 128, 1, 128, 0, "shared", torch.bfloat16),
    (1, 64, 64, 1, 256, 0, "shared", torch.float32),
    (1, 64, 64, 1, 256, 0, "shared", torch.bfloat16),
    (2, 300, 48, 1, 256, 24, "ragged", torch.float32),
    (1, 64, 272, 1, 16, 0, "shared", torch.float32),
])
def test_card_decode_kernel_matches_plain(cuda, b, t, h, kh, d, window,
                                          rows, dtype):
    gen = torch.Generator(device=cuda).manual_seed(t)
    q = _randn((b, 1, h, d), gen, cuda, dtype)
    k = _randn((b, t, kh, d), gen, cuda, dtype)
    v = _randn((b, t, kh, d), gen, cuda, dtype)
    index = _card_index(b, t, rows, cuda)
    slots = torch.arange(t, dtype=torch.int32, device=cuda)[None]
    tags = torch.where(slots <= index[:, None], slots, -1).contiguous()
    before = decode_attention.launches
    got = decode_attention(q, k, v, tags, index, window=window)
    want = ref.mha_reference(q, k, v, causal=True, window=window,
                             q_offset=index[:, None], kv_positions=tags)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    atol = 2e-5 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=0)


def test_card_decode_kernel_takes_unaligned_rows(cuda):
    """K and V whose rows start 4 bytes past a 16-byte boundary (a
    contiguous view one element into a buffer) take the element copies
    and still match the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    b, t, h, kh, d = 2, 200, 32, 2, 128
    q = _randn((b, 1, h, d), gen, cuda)
    kbuf = _randn((b * t * kh * d + 1,), gen, cuda)
    vbuf = _randn((b * t * kh * d + 1,), gen, cuda)
    k = kbuf[1:].view(b, t, kh, d)
    v = vbuf[1:].view(b, t, kh, d)
    assert k.is_contiguous() and k.data_ptr() % 16
    index = _card_index(b, t, "ragged", cuda)
    slots = torch.arange(t, dtype=torch.int32, device=cuda)[None]
    tags = torch.where(slots <= index[:, None], slots, -1).contiguous()
    got = decode_attention(q, k, v, tags, index)
    want = ref.mha_reference(q, k, v, causal=True, q_offset=index[:, None],
                             kv_positions=tags)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_card_decode_kernel_repeats_bit_for_bit(cuda):
    """The splits are merged in a fixed order with no atomics: two calls
    on the same inputs give the same bits, at qwen3-moe-235b-a22b's and
    Zamba2-2.7B's decode shapes."""
    gen = torch.Generator(device=cuda).manual_seed(27)
    for b, t, h, kh, d in [(4, 1056, 64, 4, 128), (4, 1056, 32, 32, 80)]:
        q = _randn((b, 1, h, d), gen, cuda)
        k = _randn((b, t, kh, d), gen, cuda)
        v = _randn((b, t, kh, d), gen, cuda)
        index = _card_index(b, t, "ragged", cuda)
        slots = torch.arange(t, dtype=torch.int32, device=cuda)[None]
        tags = torch.where(slots <= index[:, None], slots, -1).contiguous()
        one = decode_attention(q, k, v, tags, index)
        two = decode_attention(q, k, v, tags, index)
        torch.cuda.synchronize()
        assert torch.equal(one, two)


@pytest.mark.parametrize("b,l,h,p,g,n,q,dtype,strong", [
    (2, 64, 4, 8, 2, 16, 16, torch.float32, False),
    (1, 50, 4, 8, 1, 16, 16, torch.bfloat16, False),
    (1, 128, 2, 32, 1, 32, 32, torch.float32, False),
    (2, 600, 8, 64, 1, 64, 256, torch.float32, False),
    (1, 300, 4, 64, 2, 128, 256, torch.float32, False),
    (4, 1024, 80, 64, 1, 64, 256, torch.float32, False),  # the serve shape
    (2, 600, 8, 64, 1, 64, 256, torch.bfloat16, False),
    (1, 300, 4, 64, 2, 128, 256, torch.bfloat16, False),
    (1, 200, 4, 96, 1, 32, 64, torch.float32, False),     # two P tiles
    (1, 130, 2, 16, 1, 256, 64, torch.float32, False),    # N = 256
    (3, 1, 4, 64, 1, 64, 256, torch.float32, False),      # one token
    (1, 250, 4, 32, 4, 32, 100, torch.float32, False),    # chunk % 64, G = H
    (2, 100, 6, 20, 3, 24, 48, torch.bfloat16, False),    # odd widths
    (1, 90, 2, 17, 1, 18, 32, torch.float32, False),      # 4-byte copies
    # 16 chunks of 256 steps side by side, with a down to -20
    (2, 4096, 8, 64, 1, 64, 256, torch.float32, True),
    (2, 4096, 8, 64, 1, 64, 256, torch.bfloat16, True),
])
def test_card_ssd_kernel_matches_plain(cuda, b, l, h, p, g, n, q, dtype,
                                       strong):
    x, dt, a, bm, cm = _ssd_card_case(cuda, l, b, l, h, p, g, n, dtype,
                                      strong)
    before = ssd_chunked.launches
    y1, h1 = ssd_chunked(x, dt, a, bm, cm, chunk=q)
    y0, h0 = ref.ssd_chunked_reference(x, dt, a, bm, cm, chunk=q)
    torch.cuda.synchronize()
    assert ssd_chunked.launches == before + 3     # three kernels a call
    assert bool(torch.isfinite(y1.float()).all())
    atol = 2e-4 if dtype == torch.float32 else 5e-1
    torch.testing.assert_close(y1.float(), y0.float(), atol=atol, rtol=5e-2)
    torch.testing.assert_close(h1, h0, atol=atol, rtol=5e-2)


def _ssd_card_case(dev, seed, b, l, h, p, g, n, dtype=torch.float32,
                   strong=False):
    """dt ~ U(0.001, 0.1), a = -exp(N(0, 1)) or, for ``strong`` decay,
    a ~ U(-20, -1) (cums near -500 inside a 256-step chunk)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn((b, l, h, p), gen, dev, dtype)
    dt = torch.rand((b, l, h), generator=gen, device=dev) * 0.099 + 0.001
    if strong:
        a = -1.0 - 19.0 * torch.rand((h,), generator=gen, device=dev)
    else:
        a = -torch.exp(torch.randn((h,), generator=gen, device=dev))
    bm = _randn((b, l, g, n), gen, dev, dtype)
    cm = _randn((b, l, g, n), gen, dev, dtype)
    return x, dt, a, bm, cm


def test_card_ssd_kernel_repeats_bit_for_bit(cuda):
    """No atomics and no order between blocks: two calls on the same
    inputs give the same bits."""
    x, dt, a, bm, cm = _ssd_card_case(cuda, 2, 4, 1024, 80, 64, 1, 64)
    y1, h1 = ssd_chunked(x, dt, a, bm, cm)
    y2, h2 = ssd_chunked(x, dt, a, bm, cm)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(h1, h2)


def test_card_ssd_one_tf32_pass_misses_k5_tolerance(cuda, tmp_path,
                                                    monkeypatch):
    """K5's float32 tolerance tells 3xTF32 from one TF32 pass on the card:
    ssd_scan.cu built with its float32 products in one pass (hi*hi, the
    two lo passes of tf32_mma.cuh's mma_3xtf32_b taken out) misses it at
    the serve shape, where the kernel as built meets it. Prints each
    one's share of the tolerance, the largest |error| / (atol + rtol
    |want|) over y and the state."""
    header = (_build.CSRC / "tf32_mma.cuh").read_text()
    lo_passes = ("  mma_tf32(c, a_lo, h0, h1);\n"
                 "  if constexpr (!kExactB) mma_tf32(c, a_hi, l0, l1);\n")
    assert header.count(lo_passes) == 1
    for src in _build.CSRC.glob("*.cuh"):
        shutil.copy(src, tmp_path)
    (tmp_path / "tf32_mma.cuh").write_text(header.replace(lo_passes, ""))
    shutil.copy(_build.CSRC / "ssd_scan.cu", tmp_path)
    lib = tmp_path / "libssd_scan_one_pass.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(tmp_path / "ssd_scan.cu")], check=True,
                   capture_output=True, timeout=600)
    one_pass = ctypes.CDLL(str(lib)).ssd_chunk_scan_f32
    one_pass.argtypes = list(ssd_scan._ARGTYPES)
    one_pass.restype = ctypes.c_int

    x, dt, a, bm, cm = _ssd_card_case(cuda, 2, 4, 1024, 80, 64, 1, 64)
    want = ref.ssd_chunked_reference(x, dt, a, bm, cm)

    def share():
        got = ssd_chunked(x, dt, a, bm, cm)
        return max(float(((g - w).abs() / (2e-4 + 5e-2 * w.abs())).max())
                   for g, w in zip(got, want))

    three = share()
    monkeypatch.setattr(ssd_scan, "bind", lambda *_: one_pass)
    one = share()
    print(f"K5 at (4, 1024, 80, 64, 1, 64, 256) float32, share of its "
          f"tolerance: 3xTF32 {three:.4g}, one TF32 pass {one:.4g}")
    assert three < 1 < one, (three, one)


def test_card_lm_kernel_wrappers_reject_what_they_do_not_take(cuda):
    q = torch.zeros(1, 4, 2, 8, device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), q, q)
    tags = torch.zeros(1, 4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        decode_attention(q, q, q, tags, 0)              # S = 4, not 1
    with pytest.raises(ValueError):
        decode_attention(q[:, :1], q, q, tags.long(), 0)
    with pytest.raises(TypeError):
        ssd_chunked(q.half(), torch.zeros(1, 4, 2, device=cuda),
                    torch.zeros(2, device=cuda), q.half(), q.half())
