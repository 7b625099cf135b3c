"""Plain PyTorch versions of the port's kernels (from ``repro.kernels.ref``).

Each function here computes what its kernel computes, with ordinary
tensor ops on any device. The kernel wrappers take them for CPU tensors,
the CPU tests compare them with the JAX package, and ``chip_smoke.py``
holds every kernel against them on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils._pytree import tree_flatten, tree_unflatten
from torch.utils.checkpoint import checkpoint

from ..sharding.ctx import attention_on_ranks

NEG_INF = -1e30          # score of a masked key, as in the JAX package
BLOCK_K = 512            # keys a step of :func:`mha_blockwise`


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: torch.Tensor | int = 0,
                  kv_positions: torch.Tensor | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """Grouped-query attention with causal / sliding-window masking — the
    plain version of the flash-attention (K3) and decode-attention (K4)
    kernels.

    q: (B, S, H, D); k, v: (B, T, KH, D) with KH | H (q-head h reads kv-head
    h // (H / KH)). ``q_offset`` is the global position of q[:, 0], a scalar
    or one per row ((B,) or (B, 1)); ``kv_positions`` (B, T) tags each kv
    slot with its global position, -1 for an empty slot. Masked scores are
    -1e30, as in the JAX package, so a row without any valid key averages
    all values uniformly. Accumulates in float32 (float64 for float64
    inputs); returns q's dtype.
    """
    split = attention_on_ranks(mha_reference, log_sum_exp, q, k, v,
                               causal=causal, window=window,
                               q_offset=q_offset, kv_positions=kv_positions,
                               scale=scale)
    if split is not None:
        return split
    b, s, h, d = q.shape
    logits = _masked_logits(q, k, causal, window, q_offset, kv_positions,
                            scale)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(logits.dtype))
    return out.reshape(b, s, h, d).to(q.dtype)


def log_sum_exp(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                window: int = 0, q_offset: torch.Tensor | int = 0,
                kv_positions: torch.Tensor | None = None,
                scale: float | None = None, **_) -> torch.Tensor:
    """(B, S, H): the log-sum-exp of each query's masked scores in
    :func:`mha_reference` (the arguments its own), in float32 (float64
    for float64 inputs). Two blocks of keys attended apart merge through
    it (``sharding.ctx.attention_on_ranks``)."""
    b, s, h, _ = q.shape
    lse = torch.logsumexp(_masked_logits(q, k, causal, window, q_offset,
                                         kv_positions, scale), dim=-1)
    return lse.permute(0, 3, 1, 2).reshape(b, s, h)


def _masked_logits(q, k, causal, window, q_offset, kv_positions, scale
                   ) -> torch.Tensor:
    """(B, KH, G, S, T): :func:`mha_reference`'s scaled scores in the
    accumulation dtype, -1e30 where a key is masked."""
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    dev = q.device
    f = _acc_dtype(q)
    qq = q.reshape(b, s, kh, g, d).to(f)
    logits = torch.einsum("bskgd,btkd->bkgst", qq, k.to(f)) * scale
    q_pos = _query_positions(s, q_offset, dev)                   # (1|B, S)
    if kv_positions is None:
        kv_pos = torch.arange(t, device=dev)[None, :]            # (1, T)
        valid = torch.ones((1, t), dtype=torch.bool, device=dev)
    else:
        kv_pos = kv_positions.to(dev)
        valid = kv_pos >= 0
    mask = _key_mask(q_pos, kv_pos, valid, causal, window)       # (B,S,T)
    return torch.where(mask[:, None, None, :, :], logits,
                       torch.full((), NEG_INF, device=dev))


def _query_positions(s: int, q_offset, dev) -> torch.Tensor:
    """(1|B, S): the global position of each query. A Python offset
    stays on the host: no copy, so a CUDA graph can capture the plain
    version."""
    off = (q_offset if isinstance(q_offset, int) else
           torch.as_tensor(q_offset, device=dev).reshape(-1, 1))
    return torch.arange(s, device=dev)[None, :] + off


def _key_mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
              valid: torch.Tensor, causal: bool, window: int
              ) -> torch.Tensor:
    """(1|B, S, T) bool: key t is seen by query s (valid, at or before
    it when causal, inside the window)."""
    mask = valid[:, None, :]
    if causal:
        mask = mask & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    return mask


def recording() -> bool:
    """Whether autograd records here, so a recompute applies: grad mode
    on (a ``torch.func`` ``grad`` or ``vjp`` turns it on inside its
    function). Serving runs under ``no_grad``."""
    return torch.is_grad_enabled()


def _transforms() -> list[str]:
    """The active ``torch.func`` transforms, outermost first (``"Vmap"``,
    ``"Grad"``, ``"Jvp"``, ``"Functionalize"``)."""
    if not torch._C._are_functorch_transforms_active():
        return []
    from torch._functorch.pyfunctorch import \
        retrieve_all_functorch_interpreters
    return [i.key().name for i in retrieve_all_functorch_interpreters()]


def recomputed(fn, *args, context_fn=None):
    """``fn(*args)`` with its activations recomputed in the backward
    instead of kept, the counterpart of ``jax.checkpoint``. Only while
    autograd records: without grad mode (serving) ``fn`` runs plainly.

    * Outside any ``torch.func`` transform: a non-reentrant
      ``torch.utils.checkpoint`` (``context_fn`` a selective policy of
      ``create_selective_checkpoint_contexts``).
    * Under ``vmap`` and one ``grad`` (or ``vjp``), lmstep's client
      program, which refuses the checkpoint's saved-tensor hooks:
      :class:`_Recompute`, which keeps only the tensors among ``args``
      (the weights among them, flattened) and differentiates ``fn`` again
      in the backward; there ``context_fn`` is not applied, so every
      activation is recomputed (``models.layers.remat``'s ``"dots"``
      recomputes as ``"full"`` does).
    * Under ``vmap`` alone nothing records (lmstep's soft label): ``fn``
      runs plainly.
    * Under any other transform (``jvp``, ``functionalize``, a ``grad``
      inside a ``grad``, ``vmap`` inside plain autograd) it raises,
      naming it: the recompute's backward is not differentiated again,
      and under plain autograd its gradients would sum in another order.

    The values are the same on every path. No body recomputed here draws
    random numbers (``tests/test_torch_recompute.py`` runs every family
    under a mode that raises on a draw), so the RNG state is not saved."""
    if not recording():
        return fn(*args)
    active = _transforms()
    if active:
        refused = [t for t in active if t not in ("Vmap", "Grad")]
        if refused or active.count("Grad") > 1 or (
                "Grad" not in active and _autograd_under(args)):
            raise NotImplementedError(
                f"recompute under torch.func {' > '.join(active)}"
                f"{'' if 'Grad' in active else ' inside autograd'}: only "
                "vmap and a single grad/vjp are supported")
        if "Grad" not in active:        # vmap alone: nothing records
            return fn(*args)
        return _recompute_under_transform(fn, args)
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **kw)


def _autograd_under(args) -> bool:
    """Whether a tensor of ``args`` is, beneath its ``vmap`` wrappers, one
    that plain autograd records (``vmap`` inside ``backward()``)."""
    F_ = torch._C._functorch
    for t in tree_flatten(args)[0]:
        if isinstance(t, torch.Tensor):
            while F_.is_batchedtensor(t):
                t = F_.get_unwrapped(t)
            if t.requires_grad:
                return True
    return False


class _Recompute(torch.autograd.Function):
    """``call(*tensors)`` (a tuple of tensors) keeping only ``tensors``
    for the backward, which runs ``call`` again under ``torch.func.vjp``.
    ``generate_vmap_rule`` lets it run under ``vmap``, over per-client
    weights as over shared ones. ``torch.func.grad`` differentiates with
    ``create_graph=True``: the backward's tensors are detached, or that
    graph would keep every recomputed activation until the gradients are
    out (so the backward is not differentiated again, and
    :func:`recomputed` refuses a ``grad`` inside a ``grad``). Its ``vjp``
    takes the grad mode that autograd runs the backward in, as the ops
    around it do: several backward formulas (``silu``'s among them)
    switch to another sum order under grad mode."""
    generate_vmap_rule = True

    @staticmethod
    def forward(call, *tensors):
        return tuple(call(*tensors))

    @staticmethod
    def setup_context(ctx, inputs, output):
        call, *tensors = inputs
        ctx.call = call
        ctx.save_for_backward(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        # detached: nothing here joins the gradients' own graph
        tensors = [t.detach() for t in ctx.saved_tensors]
        live = [i for i, t in enumerate(tensors)
                if ctx.needs_input_grad[i + 1] and t.is_floating_point()]

        def part(*diff):
            full = list(tensors)
            for i, t in zip(live, diff):
                full[i] = t
            return tuple(ctx.call(*full))

        _, vjp_fn = torch.func.vjp(part, *(tensors[i] for i in live))
        got = vjp_fn(tuple(g.detach() for g in grads))
        out = [None] * len(tensors)
        for i, g in zip(live, got):
            out[i] = g
        return (None, *out)


def _recompute_under_transform(fn, args):
    """``fn(*args)`` through :class:`_Recompute`: the tensors among
    ``args`` (nested in lists, tuples and dicts) become its inputs and
    the tensors ``fn`` returns its outputs; the rest stays as it is (a
    layer's aux of 0.0)."""
    leaves, spec = tree_flatten(args)
    at = [i for i, x in enumerate(leaves) if isinstance(x, torch.Tensor)]
    got = {}

    def call(*tensors):
        full = list(leaves)
        for i, t in zip(at, tensors):
            full[i] = t
        outs, got["spec"] = tree_flatten(fn(*tree_unflatten(full, spec)))
        got["rest"] = [_TENSOR if isinstance(x, torch.Tensor) else x
                       for x in outs]
        return [x for x in outs if isinstance(x, torch.Tensor)]

    tensors = iter(_Recompute.apply(call, *(leaves[i] for i in at)))
    outs = [next(tensors) if x is _TENSOR else x for x in got["rest"]]
    return tree_unflatten(outs, got["spec"])


_TENSOR = object()         # a tensor's place among a body's outputs


def mha_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  q_offset: torch.Tensor | int = 0,
                  kv_positions: torch.Tensor | None = None,
                  scale: float | None = None,
                  block_k: int = BLOCK_K) -> torch.Tensor:
    """Blockwise attention with an online softmax, the port of the JAX
    package's ``ref.mha_blockwise``: the arguments and masks of
    :func:`mha_reference`, the keys taken ``block_k`` at a time, T padded
    to a multiple of it with zero keys tagged -1. Each step runs under
    :func:`recomputed`, so the backward recomputes its block's scores and
    never holds (S, T): the activations kept are the (B, KH, G, S) max
    and sum and the (B, KH, G, S, D) accumulator a block. The same values
    as :func:`mha_reference` up to float summation order, except a query
    that sees no key at all, which averages the padded values too, as
    the reference's does. Queries are scaled before the product, as
    there. Accumulates in float32 (float64 for float64 inputs)."""
    split = attention_on_ranks(mha_blockwise, log_sum_exp, q, k, v,
                               causal=causal, window=window,
                               q_offset=q_offset, kv_positions=kv_positions,
                               scale=scale, block_k=block_k)
    if split is not None:
        return split
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = d ** -0.5 if scale is None else scale
    dev, f = q.device, _acc_dtype(q)
    block_k = min(block_k, t)
    pad = (block_k - t % block_k) % block_k
    kp = F.pad(k, (0, 0, 0, 0, 0, pad))
    vp = F.pad(v, (0, 0, 0, 0, 0, pad))
    q_pos = _query_positions(s, q_offset, dev)
    kv_pos = (torch.arange(t, device=dev)[None, :] if kv_positions is None
              else kv_positions.to(dev))
    kv_pos = F.pad(kv_pos, (0, pad), value=-1).expand(b, t + pad)
    qq = q.reshape(b, s, kh, g, d).to(f) * scale
    carry = (torch.full((b, kh, g, s), NEG_INF, dtype=f, device=dev),
             torch.zeros((b, kh, g, s), dtype=f, device=dev),
             torch.zeros((b, kh, g, s, d), dtype=f, device=dev))
    for t0 in range(0, t + pad, block_k):
        blk = slice(t0, t0 + block_k)
        carry = recomputed(_online_block, qq, kp[:, blk], vp[:, blk],
                           kv_pos[:, blk], q_pos, *carry, causal, window)
    _, l_f, acc = carry
    out = acc / l_f.clamp(min=1e-30)[..., None]          # (B, KH, G, S, D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d).to(q.dtype)


def _online_block(qq, kb, vb, posb, q_pos, m_prev, l_prev, acc, causal,
                  window):
    """One key block of :func:`mha_blockwise`: (max, sum, accumulator)
    after the block's scores join the running softmax."""
    f = qq.dtype
    sc = torch.einsum("bskgd,btkd->bkgst", qq, kb.to(f))  # (B,KH,G,S,bk)
    mask = _key_mask(q_pos, posb, posb >= 0, causal, window)
    sc = torch.where(mask[:, None, None, :, :], sc,
                     torch.full((), NEG_INF, dtype=f, device=sc.device))
    m_new = torch.maximum(m_prev, sc.amax(-1))
    p = torch.exp(sc - m_new[..., None])
    alpha = torch.exp(m_prev - m_new)
    l_new = alpha * l_prev + p.sum(-1)
    acc = acc * alpha[..., None] + torch.einsum("bkgst,btkd->bkgsd", p,
                                                vb.to(f))
    return m_new, l_new, acc


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def decode_split_reference(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_positions: torch.Tensor,
                           index: torch.Tensor | int, *, split_len: int,
                           window: int = 0, scale: float | None = None
                           ) -> tuple[torch.Tensor, ...]:
    """The split pass of the decode-attention kernel (K4): each split of
    ``split_len`` cache slots (the last may be shorter) gives, per row and
    query head, its max score m, its sum l = sum exp(s - m) and its
    accumulator acc = sum exp(s - m) v over its own slots. Masked scores
    are -1e30, so a split with no valid slot has m = -1e30 and weighs
    nothing beside one that has. The tests compose it with
    :func:`decode_merge_reference`; the main path does not use it.

    q (B, 1, H, D), k, v (B, T, KH, D), ``kv_positions`` (B, T), ``index``
    a scalar or (B,). Returns m, l (S, B, H) and acc (S, B, H, D) in
    float32 (float64 for float64 inputs).
    """
    b, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    g = h // kh
    f = _acc_dtype(q)
    scale = d ** -0.5 if scale is None else scale
    idx = torch.as_tensor(index, device=q.device).reshape(-1, 1)
    ok = (kv_positions >= 0) & (kv_positions <= idx)
    if window:
        ok = ok & (kv_positions > idx - window)
    s = torch.einsum("bkgd,btkd->bkgt", q.reshape(b, kh, g, d).to(f),
                     k.to(f)) * scale
    s = torch.where(ok[:, None, None, :], s,
                    torch.full((), NEG_INF, dtype=f, device=q.device))
    ms, ls, accs = [], [], []
    for t0 in range(0, t, split_len):
        part = s[..., t0:t0 + split_len]
        m = part.amax(-1)
        p = torch.exp(part - m[..., None])
        ms.append(m.reshape(b, h))
        ls.append(p.sum(-1).reshape(b, h))
        accs.append(torch.einsum("bkgt,btkd->bkgd", p,
                                 v[:, t0:t0 + split_len].to(f))
                    .reshape(b, h, d))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def decode_merge_reference(m: torch.Tensor, l: torch.Tensor,
                           acc: torch.Tensor,
                           dtype: torch.dtype) -> torch.Tensor:
    """The merge kernel of K4: o = sum_s w_s acc_s / max(sum_s w_s l_s,
    1e-30) with w_s = exp(m_s - max_s m_s), from
    :func:`decode_split_reference`'s states. Returns (B, 1, H, D) in
    ``dtype``."""
    w = torch.exp(m - m.amax(0))
    num = (w[..., None] * acc).sum(0)
    den = (w * l).sum(0).clamp_min(1e-30)
    return (num / den[..., None])[:, None].to(dtype)


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                  init_state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Sequential (exact) SSD recurrence, one step per token:
    h_t = exp(dt_t a) h_{t-1} + dt_t x_t (outer) b_t;  y_t = h_t . c_t.

    x (B, L, H, P), dt (B, L, H) (post-softplus), a (H,), b_mat / c_mat
    (B, L, G, N). Returns (y (B, L, H, P) in x's dtype, final state
    (B, H, P, N) float32).
    """
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    rep = h // g
    bh = b_mat.repeat_interleave(rep, dim=2).to(torch.float32)   # (B,L,H,N)
    ch = c_mat.repeat_interleave(rep, dim=2).to(torch.float32)
    decay = torch.exp(dt * a[None, None, :])                     # (B, L, H)
    hstate = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                          device=x.device)
              if init_state is None else init_state.to(torch.float32))
    ys = []
    for t in range(l):
        dx = (dt[:, t, :, None] * x[:, t]).to(torch.float32)    # (B,H,P)
        upd = dx[..., :, None] * bh[:, t, :, None, :]            # (B,H,P,N)
        hstate = decay[:, t, :, None, None] * hstate + upd
        ys.append(torch.einsum("bhpn,bhn->bhp", hstate, ch[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y, hstate


def ssd_chunked_reference(x: torch.Tensor, dt: torch.Tensor,
                          a: torch.Tensor, b_mat: torch.Tensor,
                          c_mat: torch.Tensor, *, chunk: int = 256,
                          init_state: torch.Tensor | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-parallel SSD (Mamba2 Sec. 6) — the plain version of the SSD
    chunk-scan kernel (K5): a quadratic intra-chunk part plus a
    sequential scan of the chunk states. Equal to :func:`ssd_reference`;
    a ragged tail is padded with dt = 0 steps (decay 1, no update), which
    is exact.
    """
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, l)
    if l % q:
        pad = q - l % q
        y, h_t = ssd_chunked_reference(
            _pad_seq(x, pad), _pad_seq(dt, pad), a, _pad_seq(b_mat, pad),
            _pad_seq(c_mat, pad), chunk=q, init_state=init_state)
        return y[:, :l], h_t
    c = l // q
    rep = h // g
    f32 = torch.float32
    bh = b_mat.repeat_interleave(rep, dim=2).reshape(bsz, c, q, h, n)
    ch = c_mat.repeat_interleave(rep, dim=2).reshape(bsz, c, q, h, n)
    xg = x.reshape(bsz, c, q, h, p)
    dtg = dt.reshape(bsz, c, q, h).to(f32)
    adt = dtg * a[None, None, None, :]                       # log decays
    cums = torch.cumsum(adt, dim=2)                           # (B,C,Q,H)

    # intra-chunk (quadratic)
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]     # (B,C,Q,Q,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))
    lmat = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                       torch.zeros((), device=x.device))
    dtx = dtg[..., None] * xg.to(f32)                          # (B,C,Q,H,P)
    cb = torch.einsum("bcqhn,bckhn->bcqkh", ch.to(f32), bh.to(f32))
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", cb * lmat, dtx)

    # chunk summary states
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)       # (B,C,Q,H)
    states = torch.einsum("bcqhn,bcqhp->bchpn",
                          decay_to_end[..., None] * bh.to(f32), dtx)
    chunk_decay = torch.exp(cums[:, :, -1, :])                # (B,C,H)

    # inter-chunk recurrence (sequential over the C chunks)
    hstate = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
              if init_state is None else init_state.to(f32))
    prevs = []
    for ci in range(c):
        prevs.append(hstate)
        hstate = chunk_decay[:, ci, :, None, None] * hstate + states[:, ci]
    h_prevs = torch.stack(prevs, dim=1)                       # (B,C,H,P,N)

    # inter-chunk contribution
    y_off = torch.einsum("bcqhn,bchpn->bcqhp",
                         torch.exp(cums)[..., None] * ch.to(f32), h_prevs)
    y = (y_diag + y_off).reshape(bsz, l, h, p).to(x.dtype)
    return y, hstate


def ssd_chunk_passes_reference(x: torch.Tensor, dt: torch.Tensor,
                               a: torch.Tensor, b_mat: torch.Tensor,
                               c_mat: torch.Tensor, *, chunk: int = 256
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD chunk scan from a zero state, split into the three passes of
    the CUDA kernel (K5); the tests hold it against the Pallas kernel and
    :func:`ssd_chunked_reference`, and the main path does not use it.

    1. chunk states S_c = sum_j exp(cums_Q - cums_j) dt_j x_j (outer) B_j
       and decays exp(cums_Q), and the scores C B^T of each chunk and head
       group (shared by the group's heads), every chunk at once;
    2. the state entering each chunk, h_0 = 0 and h_c+1 = exp(cums_Q) h_c
       + S_c, in chunk order;
    3. chunk outputs y_i = sum_{j<=i} (C_i . B_j) exp(cums_i - cums_j)
       dt_j x_j + exp(cums_i) C_i . h_c, every chunk at once.

    A ragged tail takes dt = 0 steps. Returns (y in x's dtype, final state
    (B, H, P, N) float32).
    """
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    f32 = torch.float32

    def chunks(t):          # (B, L, H or G, W) -> (B, nc, Q, H, W) float32
        t = _pad_seq(t, pad).to(f32).repeat_interleave(h // t.shape[2], 2)
        return t.reshape(bsz, nc, q, h, -1)

    xs, bs, cs = chunks(x), chunks(b_mat), chunks(c_mat)
    dts = _pad_seq(dt.to(f32), pad).reshape(bsz, nc, q, h)
    bg = _pad_seq(b_mat, pad).to(f32).reshape(bsz, nc, q, g, n)
    cg = _pad_seq(c_mat, pad).to(f32).reshape(bsz, nc, q, g, n)
    cums = torch.cumsum(dts * a.to(f32), dim=2)              # (B,nc,Q,H)
    c_last = cums[:, :, -1:, :]

    # 1. chunk states and decays; the scores C B^T, once per head group
    w = torch.exp(c_last - cums) * dts
    states = torch.einsum("bcqhp,bcqhn->bhcpn", w[..., None] * xs, bs)
    decay = torch.exp(c_last[:, :, 0, :]).transpose(1, 2)    # (B, H, nc)
    scores = torch.einsum("bcign,bcjgn->bcijg", cg, bg)       # (B,nc,i,j,G)

    # 2. the state entering each chunk
    hcur = torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
    h_in = []
    for ci in range(nc):
        h_in.append(hcur)
        hcur = decay[:, :, ci, None, None] * hcur + states[:, :, ci]
    h_in = torch.stack(h_in, dim=2)                          # (B,H,nc,P,N)

    # 3. chunk outputs
    seg = cums[:, :, :, None, :] - cums[:, :, None, :, :]    # (B,nc,i,j,H)
    causal = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                   device=x.device))[None, None, :, :, None]
    scale = torch.where(causal, torch.exp(seg),
                        torch.zeros((), device=x.device)) * dts[:, :, None]
    scores = scores.repeat_interleave(h // g, dim=4) * scale
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xs)
    y = y + torch.exp(cums)[..., None] * torch.einsum(
        "bcihn,bhcpn->bcihp", cs, h_in)
    return y.reshape(bsz, nc * q, h, p)[:, :l].to(x.dtype), hcur


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad axis 1 (the sequence axis) at the end by ``pad``."""
    shape = list(t.shape)
    shape[1] = pad
    return torch.cat([t, t.new_zeros(shape)], dim=1)


def entropy_judge_sweep_reference(soft_labels: torch.Tensor,
                                  sizes: torch.Tensor,
                                  mask: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(group_entropy, leave-one-out entropies (M,)) — the plain version of
    the entropy_judge kernel; mirrors core.entropy."""
    from ..core.entropy import group_entropy, leave_one_out_entropies
    p = soft_labels.to(torch.float32)
    w = sizes.to(torch.float32)
    k = mask.to(torch.float32)
    return group_entropy(p, w, k), leave_one_out_entropies(p, w, k)


def pack_judgment(mask: torch.Tensor, order: torch.Tensor, removed: int,
                  ent: torch.Tensor, init_ent: torch.Tensor) -> torch.Tensor:
    """The loop kernel's output layout, one float32 buffer of 2M + 3:
    mask (M) | removal order (M, int32 bits, -1 padded) | number removed
    (int32 bits) | entropy | initial entropy."""
    m = mask.numel()
    buf = torch.empty(2 * m + 3, dtype=torch.float32, device=mask.device)
    buf[:m] = mask
    ints = buf[m:2 * m + 1].view(torch.int32)
    ints[:m] = order
    ints[m] = removed
    buf[2 * m + 1] = ent
    buf[2 * m + 2] = init_ent
    return buf


def unpack_judgment(buf: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Views (mask (M,), removal order (M,) int32, number removed () int32,
    entropy (), initial entropy ()) of a buffer of :func:`pack_judgment`."""
    m = (buf.numel() - 3) // 2
    ints = buf[m:2 * m + 1].view(torch.int32)
    return buf[:m], ints[:m], ints[m], buf[2 * m + 1], buf[2 * m + 2]


def entropy_judge_loop_reference(soft_labels: torch.Tensor,
                                 sizes: torch.Tensor,
                                 active: torch.Tensor | None = None,
                                 protected: torch.Tensor | None = None,
                                 cap: int | None = None) -> torch.Tensor:
    """Algorithm 1's greedy loop, one leave-one-out sweep and one host
    read of the stop flag per iteration — the plain version of the loop
    kernel, with the semantics of ``repro.core.judgment.judge``: the
    candidates are the active rows that are not protected, ``argmax``
    takes the first index among ties, a removal needs
    ``best > ent + 1e-6`` in float32, at most ``cap`` (default M - 1)
    removals. Returns the buffer of :func:`pack_judgment`."""
    from ..core.entropy import group_entropy, leave_one_out_entropies
    from ..core.judgment import _TOL
    p = soft_labels.to(torch.float32)
    dev = p.device
    w = sizes.to(dev, torch.float32)
    m = p.shape[0]
    active = (torch.ones(m, device=dev) if active is None
              else active.to(dev, torch.float32))
    protected = (torch.zeros(m, device=dev) if protected is None
                 else protected.to(dev, torch.float32))
    cap = m - 1 if cap is None else int(cap)

    init_ent = group_entropy(p, w, active)
    mask, ent = active.clone(), init_ent
    order = torch.full((m,), -1, dtype=torch.int32, device=dev)
    removed = 0
    neg_inf = torch.tensor(-float("inf"), device=dev)
    while removed < cap:
        loo = leave_one_out_entropies(p, w, mask)
        # only currently-active, unprotected devices are candidates
        cand = torch.where((mask > 0) & (protected == 0), loo, neg_inf)
        best = torch.argmax(cand)            # first index among ties
        best_ent = cand[best]
        # compared in float32, as the traced reference does
        if not bool(best_ent > ent + _TOL):
            break
        mask[best] = 0.0
        ent = best_ent
        order[removed] = best.to(torch.int32)
        removed += 1
    return pack_judgment(mask, order, removed, ent, init_ent)


def masked_weighted_sum_reference(flat: torch.Tensor,
                                  weights: torch.Tensor) -> torch.Tensor:
    """(P,) = sum_i weights[i] * flat[i, :] — the plain version of the
    fused aggregation kernel. Rows are added in index order and each
    product is rounded before its add, the kernel's own arithmetic, so
    the kernel and this version agree bit for bit."""
    w = weights.to(torch.float32)
    x = flat.to(torch.float32)
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        out = out + w[i] * x[i]
    return out
