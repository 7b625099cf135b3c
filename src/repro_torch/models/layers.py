"""Shared building blocks of the LM models — the port of
``repro.models.layers``: norms, dense layers, the MLP, RoPE, the
embedding and the logits.

Modules hold the weights under the JAX package's names (``w``, ``b``,
``scale``, ``embed``, ``head``), so ``convert.lm_params_from_numpy`` maps
a JAX parameter tree onto a state dict key by key; the arithmetic is in
plain functions on tensors. Every module draws its initial weights from
an explicit ``torch.Generator`` on the device the weights live on, or,
for a build on the meta device, from :class:`NoDraws`, which draws
nothing.
"""
from __future__ import annotations

from contextlib import ExitStack
from functools import partial

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.nn.utils.stateless import _reparametrize_module
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ModelConfig
from ..kernels.ref import recomputed, recording
from ..sharding.ctx import shard_act, sharded_matmul

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.param_dtype]


class NoDraws:
    """The generator of a build on the meta device: the same modules,
    parameter names and shapes as a build anywhere else, with no storage
    and nothing drawn (a meta tensor has no values)."""
    device = torch.device("meta")


def generator_of(gen) -> torch.Generator | None:
    """The generator to draw from: ``gen``, or None for :class:`NoDraws`
    (a draw on the meta device makes only a shape)."""
    return None if isinstance(gen, NoDraws) else gen


def normal(gen: torch.Generator, shape, std: float,
           dtype: torch.dtype) -> nn.Parameter:
    """A parameter of N(0, std^2) draws from ``gen``, on its device."""
    w = torch.randn(shape, generator=generator_of(gen),
                    device=gen.device) * std
    return nn.Parameter(w.to(dtype))


def constant(value: float, shape, dtype: torch.dtype,
             device) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


# ------------------------------------------------------------------ norms

def norm_apply(x: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor | None = None, *, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, computed in float32."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * scale.to(torch.float32) + bias.to(torch.float32)
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * scale.to(torch.float32)
    return y.to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    return norm_apply(x, scale, kind="rmsnorm", eps=eps)


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, dim: int, device):
        super().__init__()
        self.kind, self.eps = cfg.norm, cfg.norm_eps
        self.scale = constant(1.0, (dim,), pdtype_of(cfg), device)
        self.bias = (constant(0.0, (dim,), pdtype_of(cfg), device)
                     if cfg.norm == "layernorm" else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return norm_apply(x, self.scale, self.bias, kind=self.kind,
                          eps=self.eps)


# ------------------------------------------------------------------ linear

def dense_apply(w: torch.Tensor, b: torch.Tensor | None,
                x: torch.Tensor) -> torch.Tensor:
    y = sharded_matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


class Dense(nn.Module):
    """``x @ w (+ b)`` with w (din, dout), the JAX package's layout."""

    def __init__(self, cfg: ModelConfig, din: int, dout: int,
                 gen: torch.Generator, bias: bool = False,
                 scale: float | None = None):
        super().__init__()
        std = scale if scale is not None else din ** -0.5
        self.w = normal(gen, (din, dout), std, pdtype_of(cfg))
        self.b = (constant(0.0, (dout,), pdtype_of(cfg), gen.device)
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense_apply(self.w, self.b, x)


# ------------------------------------------------------------------ MLP

class MLP(nn.Module):
    def __init__(self, cfg: ModelConfig, d: int, f: int,
                 gen: torch.Generator):
        super().__init__()
        self.activation = cfg.activation
        self.w_in = Dense(cfg, d, f, gen,
                          bias=cfg.attn_bias and cfg.family == "encdec")
        self.w_out = Dense(cfg, f, d, gen)
        self.w_gate = (Dense(cfg, d, f, gen)
                       if cfg.activation in ("silu", "geglu") else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation; torch's to erf
        h = self.w_in(x)
        if self.activation == "silu":
            h = F.silu(self.w_gate(x)) * h
        elif self.activation == "geglu":
            h = F.gelu(self.w_gate(x), approximate="tanh") * h
        else:
            h = F.gelu(h, approximate="tanh")
        h = shard_act(h, ("batch", "seq", "ffn"))
        return shard_act(self.w_out(h), ("batch", "seq", "embed"))


# ------------------------------------------------------------------ RoPE

def rope_freqs(rot_dim: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32,
                                         device=device) / rot_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               style: str = "full") -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. style full|half|none.

    Rotates interleaved pairs (x[..., 0::2], x[..., 1::2]), as the JAX
    package does, not the half-split ``rotate_half``. ``half`` is
    ChatGLM's 2d RoPE: only the first hd/2 channels rotate.
    """
    if style == "none":
        return x
    hd = x.shape[-1]
    rot = hd if style == "full" else hd // 2
    freqs = rope_freqs(rot, theta, x.device)                   # (rot/2,)
    ang = positions[..., None].to(torch.float32) * freqs       # (B,S,rot/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)


# ------------------------------------------------------------------ embed

def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding(tokens, table)``. On DTensors the lookup runs on each
    rank's ids against the table's whole rows (``local_map``): DTensor's
    own vocab-sharded lookup (``MaskPartial``) mis-shapes its mask for
    batch-sharded ids and its backward cannot join a tied head's partial
    gradient, so the vocab dim is gathered first, as GSPMD gathers around
    a gather it cannot shard. The output keeps the ids' sharding and the
    table's embed-dim sharding on the mesh dims the ids leave free; the
    table's gradient is a partial sum over the mesh dims the ids split."""
    if not isinstance(tokens, DTensor):
        return F.embedding(tokens, table)
    mesh = tokens.device_mesh
    t_pl = tuple(tokens.placements)
    w_pl = tuple(q if q.is_shard(1) and not t_pl[i].is_shard() else
                 Replicate() for i, q in enumerate(table.placements))
    out_pl = tuple(t if t.is_shard() else
                   (Shard(tokens.ndim) if w.is_shard() else Replicate())
                   for t, w in zip(t_pl, w_pl))
    g_pl = tuple(w if w.is_shard() else
                 (Partial() if t.is_shard() else Replicate())
                 for t, w in zip(t_pl, w_pl))
    fn = local_map(F.embedding, out_placements=list(out_pl),
                   in_placements=(t_pl, w_pl),
                   in_grad_placements=(t_pl, g_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(tokens, table)


class Embed(nn.Module):
    """Token embedding (padded vocabulary) and the output logits."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.cfg = cfg
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = normal(gen, (v, d), d ** -0.5, pdtype_of(cfg))
        self.head = (None if cfg.tie_embeddings else
                     normal(gen, (d, v), d ** -0.5, pdtype_of(cfg)))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding, not ``embed[tokens]``: under ``vmap(grad(...))`` the
        # indexing's backward adds repeated tokens' rows in a varying
        # order on the CPU, and a round must repeat to the bit
        x = embed_lookup(tokens, self.embed.to(dtype_of(self.cfg)))
        if self.cfg.embed_scale:
            x = x * self.cfg.d_model ** 0.5
        return shard_act(x, ("batch", "seq", "embed"))

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return logits_apply(self.cfg, {"embed": self.embed,
                                       "head": self.head}, x)


def logits_apply(cfg: ModelConfig, tok: dict,
                 x: torch.Tensor) -> torch.Tensor:
    """Logits (..., padded vocab) of hidden states ``x`` from the ``tok``
    weights (``embed``, and ``head`` when untied), the padded vocabulary
    slots masked to -1e9 (probability 0 after a softmax). Over a mesh
    the weight is gathered to its vocab shard first
    (:func:`..sharding.ctx.sharded_matmul`), so the logits and their
    gradient stay split over the batch and the vocabulary."""
    if cfg.tie_embeddings:
        logits = sharded_matmul(x, tok["embed"].to(x.dtype).T)
    else:
        logits = sharded_matmul(x, tok["head"].to(x.dtype))
    logits = shard_act(logits, ("batch", "seq", "vocab"))
    v = cfg.padded_vocab
    if v != cfg.vocab_size:                 # mask padded vocab slots
        real = torch.arange(v, device=x.device) < cfg.vocab_size
        logits = torch.where(real, logits,
                             torch.full((), -1e9, dtype=logits.dtype,
                                        device=x.device))
    return logits


# ------------------------------------------------------------------ remat

REMATS = ("none", "full", "dots")
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: the
    products without batch dims (every ``Dense``, an ``aten.mm``) are
    kept, everything else recomputed, ``aten.bmm`` (attention's
    einsums, the experts' batched products) among it."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(mode: str, modules, fn, *args):
    """``fn(*args)`` under ``cfg.remat``, the reference's
    ``_maybe_remat``: ``"none"`` keeps every activation for the
    backward, ``"full"`` recomputes the body's (only its inputs kept),
    ``"dots"`` keeps the outputs of the products without batch dims
    (:func:`_dots_policy`). ``modules`` are those whose weights ``fn``
    reads: the weights in them now (under ``functional_call``, the
    caller's leaves) are put back into them for the recomputation, which
    runs in the backward, after ``functional_call`` has restored the
    module's own. The recompute is :func:`.ref.recomputed`'s: a
    checkpoint under plain autograd, under ``vmap`` and ``grad`` (lmstep)
    a function of the flattened weights and ``args``; without grad mode
    ``fn`` runs plainly. Under ``torch.func`` ``"dots"`` recomputes as
    ``"full"`` does: a dispatch-mode policy sits beneath ``vmap`` and
    sees a ``Dense``'s product as an ``mm`` while the weights are shared
    and as a ``bmm`` once they are per client, like attention's batched
    products (ROADMAP F11). The values never depend on the mode."""
    if mode not in REMATS:
        raise ValueError(f"remat {mode!r}; expected one of {REMATS}")
    if mode == "none" or not recording():
        return fn(*args)
    weights = [dict(m.named_parameters()) for m in modules]

    def body(weights, *args):
        with ExitStack() as stack:
            for m, w in zip(modules, weights):
                stack.enter_context(_reparametrize_module(m, w))
            return fn(*args)

    policy = (partial(create_selective_checkpoint_contexts, _dots_policy)
              if mode == "dots" else None)
    return recomputed(body, weights, *args, context_fn=policy)
