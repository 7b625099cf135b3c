"""Decoder-only LM assembled from blocks — the port of
``repro.models.transformer`` for five families:

  dense  — [norm->attn, norm->mlp] x L
  moe    — [norm->attn, norm->moe] x L
  ssm    — [norm->mamba2] x L
  hybrid — groups of (attn_every - 1) ssm blocks + one SHARED attention
           block (zamba2): the shared block's weights live once, its KV
           cache per group.
  vlm    — the dense stack over projected patch embeddings (``patch_proj``)
           prepended to the tokens; logits only on the text slots.

One submodule per layer (``nn.ModuleList``) in place of the JAX package's
stacked layer axis under ``lax.scan``; a Python loop walks them. The
``encdec`` family is :mod:`.encdec`. The kernel route ("torch",
"blockwise" or "cuda") is fixed when the model is built and handed to
every attention and SSD call.

``cfg.remat`` reaches what the reference's ``_maybe_remat`` wraps
(``layers.remat``): one layer of the dense, moe and vlm stacks (its aux
term returned, so the sum over layers is ``backbone``'s), one ssm layer,
one hybrid group (its ssm layers and the shared attention block).
The recompute applies wherever autograd records: a checkpoint under
plain autograd, and under lmstep's ``vmap`` and ``grad`` a function of
the layer's weights and inputs (``kernels.ref.recomputed``); the values
are the same as ``"none"``'s.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from ..sharding import vocab
from . import attention as attn
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import MLP, Dense, Embed, Norm, dtype_of, remat

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def _block_kind(cfg: ModelConfig) -> str:
    """The family's block stack: dense, moe and vlm share the attention
    one."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder-only LM; "
                         f"this module runs {FAMILIES}")
    return "dense" if cfg.family in ("moe", "vlm") else cfg.family


def _hybrid_shape(cfg: ModelConfig) -> tuple[int, int]:
    per = cfg.attn_every - 1                       # ssm blocks per group
    groups = cfg.num_layers // cfg.attn_every
    return groups, per


class AttnBlock(nn.Module):
    """Attention, then the MLP, or for the moe family the MoE block."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, gen.device)
        self.attn = attn.Attention(cfg, gen)
        self.ln2 = Norm(cfg, cfg.d_model, gen.device)
        if cfg.family == "moe":
            self.moe = moe_mod.MoE(cfg, gen)
        else:
            self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, gen)

    def ffn(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(x + the MLP or MoE of ln2(x), the MoE's aux loss or 0)."""
        if hasattr(self, "moe"):
            h, aux = self.moe(self.ln2(x))
            return x + h, aux
        return x + self.mlp(self.ln2(x)), 0.0


class SSMBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, gen.device)
        self.ssm = ssm_mod.SSM(cfg, gen)


class Transformer(nn.Module):
    """The LM's weights, with the parameter names of the JAX tree:
    ``tok``, ``final_norm`` and ``layers.<i>`` or, for the hybrid family,
    ``ssm_layers.<group>.<j>`` and ``shared_attn``; the vlm family's
    ``patch_proj.w`` (d_model, d_model), drawn after the layers."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 kernels: str = "torch"):
        super().__init__()
        kind = _block_kind(cfg)
        self.cfg, self.kernels = cfg, kernels
        self.tok = Embed(cfg, gen)
        self.final_norm = Norm(cfg, cfg.d_model, gen.device)
        if kind == "dense":
            self.layers = nn.ModuleList(
                AttnBlock(cfg, gen) for _ in range(cfg.num_layers))
        elif kind == "ssm":
            self.layers = nn.ModuleList(
                SSMBlock(cfg, gen) for _ in range(cfg.num_layers))
        else:
            groups, per = _hybrid_shape(cfg)
            self.ssm_layers = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, gen) for _ in range(per))
                for _ in range(groups))
            self.shared_attn = AttnBlock(cfg, gen)
        if cfg.family == "vlm":
            self.patch_proj = Dense(cfg, cfg.d_model, cfg.d_model, gen)

    def forward(self, batch: dict, *, window: int | None = None,
                head: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """The full-sequence pass: (logits, aux), or with ``head=False``
        (final-norm hidden states, aux). ``torch.func.functional_call``
        runs it over a dict of weights (``Model.apply``)."""
        return (forward if head else hidden)(self, batch, window=window)


def init(cfg: ModelConfig, gen: torch.Generator,
         kernels: str = "torch") -> Transformer:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    return Transformer(cfg, gen, kernels)


# --------------------------------------------------------------- full pass

def _attn_block(model, p: AttnBlock, x, *, window, positions=None):
    """(x after the block, its KV, its aux loss)."""
    cfg = model.cfg
    h, kv = attn.self_attention(cfg, p.attn, p.ln1(x), causal=True,
                                window=window, positions=positions,
                                kernels=model.kernels)
    x, aux = p.ffn(x + h)
    return x, kv, aux


def _ssm_block(model, p: SSMBlock, x):
    return x + ssm_mod.ssm_block(model.cfg, p.ssm, p.ln1(x),
                                 kernels=model.kernels)


def _ssm_block_with_state(model, p: SSMBlock, x):
    """Like :func:`_ssm_block` but also returns the block's decode cache."""
    o, state = ssm_mod.ssm_block(model.cfg, p.ssm, p.ln1(x),
                                 kernels=model.kernels, with_state=True)
    return x + o, state


def backbone(model: Transformer, x: torch.Tensor, *,
             window: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, S, D) -> (final-norm hidden (B, S, D), aux loss ()).
    Full-sequence pass, each layer (a hybrid group) under ``cfg.remat``."""
    cfg = model.cfg
    window = cfg.sliding_window if window is None else window
    kind = _block_kind(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "dense":
        def layer(lp, x):
            x, _, a = _attn_block(model, lp, x, window=window)
            return x, a

        for lp in model.layers:
            x, a = remat(cfg.remat, (lp,), layer, lp, x)
            aux = aux + a                      # the layers' sum (moe)
    elif kind == "ssm":
        for lp in model.layers:
            x = remat(cfg.remat, (lp,), _ssm_block, model, lp, x)
    else:
        def group_of(group, x):
            for lp in group:
                x = _ssm_block(model, lp, x)
            return _attn_block(model, model.shared_attn, x,
                               window=window)[0]

        for group in model.ssm_layers:
            x = remat(cfg.remat, (group, model.shared_attn), group_of,
                      group, x)
    return model.final_norm(x), aux


def embed_tokens(model: Transformer, batch: dict) -> torch.Tensor:
    """The token embeddings; for the vlm family the projected patches
    (B, num_patches, D) come first."""
    x = model.tok(batch["tokens"])
    if model.cfg.family == "vlm":
        patches = batch["patches"].to(x.dtype)
        x = torch.cat([model.patch_proj(patches), x], dim=1)
    return x


def hidden(model: Transformer, batch: dict, *,
           window: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-norm hidden states over the text positions (pre-logits), +
    aux."""
    h, aux = backbone(model, embed_tokens(model, batch), window=window)
    if model.cfg.family == "vlm":                # logits only on text slots
        h = h[:, model.cfg.num_patches:]
    return h, aux


def forward(model: Transformer, batch: dict, *,
            window: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Training / eval forward. Returns (logits over the text positions
    (B, S, V), aux)."""
    h, aux = hidden(model, batch, window=window)
    return model.tok.logits(h), aux


def token_nll(logits: torch.Tensor, targets: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """(-log p(target), log p) at each position: the float32 log-softmax
    of ``logits`` over the last axis, gathered at ``targets``. On
    DTensors each rank picks from its own positions, and over
    vocab-sharded logits both are vocab-parallel
    (:mod:`..sharding.vocab`), log p keeping the logits' layout:
    DTensor's own gather backward builds its zeros at the global shape
    on every rank (637 GB a rank for qwen3-0.6b's train_4k on the
    production mesh) and its softmax gathers the vocabulary."""
    logp = vocab.log_softmax(logits)
    return -vocab.pick(logp, targets.long()), logp


def lm_loss(cfg: ModelConfig, logits: torch.Tensor, tokens: torch.Tensor,
            weights: torch.Tensor | None = None) -> torch.Tensor:
    """Next-token cross entropy in float32. logits: (B, S, V); tokens:
    (B, S); ``weights`` (B, S) weigh each target position (the first
    column is unused)."""
    nll, _ = token_nll(logits[:, :-1], tokens[:, 1:])
    if weights is not None:
        w = weights[:, 1:]
        return (nll * w).sum() / w.sum().clamp(min=1e-9)
    return nll.mean()


# --------------------------------------------------------------- serving

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype | None = None, *, device) -> dict:
    """An empty decode cache: every slot tagged -1, index 0."""
    dtype = dtype or dtype_of(cfg)
    kind = _block_kind(cfg)
    cache: dict[str, Any] = {"index": 0}
    if kind == "dense":
        cache["pos"] = _pos_tags(0, cache_len, device)
        cache["layers"] = [attn.cache_init(cfg, batch, cache_len, dtype,
                                           device)
                           for _ in range(cfg.num_layers)]
    elif kind == "ssm":
        cache["layers"] = [ssm_mod.ssm_cache_init(cfg, batch, dtype, device)
                           for _ in range(cfg.num_layers)]
    else:
        groups, per = _hybrid_shape(cfg)
        cache["pos"] = _pos_tags(0, cache_len, device)
        cache["ssm"] = [[ssm_mod.ssm_cache_init(cfg, batch, dtype, device)
                         for _ in range(per)] for _ in range(groups)]
        cache["attn"] = [attn.cache_init(cfg, batch, cache_len, dtype,
                                         device) for _ in range(groups)]
    return cache


def decode_step(model: Transformer, cache: dict, tokens: torch.Tensor, *,
                window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode. tokens: (B, 1). Returns (logits (B, 1, V), cache).

    Updates ``cache`` in place (the KV slot and tag of this position, the
    SSM states, the index) and returns it.
    """
    cfg = model.cfg
    window = cfg.sliding_window if window is None else window
    kind = _block_kind(cfg)
    index = cache["index"]
    x = model.tok(tokens)

    def attn_step(p: AttnBlock, x, kv_cache):
        a = attn.decode_self_attention(
            cfg, p.attn, p.ln1(x), kv_cache, index, cache["pos"],
            window=window, kernels=model.kernels)
        return p.ffn(x + a)[0]

    def ssm_step(p: SSMBlock, x, state):
        o, new = ssm_mod.ssm_decode_step(cfg, p.ssm, p.ln1(x), state)
        return x + o, new

    if kind == "dense":
        for lp, lc in zip(model.layers, cache["layers"]):
            x = attn_step(lp, x, lc)
    elif kind == "ssm":
        for i, lp in enumerate(model.layers):
            x, cache["layers"][i] = ssm_step(lp, x, cache["layers"][i])
    else:
        for gi, group in enumerate(model.ssm_layers):
            states = cache["ssm"][gi]
            for j, lp in enumerate(group):
                x, states[j] = ssm_step(lp, x, states[j])
            x = attn_step(model.shared_attn, x, cache["attn"][gi])
    cache["index"] = index + 1
    return model.tok.logits(model.final_norm(x)), cache


def _place(kv: torch.Tensor, cache_len: int) -> torch.Tensor:
    """Put prefill KV (B, S, KH, hd) at the head of a cache_len buffer."""
    b, s, kh, hd = kv.shape
    if cache_len == s:
        return kv.contiguous()
    out = kv.new_zeros((b, cache_len, kh, hd))
    out[:, :s] = kv
    return out


def _pos_tags(s: int, cache_len: int, device) -> torch.Tensor:
    tags = torch.full((cache_len,), -1, dtype=torch.int32, device=device)
    tags[:s] = torch.arange(s, dtype=torch.int32, device=device)
    return tags


def prefill(model: Transformer, batch: dict, *, window: int | None = None,
            cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Full-sequence prefill: logits (B, S, V) + a cache ready for decode
    at index S (the vlm family: logits over the S text slots, the cache at
    index num_patches + S).

    ``cache_len`` >= S reserves decode headroom (it defaults to S, which
    makes the cache a ring that evicts at once — pass the full expected
    context for exact decoding).
    """
    cfg = model.cfg
    window = cfg.sliding_window if window is None else window
    kind = _block_kind(cfg)
    x = embed_tokens(model, batch)
    b, s, _ = x.shape
    cache_len = max(cache_len or s, s)
    positions = torch.arange(s, device=x.device)[None].expand(b, s)
    cache: dict[str, Any] = {"index": s}
    if kind == "dense":
        kvs = []
        for lp in model.layers:
            x, kv, _ = _attn_block(model, lp, x, window=window,
                                   positions=positions)
            kvs.append({n: _place(t, cache_len) for n, t in kv.items()})
        cache["layers"] = kvs
        cache["pos"] = _pos_tags(s, cache_len, x.device)
    elif kind == "ssm":
        states = []
        for lp in model.layers:
            x, st = _ssm_block_with_state(model, lp, x)
            states.append(st)
        cache["layers"] = states
    else:
        ssm_states, kvs = [], []
        for group in model.ssm_layers:
            sts = []
            for lp in group:
                x, st = _ssm_block_with_state(model, lp, x)
                sts.append(st)
            ssm_states.append(sts)
            x, kv, _ = _attn_block(model, model.shared_attn, x,
                                   window=window, positions=positions)
            kvs.append({n: _place(t, cache_len) for n, t in kv.items()})
        cache["ssm"] = ssm_states
        cache["attn"] = kvs
        cache["pos"] = _pos_tags(s, cache_len, x.device)
    if cfg.family == "vlm":
        x = x[:, cfg.num_patches:]
    return model.tok.logits(model.final_norm(x)), cache
