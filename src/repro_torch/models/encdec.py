"""Whisper-style encoder-decoder (the audio family) — the port of
``repro.models.encdec``.

The mel-spectrogram and conv frontend is a stub, as in the JAX package:
the encoder takes precomputed frame embeddings (B, encoder_seq, d_model).
Sinusoidal positions on both sides (the JAX package's unbounded form in
place of whisper's learned decoder positions capped at 448).

Encoder: bidirectional self-attention blocks over the frames. Decoder
block: causal self attention, cross attention to the encoder's K and V,
then the MLP. One submodule per layer (``nn.ModuleList``) in place of the
JAX package's stacked layers under ``lax.scan``; a Python loop walks them.
``cfg.remat == "full"`` recomputes each decoder layer in the backward
(``layers.remat``), as the reference checkpoints its decoder scan's
body; the encoder is never checkpointed and ``"dots"`` changes nothing
here, as there. Under lmstep's ``vmap`` and ``grad`` the recompute
applies too (``kernels.ref.recomputed``).

Cache: the decoder's self KV as the transformer's (``layers``: one
{"k", "v"} (B, L, KH, hd) a layer, ``pos`` the slot tags, ``index``),
plus ``cross``: {"k", "v"} of (num_layers, B, encoder_seq, KH, hd), the
encoder's K and V of every decoder layer, written by the prefill and only
read by the decode steps. A decode step writes its self-KV slot in place.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from . import attention as attn
from .layers import MLP, Embed, Norm, dtype_of, remat
from .transformer import _place, _pos_tags


def sinusoidal(positions: torch.Tensor, dim: int) -> torch.Tensor:
    """(...,) int positions -> (..., dim) float32 sinusoidal embeddings,
    with the JAX package's frequencies
    exp(-ln(10000) * arange(half) / max(half - 1, 1)) in float32."""
    half = dim // 2
    log10k = float(torch.tensor(math.log(10000.0), dtype=torch.float32))
    steps = torch.arange(half, dtype=torch.float32,
                         device=positions.device)
    freq = torch.exp(-log10k * steps / max(half - 1, 1))
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class EncBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, gen.device)
        self.attn = attn.Attention(cfg, gen)
        self.ln2 = Norm(cfg, cfg.d_model, gen.device)
        self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, gen)


class DecBlock(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.ln1 = Norm(cfg, cfg.d_model, gen.device)
        self.attn = attn.Attention(cfg, gen)
        self.lnx = Norm(cfg, cfg.d_model, gen.device)
        self.xattn = attn.Attention(cfg, gen, cross=True)
        self.ln2 = Norm(cfg, cfg.d_model, gen.device)
        self.mlp = MLP(cfg, cfg.d_model, cfg.d_ff, gen)


class EncDec(nn.Module):
    """The model's weights, with the parameter names of the JAX tree:
    ``tok``, ``enc_layers.<i>``, ``enc_norm``, ``dec_layers.<i>`` and
    ``final_norm``."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 kernels: str = "torch"):
        super().__init__()
        if cfg.family != "encdec":
            raise ValueError(f"family {cfg.family!r} is not encdec")
        self.cfg, self.kernels = cfg, kernels
        self.tok = Embed(cfg, gen)
        self.enc_layers = nn.ModuleList(
            EncBlock(cfg, gen) for _ in range(cfg.num_encoder_layers))
        self.enc_norm = Norm(cfg, cfg.d_model, gen.device)
        self.dec_layers = nn.ModuleList(
            DecBlock(cfg, gen) for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg, cfg.d_model, gen.device)

    def forward(self, batch: dict, *, window: int | None = None,
                head: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
        """(logits, aux = 0) of the full pass, or with ``head=False``
        (final-norm decoder hidden states, aux); ``Model.apply`` runs it
        over a dict of weights."""
        return (forward if head else hidden)(self, batch, window=window)


def init(cfg: ModelConfig, gen: torch.Generator,
         kernels: str = "torch") -> EncDec:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    return EncDec(cfg, gen, kernels)


def encode(model: EncDec, frames: torch.Tensor) -> torch.Tensor:
    """frames (B, T, d_model), precomputed frontend embeddings -> the
    encoder's final-norm states (B, T, d_model)."""
    cfg = model.cfg
    x = frames.to(dtype_of(cfg))
    t = x.shape[1]
    x = x + sinusoidal(torch.arange(t, device=x.device),
                       cfg.d_model).to(x.dtype)[None]
    for lp in model.enc_layers:
        a, _ = attn.self_attention(cfg, lp.attn, lp.ln1(x), causal=False,
                                   kernels=model.kernels)
        x = x + a
        x = x + lp.mlp(lp.ln2(x))
    return model.enc_norm(x)


def _dec_embed(model: EncDec, tokens: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    x = model.tok(tokens)
    pos = torch.arange(tokens.shape[1], device=x.device) + offset
    return x + sinusoidal(pos, model.cfg.d_model).to(x.dtype)[None]


def _cross_and_mlp(model: EncDec, lp: DecBlock, x: torch.Tensor,
                   enc_kv: dict) -> torch.Tensor:
    """x after the block's cross attention to ``enc_kv`` and its MLP."""
    x = x + attn.cross_attention(model.cfg, lp.xattn, lp.lnx(x), enc_kv,
                                 kernels=model.kernels)
    return x + lp.mlp(lp.ln2(x))


def hidden(model: EncDec, batch: dict, *, window: int | None = None
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Final-norm decoder hidden states (pre-logits), + aux = 0."""
    cfg = model.cfg
    window = cfg.sliding_window if window is None else window
    enc = encode(model, batch["frames"])
    x = _dec_embed(model, batch["tokens"])

    def layer(lp, x, enc_v, enc_k):
        a, _ = attn.self_attention(cfg, lp.attn, lp.ln1(x), causal=True,
                                   window=window, kernels=model.kernels)
        return _cross_and_mlp(model, lp, x + a,
                              attn.cross_kv(cfg, lp.xattn, enc_k, enc_v))

    mode = "full" if cfg.remat == "full" else "none"
    for lp in model.dec_layers:
        # the encoder's output once a use, V's first: under torch.func the
        # recompute hands back a gradient an input, so autograd adds each
        # layer's V and K parts into the encoder's one at a time, in the
        # order it does without the recompute (the same bits)
        x = remat(mode, (lp,), layer, lp, x, enc, enc)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return model.final_norm(x), aux


def forward(model: EncDec, batch: dict, *, window: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """batch {"tokens": (B, S), "frames": (B, T, D)} -> (logits (B, S, V),
    aux = 0)."""
    h, aux = hidden(model, batch, window=window)
    return model.tok.logits(h), aux


def _cross_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                device, fill=torch.zeros) -> dict:
    shape = (cfg.num_layers, batch, cfg.encoder_seq, cfg.num_kv_heads,
             cfg.head_dim)
    return {n: fill(shape, dtype=dtype, device=device) for n in ("k", "v")}


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype | None = None, *, device) -> dict:
    """An empty decode cache: every slot tagged -1, index 0, the cross K
    and V zero."""
    dtype = dtype or dtype_of(cfg)
    return {"index": 0, "pos": _pos_tags(0, cache_len, device),
            "layers": [attn.cache_init(cfg, batch, cache_len, dtype, device)
                       for _ in range(cfg.num_layers)],
            "cross": _cross_init(cfg, batch, dtype, device)}


def prefill(model: EncDec, batch: dict, *, window: int | None = None,
            cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Encode the frames and prefill the prompt: logits (B, S, V) + a
    cache ready for decode at index S, holding every decoder layer's
    cross K and V. ``cache_len`` >= S reserves decode headroom."""
    cfg = model.cfg
    window = cfg.sliding_window if window is None else window
    enc = encode(model, batch["frames"])
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = max(cache_len or s, s)
    x = _dec_embed(model, tokens)
    cross = _cross_init(cfg, b, dtype_of(cfg), x.device, fill=torch.empty)
    kvs = []
    for i, lp in enumerate(model.dec_layers):
        a, kv = attn.self_attention(cfg, lp.attn, lp.ln1(x), causal=True,
                                    window=window, kernels=model.kernels)
        kvs.append({n: _place(t, cache_len) for n, t in kv.items()})
        ckv = attn.cross_kv(cfg, lp.xattn, enc)
        for n in ("k", "v"):
            cross[n][i] = ckv[n]
        x = _cross_and_mlp(model, lp, x + a, {n: cross[n][i]
                                              for n in ("k", "v")})
    cache: dict[str, Any] = {"index": s,
                             "pos": _pos_tags(s, cache_len, x.device),
                             "layers": kvs, "cross": cross}
    return model.tok.logits(model.final_norm(x)), cache


def decode_step(model: EncDec, cache: dict, tokens: torch.Tensor, *,
                window: int | None = None) -> tuple[torch.Tensor, dict]:
    """One-token decode. tokens: (B, 1). Returns (logits (B, 1, V), cache).

    Writes this position's self K, V and tag into the cache in place and
    reads the cross K and V; advances the index."""
    cfg = model.cfg
    window = cfg.sliding_window if window is None else window
    index = cache["index"]
    x = _dec_embed(model, tokens, offset=index)
    cross = cache["cross"]
    for i, lp in enumerate(model.dec_layers):
        a = attn.decode_self_attention(
            cfg, lp.attn, lp.ln1(x), cache["layers"][i], index, cache["pos"],
            window=window, kernels=model.kernels)
        x = _cross_and_mlp(model, lp, x + a, {n: cross[n][i]
                                              for n in ("k", "v")})
    cache["index"] = index + 1
    return model.tok.logits(model.final_norm(x)), cache
