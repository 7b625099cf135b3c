"""Grouped-query attention with qk-norm, RoPE and a position-tagged KV
cache (full-length or ring buffer), and the encoder-decoder family's cross
attention (no RoPE, no qk-norm, over the encoder's cached K and V) — the
port of ``repro.models.attention``.

Cache per layer: {"k": (B, L, KH, hd), "v": (B, L, KH, hd)}; the model
cache also carries {"index": int, "pos": (L,) int32}, where ``pos[slot]``
is the global position held in that slot (-1 = empty). K is stored after
RoPE and ``k_norm``. Unlike the JAX package, a decode step writes its slot
of the cache and the tag row in place, so a step moves one token's K and
V instead of copying the cache.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..configs.base import ModelConfig
from ..kernels import ops
from ..sharding.ctx import merge_last, shard_act, splittable
from .layers import Dense, apply_rope, constant, pdtype_of, rms_norm


class Attention(nn.Module):
    """The q, k, v and output projections; with ``cross`` (an
    encoder-decoder layer's cross attention) no qk-norm scales."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator,
                 cross: bool = False):
        super().__init__()
        d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.w_q = Dense(cfg, d, h * hd, gen, bias=cfg.attn_bias)
        self.w_k = Dense(cfg, d, kh * hd, gen, bias=cfg.attn_bias)
        self.w_v = Dense(cfg, d, kh * hd, gen, bias=cfg.attn_bias)
        self.w_o = Dense(cfg, h * hd, d, gen)
        if cfg.qk_norm and not cross:
            self.q_norm = constant(1.0, (hd,), pdtype_of(cfg), gen.device)
            self.k_norm = constant(1.0, (hd,), pdtype_of(cfg), gen.device)
        else:
            self.q_norm = self.k_norm = None


def _project_q(cfg: ModelConfig, p: Attention, x: torch.Tensor):
    b, s, _ = x.shape
    q = splittable(p.w_q(x), -1, cfg.num_heads).reshape(
        b, s, cfg.num_heads, cfg.head_dim)
    if p.q_norm is not None:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
    return q


def _project_kv(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                x_v: torch.Tensor | None = None):
    """K of ``x`` and V of ``x_v`` (default ``x``)."""
    b, s, _ = x.shape
    x_v = x if x_v is None else x_v
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    k = splittable(p.w_k(x), -1, kh).reshape(b, s, kh, hd)
    v = splittable(p.w_v(x_v), -1, kh).reshape(b, s, kh, hd)
    if p.k_norm is not None:
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    return k, v


def self_attention(cfg: ModelConfig, p: Attention, x: torch.Tensor, *,
                   causal: bool = True, window: int = 0,
                   positions: torch.Tensor | None = None,
                   kernels: str = "torch") -> tuple[torch.Tensor, dict]:
    """Full-sequence self attention (train / prefill) on (B, S, D).
    Returns (out, {"k", "v"}) with K after RoPE."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
    q = _project_q(cfg, p, x)
    k, v = _project_kv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope_style)
    q = shard_act(q, ("batch", "seq", "heads", None))
    k = shard_act(k, ("batch", "seq", "kv_heads", None))
    v = shard_act(v, ("batch", "seq", "kv_heads", None))
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal, window=window, backend=kernels)
    out = shard_act(out, ("batch", "seq", "heads", None))
    out = p.w_o(merge_last(out))
    return shard_act(out, ("batch", "seq", "embed")), {"k": k, "v": v}


def cache_init(cfg: ModelConfig, batch: int, cache_len: int,
               dtype: torch.dtype, device) -> dict:
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_self_attention(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                          kv_cache: dict, index: int,
                          pos_tags: torch.Tensor, *, window: int = 0,
                          kernels: str = "torch") -> torch.Tensor:
    """One decode step of x (B, 1, D) at global position ``index``.

    Writes this token's K, V into slot ``index % L`` of ``kv_cache`` and
    the tag into ``pos_tags``, in place (a ring when L < the sequence),
    then attends over the tagged cache with the position per row.
    """
    b = x.shape[0]
    cache_len = kv_cache["k"].shape[1]
    positions = torch.full((b, 1), index, dtype=torch.int32,
                           device=x.device)
    q = _project_q(cfg, p, x)
    k_new, v_new = _project_kv(cfg, p, x)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope_style)
    k_new = apply_rope(k_new, positions, cfg.rope_theta, cfg.rope_style)

    slot = index % cache_len
    kv_cache["k"][:, slot] = k_new[:, 0].to(kv_cache["k"].dtype)
    kv_cache["v"][:, slot] = v_new[:, 0].to(kv_cache["v"].dtype)
    pos_tags[slot] = index
    out = ops.attention(
        q.contiguous(), kv_cache["k"], kv_cache["v"], causal=True,
        window=window, q_offset=positions[:, 0],
        kv_positions=pos_tags[None].expand(b, cache_len).contiguous(),
        backend=kernels)
    return p.w_o(merge_last(out))


def cross_attention(cfg: ModelConfig, p: Attention, x: torch.Tensor,
                    enc_kv: dict, *, kernels: str = "torch") -> torch.Tensor:
    """Decoder states x (B, S, D) attend, without a mask, to the encoder's
    cached {"k", "v"} (B, T, KH, hd); no RoPE (whisper)."""
    b, s, _ = x.shape
    q = _project_q(cfg, p, x)
    out = ops.attention(q.contiguous(), enc_kv["k"], enc_kv["v"],
                        causal=False, backend=kernels)
    return p.w_o(merge_last(out))


def cross_kv(cfg: ModelConfig, p: Attention, enc_out: torch.Tensor,
             enc_v: torch.Tensor | None = None) -> dict:
    """The cross attention's K and V of the encoder's output (B, T, D)
    (V of ``enc_v`` when given: the same tensor, passed once a use)."""
    k, v = _project_kv(cfg, p, enc_out, enc_v)
    return {"k": k.contiguous(), "v": v.contiguous()}
