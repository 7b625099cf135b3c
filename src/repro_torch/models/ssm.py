"""Mamba2 (SSD, state-space duality) block [arXiv:2405.21060] — the port
of ``repro.models.ssm``.

One fused ``in_proj`` gives (z, x, B, C, dt); a short depthwise causal
conv runs over (x, B, C); the SSD recurrence
y_t = C_t . h_t,  h_t = exp(dt_t A) h_{t-1} + dt_t x_t (outer) B_t is
evaluated chunk-parallel over a sequence (``kernels.ops.ssd``: the K5
kernel on the ``"cuda"`` route) or one token at a time in decode (plain
ops, as in the JAX package).

Cache per layer: {"conv": (B, ssm_conv - 1, conv_ch), "state": (B, H, P,
N) float32}.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops
from ..sharding.ctx import merge_last, shard_act, splittable
from .layers import (Dense, constant, generator_of, normal, pdtype_of,
                     rms_norm)


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_inner                       # expand * d_model
    heads = d_in // cfg.ssm_headdim
    n = cfg.ssm_state
    g = cfg.ssm_ngroups
    conv_ch = d_in + 2 * g * n                 # conv over (x, B, C)
    proj = 2 * d_in + 2 * g * n + heads        # z, x, B, C, dt
    return d_in, heads, n, g, conv_ch, proj


class SSM(nn.Module):
    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        d_in, heads, n, g, conv_ch, proj = _dims(cfg)
        dev, pdt, f32 = gen.device, pdtype_of(cfg), torch.float32
        self.in_proj = Dense(cfg, cfg.d_model, proj, gen)
        self.conv_w = normal(gen, (cfg.ssm_conv, conv_ch),
                             cfg.ssm_conv ** -0.5, pdt)
        self.conv_b = constant(0.0, (conv_ch,), pdt, dev)
        u = torch.rand((heads,), generator=generator_of(gen), device=dev)
        dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) +
                       math.log(0.001))
        # inverse softplus, so softplus(dt_bias) == dt at init
        self.dt_bias = nn.Parameter(dt + torch.log(-torch.expm1(-dt)))
        self.A_log = nn.Parameter(torch.log(torch.linspace(
            1.0, 16.0, heads, dtype=f32, device=dev)))
        self.D = constant(1.0, (heads,), f32, dev)
        self.norm_scale = constant(1.0, (d_in,), pdt, dev)
        self.out_proj = Dense(cfg, d_in, cfg.d_model, gen)


def _split_proj(cfg, zxbcdt):
    d_in, heads, n, g, _, _ = _dims(cfg)
    z, xc, dt = torch.split(zxbcdt, [d_in, d_in + 2 * g * n, heads], dim=-1)
    return z, xc, dt                           # xc = conv channels (x,B,C)


def _split_conv(cfg, xc):
    d_in, heads, n, g, _, _ = _dims(cfg)
    return torch.split(xc, [d_in, g * n, g * n], dim=-1)


def _causal_conv(w: torch.Tensor, bias: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, L, C) with taps (K, C), then SiLU;
    the taps are added in the JAX package's order."""
    k, l = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + l, :] * w[i][None, None].to(x.dtype)
              for i in range(k))
    return F.silu(out + bias.to(x.dtype))


def ssm_block(cfg: ModelConfig, p: SSM, u: torch.Tensor, *,
              kernels: str = "torch", with_state: bool = False):
    """Full-sequence SSD (train / prefill). u: (B, L, d_model).

    Returns the block output, and with ``with_state`` also the decode
    cache it leaves ({"conv": the last ssm_conv - 1 conv inputs,
    "state": the final SSD state}).
    """
    d_in, heads, n, g, _, _ = _dims(cfg)
    bsz, l, _ = u.shape
    z, xc_raw, dt = _split_proj(cfg, p.in_proj(u))
    xc = _causal_conv(p.conv_w, p.conv_b, xc_raw)
    x, b_mat, c_mat = _split_conv(cfg, xc)
    x = shard_act(splittable(x, -1, heads).reshape(
        bsz, l, heads, cfg.ssm_headdim), ("batch", "seq", "ssm_inner", None))
    b_mat = splittable(b_mat, -1, g).reshape(bsz, l, g, n)
    c_mat = splittable(c_mat, -1, g).reshape(bsz, l, g, n)
    # torch's softplus is the identity above 20, jax.nn.softplus is not;
    # the two differ there by less than 2e-9
    dtf = F.softplus(dt.to(torch.float32) + p.dt_bias)
    a = -torch.exp(p.A_log)
    y, h_t = ops.ssd(x.contiguous(), dtf.contiguous(), a,
                     b_mat.contiguous(), c_mat.contiguous(),
                     chunk=cfg.ssm_chunk, backend=kernels)
    y = merge_last(y + x * p.D[None, None, :, None].to(x.dtype))
    y = rms_norm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    out = shard_act(p.out_proj(y), ("batch", "seq", "embed"))
    if not with_state:
        return out
    return out, {"conv": xc_raw[:, -(cfg.ssm_conv - 1):, :], "state": h_t}


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device) -> dict:
    d_in, heads, n, g, conv_ch, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                            device=device),
        "state": torch.zeros((batch, heads, cfg.ssm_headdim, n),
                             dtype=torch.float32, device=device),
    }


def ssm_decode_step(cfg: ModelConfig, p: SSM, u: torch.Tensor,
                    cache: dict) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step. u: (B, 1, d_model). Returns (out, the
    new cache)."""
    d_in, heads, n, g, conv_ch, _ = _dims(cfg)
    bsz = u.shape[0]
    z, xc, dt = _split_proj(cfg, p.in_proj(u))

    # conv with the carried window: (B, K-1, C) ++ current -> last output
    hist = torch.cat([cache["conv"], xc], dim=1)             # (B, K, C)
    w = p.conv_w.to(xc.dtype)
    conv_out = torch.einsum("bkc,kc->bc", hist, w) + p.conv_b.to(xc.dtype)
    xc1 = F.silu(conv_out)[:, None, :]
    new_conv = hist[:, 1:, :]

    x, b_mat, c_mat = _split_conv(cfg, xc1)
    x = x.reshape(bsz, heads, cfg.ssm_headdim)
    b_mat = b_mat.reshape(bsz, g, n).repeat_interleave(heads // g, dim=1)
    c_mat = c_mat.reshape(bsz, g, n).repeat_interleave(heads // g, dim=1)
    dt1 = F.softplus(dt[:, 0].to(torch.float32) + p.dt_bias)
    a = -torch.exp(p.A_log)

    decay = torch.exp(dt1 * a[None, :])                      # (B, H)
    upd = (dt1[..., None] * x.to(torch.float32))[..., None] * \
        b_mat.to(torch.float32)[:, :, None, :]               # (B,H,P,N)
    state = decay[..., None, None] * cache["state"] + upd
    y = torch.einsum("bhpn,bhn->bhp", state,
                     c_mat.to(torch.float32)).to(u.dtype)
    y = y + x * p.D[None, :, None].to(x.dtype)
    y = y.reshape(bsz, 1, d_in)
    y = rms_norm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    return p.out_proj(y), {"conv": new_conv, "state": state}
