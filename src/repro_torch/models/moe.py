"""Top-k MoE with sort-based static-shape dispatch — the port of
``repro.models.moe``'s single-device path (``moe_block_pjit``).

Dispatch, as the reference's:

  1. router top-k over experts in float32 -> (T, k) ids and gate probs
     renormalised over the k (clipped at 1e-9), and the Switch-style aux
     loss ``E * sum_e f_e p_e`` (f_e: the share of assignments routed to
     e, p_e: the mean router probability);
  2. a stable sort of the flat expert ids; position-in-expert = rank -
     first rank of the expert (``searchsorted``);
  3. tokens scattered into an (E, C, D) capacity buffer, C =
     ``capacity(cfg, T)``, assignments at position >= C dropped (the
     reference's ``mode="drop"``); the expert SwiGLU as three batched
     products over all E experts; each assignment's output gathered
     back and weighted by its gate.

The combine differs from the reference in one respect: the reference
adds the (T * k, D) contributions into the token rows with a scatter-add
(``.at[token_of].add``), whose CUDA counterpart ``index_add_`` is atomic
and so not repeatable to the bit. Here each assignment's contribution is
put back at its own (token, slot) place, a permutation with no
collisions, and the k slots of a token are summed in slot order: the
same values up to float summation order, the same bits on every run.
Writes into the buffer go through a dump row past its end, so no step
reads the device's data back to the host.

The expert-parallel ``moe_block_shard_map`` (several cards) is not
ported.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .layers import Dense, normal, pdtype_of


class MoE(nn.Module):
    """The weights under the reference's names: ``router.w`` (D, E),
    ``w_in`` and ``w_gate`` (E, D, F), ``w_out`` (E, F, D), drawn from
    ``gen`` with the reference's scales."""

    def __init__(self, cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        e, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
        self.cfg = cfg
        self.router = Dense(cfg, d, e, gen, scale=0.02)
        self.w_in = normal(gen, (e, d, f), d ** -0.5, pdtype_of(cfg))
        self.w_gate = normal(gen, (e, d, f), d ** -0.5, pdtype_of(cfg))
        self.w_out = normal(gen, (e, f, d), f ** -0.5, pdtype_of(cfg))

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (B, S, D) -> (out (B, S, D), aux loss ())."""
        return moe_block(self.cfg, self, x)


def capacity(cfg: ModelConfig, num_tokens: int) -> int:
    """Slots per expert: T k / E times the capacity factor, rounded up to
    a multiple of 8, at least 4."""
    k, e = cfg.experts_per_token, cfg.num_experts
    c = int(num_tokens * k / e * cfg.moe_capacity_factor)
    return max(4, (c + 7) // 8 * 8)


def route(cfg: ModelConfig, router_w: torch.Tensor, xt: torch.Tensor):
    """xt: (T, D) -> (top_p (T, k), top_i (T, k), aux (), probs (T, E)),
    all in float32."""
    e, k = cfg.num_experts, cfg.experts_per_token
    logits = xt.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    # one-hot by comparison: ``F.one_hot`` checks its values on the host,
    # which ``vmap`` (lmstep's client program) refuses
    hot = top_i[..., None] == torch.arange(e, device=top_i.device)
    f_e = hot.to(torch.float32).sum(1).mean(0)
    p_e = probs.mean(0)
    aux = e * (f_e * p_e).sum()
    return top_p, top_i, aux, probs


def dispatch_indices(top_i: torch.Tensor):
    """Sort-based bookkeeping of the (T, k) assignments: (order,
    sorted_e, pos, token_of), each (T * k,), as the reference's
    ``_dispatch_indices``."""
    t, k = top_i.shape
    flat_e = top_i.reshape(-1)
    order = torch.sort(flat_e, stable=True).indices
    sorted_e = flat_e[order]
    first = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos = torch.arange(t * k, device=top_i.device) - first
    return order, sorted_e, pos, order // k


def positions(top_i: torch.Tensor) -> torch.Tensor:
    """The position within its expert of each assignment, (T * k,) in
    token order (token t's slot j at ``t * k + j``)."""
    order, _, pos, _ = dispatch_indices(top_i)
    out = torch.empty_like(pos)
    out[order] = pos                           # a permutation: no collision
    return out


def dispatch(cfg: ModelConfig, top_i: torch.Tensor, cap: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """(row, kept), each (T * k,) in token order: an assignment's row
    ``e * cap + pos`` of the flattened (E, cap) buffer, or the dump row
    ``E * cap`` when its position is ``cap`` or more (dropped)."""
    pos = positions(top_i)
    kept = pos < cap
    row = torch.where(kept, top_i.reshape(-1) * cap + pos,
                      cfg.num_experts * cap)
    return row, kept


def scatter(xt: torch.Tensor, row: torch.Tensor, num_experts: int,
            cap: int) -> torch.Tensor:
    """The (E, cap, D) capacity buffer: token t's row of ``xt`` at each of
    its assignments' rows (:func:`dispatch`), zeros elsewhere. Every
    dropped assignment lands in the dump row, which is cut off."""
    k = row.numel() // xt.shape[0]
    token = torch.arange(row.numel(), device=xt.device) // k
    buf = xt.new_zeros((num_experts * cap + 1, xt.shape[1]))
    buf = buf.index_copy(0, row, xt[token])
    return buf[:num_experts * cap].view(num_experts, cap, -1)


def experts(p: MoE, buf: torch.Tensor) -> torch.Tensor:
    """The experts' SwiGLU on their (E, C, D) buffers: three batched
    products over all E experts."""
    h = torch.bmm(buf, p.w_in.to(buf.dtype))
    g = torch.bmm(buf, p.w_gate.to(buf.dtype))
    return torch.bmm(F.silu(g) * h, p.w_out.to(buf.dtype))


def combine(y: torch.Tensor, row: torch.Tensor, kept: torch.Tensor,
            top_p: torch.Tensor) -> torch.Tensor:
    """(T, D): each token's k expert outputs from ``y`` (E, C, D), weighted
    by their gates (a dropped one by 0) and summed in slot order."""
    t, k = top_p.shape
    e, cap, d = y.shape
    gathered = y.reshape(e * cap, d)[row.clamp(max=e * cap - 1)]
    contrib = gathered * top_p.reshape(-1, 1).to(y.dtype) * \
        kept[:, None].to(y.dtype)
    return contrib.reshape(t, k, d).sum(1)


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss ()), over the B * S
    tokens of the call (capacity counted on them, as the reference's)."""
    b, s, d = x.shape
    cap = capacity(cfg, b * s)
    xt = x.reshape(b * s, d)
    top_p, top_i, aux, _ = route(cfg, p.router.w, xt)
    row, kept = dispatch(cfg, top_i, cap)
    y = experts(p, scatter(xt, row, cfg.num_experts, cap))
    return combine(y, row, kept, top_p).reshape(b, s, d), aux
