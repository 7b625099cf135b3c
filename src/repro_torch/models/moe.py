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

Over a mesh (``sharding.ctx.use_mesh``) ``moe_block`` takes the
expert-parallel :func:`moe_block_shard_map`, the reference's GShard-style
path, where the mesh has a ``"model"`` axis that divides the experts and
the batch divides the batch axes; otherwise the single-device block
above, each rank running its own batch rows with the whole call's
routing and capacity (:func:`moe_block_pjit`).
"""
from __future__ import annotations

import math

import torch
import torch.distributed._functional_collectives as funcol
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from ..configs.base import ModelConfig
from ..sharding.ctx import current, shard_act
from ..sharding.specs import (all_reduce_over, distribute_full, mesh_block,
                              mesh_shape, placements)
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
    k = cfg.experts_per_token
    logits = xt.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    return top_p, top_i, aux_loss(cfg, *shares(cfg, top_i, probs)), probs


def shares(cfg: ModelConfig, top_i: torch.Tensor, probs: torch.Tensor
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(f_e, p_e), each (E,): the share of the (T, k) assignments routed
    to each expert, and its mean router probability over the T tokens."""
    # one-hot by comparison: ``F.one_hot`` checks its values on the host,
    # which ``vmap`` (lmstep's client program) refuses
    hot = top_i[..., None] == torch.arange(cfg.num_experts,
                                           device=top_i.device)
    return hot.to(torch.float32).sum(1).mean(0), probs.mean(0)


def aux_loss(cfg: ModelConfig, f_e: torch.Tensor, p_e: torch.Tensor
             ) -> torch.Tensor:
    """The Switch-style load-balancing loss ``E * sum_e f_e p_e``."""
    return cfg.num_experts * (f_e * p_e).sum()


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
    return expert_products(p.w_in, p.w_gate, p.w_out, buf)


def expert_products(w_in: torch.Tensor, w_gate: torch.Tensor,
                    w_out: torch.Tensor, buf: torch.Tensor) -> torch.Tensor:
    """The SwiGLU of each expert of ``w_*`` (E, D, F) / (E, F, D) on its
    (E, C, D) buffer."""
    h = torch.bmm(buf, w_in.to(buf.dtype))
    g = torch.bmm(buf, w_gate.to(buf.dtype))
    return torch.bmm(F.silu(g) * h, w_out.to(buf.dtype))


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


def _batch_axes(shape: dict) -> tuple:
    return tuple(a for a in ("pod", "data") if a in shape)


def moe_block(cfg: ModelConfig, p: MoE, x: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D), aux loss ()).

    The expert-parallel :func:`moe_block_shard_map` when a mesh context
    with a ``"model"`` axis that divides the experts is active and the
    batch divides the batch axes; otherwise :func:`moe_block_pjit`."""
    c = current()
    if c is not None:
        shape = mesh_shape(c.mesh)
        n_batch = math.prod(shape[a] for a in _batch_axes(shape))
        if "model" in shape and cfg.num_experts % shape["model"] == 0 \
                and x.shape[0] % n_batch == 0:
            return moe_block_shard_map(cfg, p, x, c.mesh)
    return moe_block_pjit(cfg, p, x)


def moe_block_pjit(cfg: ModelConfig, p: MoE, x: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The single-device block over the B * S tokens of the call
    (capacity counted on them, as the reference's). On a DTensor each
    rank runs its own batch rows (:func:`_moe_rows`, one ``local_map``;
    a batch not split over the mesh is one block, run whole on every
    rank) with the call's routing and capacity: the same values as the
    single-device block."""
    w = (p.router.w, p.w_in, p.w_gate, p.w_out)
    if not isinstance(x, DTensor):
        out, aux = _moe_rows(cfg, None, [], x, *w)
        return shard_act(out, ("batch", "seq", "embed")), aux
    mesh = x.device_mesh
    rep = (Replicate(),) * mesh.ndim
    x_in = tuple(q if q.is_shard(0) else Replicate() for q in x.placements)
    rows = [i for i, q in enumerate(x_in) if q.is_shard(0)]
    w_grad = tuple(Partial() if i in rows else Replicate()
                   for i in range(mesh.ndim))
    fn = local_map(lambda *a: _moe_rows(cfg, mesh, rows, *a),
                   out_placements=(x_in, rep),
                   in_placements=(x_in,) + (rep,) * 4,
                   in_grad_placements=(x_in,) + (w_grad,) * 4,
                   device_mesh=mesh, redistribute_inputs=True)
    out, aux = fn(x, *w)
    return shard_act(out, ("batch", "seq", "embed")), aux


class _SumOverRanks(torch.autograd.Function):
    """The sum of each rank's tensor over mesh ``dims`` (an all-reduce),
    for a value that every rank then uses alike; the backward passes each
    rank's gradient on unchanged."""

    @staticmethod
    def forward(ctx, t, mesh, dims):
        return all_reduce_over(t, "sum", mesh, dims)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _sum_over(t: torch.Tensor, mesh, dims: list) -> torch.Tensor:
    return _SumOverRanks.apply(t, mesh, dims) if dims else t


def _moe_rows(cfg: ModelConfig, mesh, dims: list, xb: torch.Tensor,
              router_w, w_in, w_gate, w_out
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """One rank's rows of :func:`moe_block_pjit` over a batch split on
    mesh ``dims`` (none: the whole call, on one device or on every rank
    alike): the rank routes its own tokens; the aux loss's per-expert
    shares are averaged and every rank's expert ids gathered over the
    ranks, so the dispatch, the capacity and what is dropped are the
    whole call's; the rank writes its tokens into the (E, C, D) buffer,
    which is summed over the ranks; every rank runs the experts on it
    and combines its own tokens. The weights' gradients are partial sums
    over ``dims``."""
    b, s, d = xb.shape
    k = cfg.experts_per_token
    t_loc = b * s
    ranks, block = mesh_block(mesh, dims)
    cap = capacity(cfg, t_loc * ranks)
    xt = xb.reshape(t_loc, d)
    top_p, top_i, _, probs = route(cfg, router_w, xt)
    f_e, p_e = (_sum_over(t, mesh, dims) / ranks
                for t in shares(cfg, top_i, probs))
    every = top_i
    for i in reversed(dims):               # minor mesh dim first
        every = funcol.wait_tensor(funcol.all_gather_tensor(
            every, gather_dim=0, group=(mesh, i)))
    row, kept = dispatch(cfg, every, cap)
    own = slice(block * t_loc * k, (block + 1) * t_loc * k)
    row, kept = row[own], kept[own]
    buf = _sum_over(scatter(xt, row, cfg.num_experts, cap), mesh, dims)
    y = expert_products(w_in, w_gate, w_out, buf)
    return (combine(y, row, kept, top_p).reshape(b, s, d),
            aux_loss(cfg, f_e, p_e))


class _ScaleGrad(torch.autograd.Function):
    """The identity, its gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _replicas(pl: tuple, mesh) -> int:
    """How many ranks hold each block of a tensor in placements ``pl``:
    the product of the mesh dims it is not sharded on."""
    return math.prod(mesh.size(i) for i, q in enumerate(pl)
                     if not q.is_shard())


def _exchange(buf: torch.Tensor, group, ep: int) -> torch.Tensor:
    """(E, C, D) -> (E / ep, ep * C, D): each rank of the ``"model"``
    group gets its experts' slots from every rank, concatenated on the
    capacity axis in rank order (the reference's tiled
    ``all_to_all(split_axis=0, concat_axis=1)``)."""
    e, c, d = buf.shape
    got = funcol.all_to_all_single_autograd(buf.contiguous(), None, None,
                                            group)
    return got.reshape(ep, e // ep, c, d).transpose(0, 1).reshape(
        e // ep, ep * c, d)


def _exchange_back(y: torch.Tensor, group, ep: int) -> torch.Tensor:
    """(E / ep, ep * C, D) -> (E, C, D), the inverse of
    :func:`_exchange`: each rank's slots back from every expert."""
    el, epc, d = y.shape
    c = epc // ep
    send = y.reshape(el, ep, c, d).transpose(0, 1).contiguous()
    got = funcol.all_to_all_single_autograd(send, None, None, group)
    return got.reshape(ep * el, c, d)


def token_split(bsz: int, s: int, mesh) -> tuple[tuple, int, tuple]:
    """(the tokens' spec (B, S, D), tokens a rank, the mesh axes they
    split over): the sequence over ``"model"`` where it divides, else
    the batch, else the tokens replicate over ``"model"`` (tiny decode
    batches), the reference's three cases."""
    shape = mesh_shape(mesh)
    batch_axes = _batch_axes(shape)
    n_batch = math.prod(shape[a] for a in batch_axes)
    ep = shape["model"]
    b_loc = bsz // n_batch
    lead = batch_axes if batch_axes else None
    if s % ep == 0:
        return (lead, "model", None), b_loc * (s // ep), \
            batch_axes + ("model",)
    if b_loc % ep == 0:
        return (batch_axes + ("model",), None, None), (b_loc // ep) * s, \
            batch_axes + ("model",)
    return (lead, None, None), b_loc * s, batch_axes


def moe_block_shard_map(cfg: ModelConfig, p: MoE, x: torch.Tensor,
                        mesh) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh`` (a ``DeviceMesh`` with a
    ``"model"`` axis), the reference's ``moe_block_shard_map``:
    ``local_map`` of one rank's block with explicit collectives (the
    functional ``all_to_all_single_autograd``, through which gradients
    flow).

    Experts live on ``"model"``; their weights enter all-gathered over
    the batch axes (the input's redistribution). Each rank routes its own
    tokens (:func:`token_split`) with the capacity of its share,
    ``capacity(cfg, t_loc)``; packs its (E, C_loc, D) buffer; one
    ``all_to_all`` over ``"model"`` hands each rank its experts' slots
    from every rank, (E / ep, ep * C_loc, D); the expert products run
    locally; the ``all_to_all`` back returns each rank's slots; the
    combine is local. ``aux`` is the mean of the ranks' over the ranks
    the tokens split over. Capacity, and so what is dropped, is per
    shard: the result is the reference's shard_map path's, not
    ``moe_block``'s.

    The gradient follows the reference's ``shard_map`` with
    ``check_rep=False``: an input's gradient is a partial sum over the
    mesh dims it is replicated on, and an output's incoming gradient is
    divided by the number of ranks holding each of its blocks. A plain
    ``x`` (every rank holding the same whole batch) is split here and
    the outputs come back whole; a DTensor comes back a DTensor."""
    bsz, s, d = x.shape
    shape = mesh_shape(mesh)
    ep = shape["model"]
    model_dim = list(shape).index("model")
    spec, t_loc, tok_axes = token_split(bsz, s, mesh)
    cap = capacity(cfg, t_loc)
    group = mesh.get_group("model")
    x_pl = placements(spec, mesh)
    rep = (Replicate(),) * mesh.ndim
    w_pl = tuple(Shard(0) if i == model_dim else Replicate()
                 for i in range(mesh.ndim))
    # each rank's aux, one entry a rank of the token split: a DTensor
    # (n_tok,) whose mean is the reference's pmean over the token axes
    aux_pl = tuple(Shard(0) if a in tok_axes else Replicate()
                   for a in shape)
    out_scale = 1.0 / _replicas(x_pl, mesh)
    aux_scale = 1.0 / _replicas(aux_pl, mesh)
    grad_pl = [tuple(q if q.is_shard() else Partial() for q in pl)
               for pl in (x_pl, rep, w_pl, w_pl, w_pl)]

    def local(xb, router_w, w_in, w_gate, w_out):
        xt = xb.reshape(-1, d)                          # (T_loc, D)
        top_p, top_i, aux, _ = route(cfg, router_w, xt)
        row, kept = dispatch(cfg, top_i, cap)
        buf = _exchange(scatter(xt, row, cfg.num_experts, cap), group, ep)
        y = _exchange_back(expert_products(w_in, w_gate, w_out, buf),
                           group, ep)                   # (E, C, D)
        out = combine(y, row, kept, top_p).reshape(xb.shape)
        aux = aux.reshape(1)
        if out_scale != 1.0:
            out = _ScaleGrad.apply(out, out_scale)
        if aux_scale != 1.0:
            aux = _ScaleGrad.apply(aux, aux_scale)
        return out, aux

    fn = local_map(local, out_placements=(x_pl, aux_pl),
                   in_placements=(x_pl, rep, w_pl, w_pl, w_pl),
                   in_grad_placements=tuple(grad_pl), device_mesh=mesh,
                   redistribute_inputs=True)
    plain = not isinstance(x, DTensor)
    if plain:
        x = distribute_full(x, mesh, x_pl)
    w = [t if isinstance(t, DTensor) else
         DTensor.from_local(t, mesh, rep, run_check=False)
         for t in (p.router.w, p.w_in, p.w_gate, p.w_out)]
    out, aux = fn(x, *w)
    aux = aux.mean()
    if plain:
        return out.full_tensor(), aux.full_tensor()
    return out, aux
