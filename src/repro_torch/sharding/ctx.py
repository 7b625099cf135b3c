"""Activation-sharding context, the port of ``repro.sharding.ctx``.

Model code annotates hot activations with ``shard_act(x, ("batch",
"seq", "embed"))``. Outside a distribution context (unit tests, the
vmapped FL simulator, every one-card path), and on a plain tensor, this
is the identity; inside ``use_mesh(mesh)`` a DTensor is redistributed to
the placements of its logical axes under the divisibility-aware rule
table (the reference's ``with_sharding_constraint``): the collective
GSPMD would insert there, made explicit.

Inside the context a plain tensor that meets a DTensor in an op counts
as replicated (``implicit_replication``): the model's own constants
(positions, masks, a scalar) need no wrapping. Model definitions so stay
mesh-agnostic.

Where DTensor's own strategy would pick another layout than GSPMD's,
the op runs on each rank's blocks instead (``local_map``), in the layout
the placements fix: a product with an FSDP weight
(:func:`sharded_matmul`), attention over the batch rows and query heads
(:func:`attention_on_ranks`), and in :mod:`.vocab` the softmax over a
sharded vocabulary.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from .specs import (DEFAULT_RULES, all_reduce_over, distribute_full,
                    logical_placements, mesh_block)

_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None)


class ShardingCtx:
    def __init__(self, mesh, rules: dict | None = None):
        self.mesh = mesh
        self.rules = dict(DEFAULT_RULES)
        if rules:
            self.rules.update(rules)

    def placements(self, logical: Sequence[Optional[str]], shape) -> tuple:
        return logical_placements(logical, tuple(shape), self.mesh,
                                  self.rules)

    def constraint(self, x, logical: Sequence[Optional[str]]):
        if not isinstance(x, DTensor):
            return x
        want = self.placements(logical, x.shape)
        if tuple(x.placements) == want:
            return x
        return x.redistribute(x.device_mesh, want)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None):
    tok = _CTX.set(ShardingCtx(mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _CTX.reset(tok)


def current() -> Optional[ShardingCtx]:
    return _CTX.get()


def shard_act(x, logical: Sequence[Optional[str]]):
    ctx = _CTX.get()
    if ctx is None:
        return x
    return ctx.constraint(x, logical)


def splittable(x, dim: int, parts: int):
    """``x`` ready to split its dim ``dim`` into (``parts``, -1): a
    DTensor sharded on that dim over a number of ranks that does not
    divide ``parts`` is gathered on it first (DTensor refuses an uneven
    unflatten where GSPMD would reshard); anything else as it is."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.ndim
    mesh = x.device_mesh
    ranks = 1
    for i, q in enumerate(x.placements):
        if q.is_shard(dim):
            ranks *= mesh.size(i)
    if parts % ranks == 0:
        return x
    return x.redistribute(mesh, [Replicate() if q.is_shard(dim) else q
                                 for q in x.placements])


def _fsdp_gathered(w, x):
    """Weight ``w`` ready for its product with activations ``x``: on each
    mesh dim that splits ``x``'s leading (token) dims, a DTensor ``w``
    sharded there is gathered (``Replicate``), its other dims' shards
    kept; anything else as it is. This is the all-gather of an FSDP
    weight that GSPMD does before the product. Left to itself, DTensor's
    product strategy may instead gather the activations, or their
    gradient: at the LM head the whole global batch's logits gradient on
    every rank. The gradient comes back as a partial sum over those mesh
    dims, which the step reduce-scatters to the weight's placement."""
    if not isinstance(w, DTensor) or not isinstance(x, DTensor):
        return w
    want = tuple(Replicate() if q.is_shard() and p.is_shard()
                 and p.dim < x.ndim - 1 else q
                 for q, p in zip(w.placements, x.placements))
    if want == tuple(w.placements):
        return w
    return w.redistribute(w.device_mesh, want)


def _matmul_placements(x: DTensor, w: DTensor):
    """(x's, out's, x grad's, w grad's placements) of ``x @ w`` computed
    rank by rank, or None where a mesh dim's pair has no local product
    (x Partial; x splitting its contracted dim against w not; w
    splitting a dim that x splits too)."""
    last = x.ndim - 1
    x_in, out, gx, gw = [], [], [], []
    for xp, wp in zip(x.placements, w.placements):
        if isinstance(xp, Partial) or isinstance(wp, Partial):
            return None
        if xp.is_shard() and xp.dim < last:          # tokens split
            if wp.is_shard():
                return None
            x_in.append(xp), out.append(xp), gx.append(xp)
            gw.append(Partial())
        elif xp.is_shard() or wp.is_shard(0):        # contraction split
            if not wp.is_shard(0):
                return None
            x_in.append(Shard(last)), out.append(Partial())
            gx.append(Shard(last)), gw.append(wp)
        elif wp.is_shard(1):                         # outputs split
            x_in.append(xp), out.append(Shard(last))
            gx.append(Partial()), gw.append(wp)
        else:
            x_in.append(xp), out.append(xp), gx.append(xp), gw.append(wp)
    return tuple(x_in), out, tuple(gx), tuple(gw)


def sharded_matmul(x, w):
    """``x @ w``, x (..., K) activations and w (K, N) a weight. On
    DTensors ``w`` is first gathered as an FSDP weight
    (:func:`_fsdp_gathered`) and the product then runs on each rank's
    blocks (``local_map``) in the layout the placements fix: the tokens split where x splits them, the outputs
    where w splits N, a partial sum where both split K. DTensor's own
    product strategy picks by its cost model and may instead gather the
    activations or split a replicated dim that the backward then
    gathers whole (the sequence dim of attention's scores). Anything
    else, and a pair of placements with no local product, is ``x @ w``
    as it is."""
    if not isinstance(x, DTensor) or not isinstance(w, DTensor):
        return x @ w
    w = _fsdp_gathered(w, x)
    pls = _matmul_placements(x, w)
    if pls is None:
        return x @ w
    x_in, out, gx, gw = pls
    fn = local_map(torch.matmul, out_placements=out,
                   in_placements=(x_in, tuple(w.placements)),
                   in_grad_placements=(gx, gw), device_mesh=x.device_mesh,
                   redistribute_inputs=True)
    return fn(x, w)


def attention_on_ranks(fn, lse, q, k, v, **kw):
    """``fn(q, k, v, **kw)``, attention on (B, S, H, D) queries against
    (B, T, KH, D) keys and values (query head h reads kv head
    h // (H / KH); ``kw`` holds ``q_offset``, an int or a tensor of one
    or B rows, and ``kv_positions``, None or (B|1, T)), run on each
    rank's own block (``local_map``) where q, k or v is a DTensor (a
    plain one counts as replicated); None where none is, and the caller
    runs its own body. Each mesh dim takes one part, read off the
    placements, in this order:

    * it splits q's sequence: K and V are gathered on it, and the rank's
      queries are offset by its block (the dry-run's ``--seq-rule``);
    * it splits K and V's key dim (the cache's time under the dry-run's
      ``--kv-time-rule``): q is whole on it, each rank attends over its
      own keys, and the blocks merge through each query's log-sum-exp
      (``lse(q, k, **kw)``, (B, S, H)): one all-reduce(max) and two
      all-reduce(sum). Forward only: it raises where autograd records,
      which the decode step, the one caller with such a cache, never
      does;
    * it splits q's batch rows: K, V and the position tensors split
      alike;
    * it splits q's heads: K and V split alike where these ranks divide
      KH; where they do not, K and V stay whole on it and each rank takes
      the kv heads its query heads read (the mesh coordinate fixes
      which), as GSPMD splits the reference's query heads against
      replicated kv heads;
    * anything else is gathered.

    DTensor's own einsum strategy would instead gather the query heads
    on every rank, or split the scores' sequence and gather it whole in
    the backward."""
    ts = (q, k, v)
    if not any(isinstance(t, DTensor) for t in ts):
        return None
    mesh = next(t.device_mesh for t in ts if isinstance(t, DTensor))
    q, k, v = (t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, (Replicate(),) * mesh.ndim, run_check=False) for t in ts)
    b, s, h = q.shape[:3]
    t_len, kh = k.shape[1], k.shape[2]
    part = []                          # each mesh dim's part
    for qp, kp, vp in zip(q.placements, k.placements, v.placements):
        part.append("seq" if qp.is_shard(1) else
                    "keys" if kp.is_shard(1) and vp.is_shard(1) else
                    "rows" if qp.is_shard(0) else
                    "heads" if qp.is_shard(2) else None)
    dims = {n: [i for i, p in enumerate(part) if p == n]
            for n in ("seq", "keys", "rows", "heads")}
    h_ranks, h_block = mesh_block(mesh, dims["heads"])
    kv_split = kh % h_ranks == 0
    shard = {"seq": Shard(1), "rows": Shard(0), "heads": Shard(2)}
    q_in = tuple(shard.get(p, Replicate()) for p in part)
    kv_in = tuple(Shard(1) if p == "keys" else Shard(0) if p == "rows"
                  else Shard(2) if p == "heads" and kv_split
                  else Replicate() for p in part)
    kv_grad = tuple(Partial() if p == "seq" or (p == "heads" and
                                                not kv_split) else pl
                    for p, pl in zip(part, kv_in))

    # the position tensors: rows split like q's, keys like K's
    def layout(x, keys: bool):
        lead = x.ndim > 0 and x.shape[0] == b
        return tuple(Shard(0) if p == "rows" and lead else
                     Shard(1) if p == "keys" and keys else
                     Replicate() for p in part)

    kv_pos = kw.pop("kv_positions", None)
    if kv_pos is None and dims["keys"]:
        kv_pos = torch.arange(t_len, device=k.to_local().device)[None]
    q_off = kw.pop("q_offset", 0)
    extra = {n: x for n, x in (("q_offset", q_off), ("kv_positions",
                                                     kv_pos))
             if isinstance(x, torch.Tensor)}
    fixed = {n: x for n, x in (("q_offset", q_off), ("kv_positions",
                                                     kv_pos))
             if not isinstance(x, torch.Tensor)}
    ex_pl = tuple(layout(x, n == "kv_positions") for n, x in extra.items())
    extra = {n: x if isinstance(x, DTensor) else
             distribute_full(x, mesh, pl)
             for (n, x), pl in zip(extra.items(), ex_pl)}
    s_ranks, s_block = mesh_block(mesh, dims["seq"])
    hl, g = h // h_ranks, h // kh
    read = [(h_block * hl + j) // g for j in range(hl)]
    if dims["keys"] and torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention over keys split on mesh dims "
            f"{dims['keys']} runs forward only")

    def local(ql, kl, vl, *xs):
        pos = dict(fixed, **dict(zip(extra, xs)))
        if dims["seq"]:
            pos["q_offset"] = pos["q_offset"] + s_block * ql.shape[1]
        if not kv_split:
            idx = torch.tensor(read, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        out = fn(ql, kl, vl, **pos, **kw)
        if not dims["keys"]:
            return out
        lse_r = lse(ql, kl, **pos, **kw)
        m = all_reduce_over(lse_r, "max", mesh, dims["keys"])
        w = torch.exp(lse_r - m)[..., None]
        num = all_reduce_over(w * out.to(w.dtype), "sum", mesh,
                              dims["keys"])
        den = all_reduce_over(w, "sum", mesh, dims["keys"])
        return (num / den).to(out.dtype)

    run = local_map(local, out_placements=list(q_in),
                    in_placements=(q_in, kv_in, kv_in) + ex_pl,
                    in_grad_placements=(q_in, kv_grad, kv_grad) + ex_pl,
                    device_mesh=mesh, redistribute_inputs=True)
    return run(q, k, v, *extra.values())


class _MergeLast(torch.autograd.Function):
    """(..., a, b) -> (..., a * b) on DTensors; the backward makes the
    gradient :func:`splittable` into the a parts before splitting it."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = x.shape
        return x.reshape(*x.shape[:-2], -1)

    @staticmethod
    def backward(ctx, g):
        return splittable(g, -1, ctx.shape[-2]).reshape(ctx.shape)


def merge_last(x):
    """(..., a, b) -> (..., a * b) (heads into features): a plain
    reshape, and on a DTensor one whose gradient is split back safely."""
    if isinstance(x, DTensor):
        return _MergeLast.apply(x)
    return x.reshape(*x.shape[:-2], -1)
