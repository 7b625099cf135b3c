"""Vocab-parallel softmax, log-softmax and target pick over logits whose
last (vocabulary) dim is sharded: the layout GSPMD gives the reference's
``jax.nn.softmax`` on vocab-sharded logits, and Megatron's vocab-parallel
cross entropy.

DTensor's own ``_softmax`` and ``_log_softmax`` gather the vocabulary on
every rank first (a (B/ranks, S, V) float32 tensor a rank: 18.6 GiB at
qwen3-0.6b's train_4k on the production mesh). Here each rank keeps its
vocabulary block (one ``local_map``): per row the local max, an
all-reduce(max) over the vocab's mesh dims, the local sum of
exponentials, an all-reduce(sum); the backward (:class:`_LogSoftmax`)
all-reduces each row's sum of incoming gradients. :func:`pick` takes each
row's target from the rank whose block holds it, a partial sum over the
vocab's mesh dims.

On a plain tensor, and on a DTensor whose last dim is not sharded (a
(1, 1) mesh among them), :func:`log_softmax` and :func:`softmax` are
``torch.log_softmax`` and ``torch.softmax`` of float32, bit for bit.
"""
from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.distributed.tensor.experimental import local_map

from .specs import all_reduce_over, distribute_full, mesh_block


def sharded_dims(x: DTensor, dim: int) -> list[int]:
    """The mesh dims that shard tensor dim ``dim`` of ``x``, major
    first."""
    dim %= x.ndim
    return [i for i, q in enumerate(x.placements) if q.is_shard(dim)]


class _LogSoftmax(torch.autograd.Function):
    """log-softmax of one rank's float32 vocabulary block over the whole
    row: forward max and sum all-reduced over ``dims``; backward
    g - p * sum(g) with the row sum of g all-reduced."""

    @staticmethod
    def forward(ctx, x, mesh, dims):
        m = all_reduce_over(x.detach().amax(-1, keepdim=True), "max",
                            mesh, dims)
        z = x - m
        s = all_reduce_over(torch.exp(z).sum(-1, keepdim=True), "sum",
                            mesh, dims)
        logp = z - torch.log(s)
        ctx.mesh, ctx.dims = mesh, dims
        ctx.save_for_backward(logp)
        return logp

    @staticmethod
    def backward(ctx, g):
        logp, = ctx.saved_tensors
        tot = all_reduce_over(g.sum(-1, keepdim=True), "sum", ctx.mesh,
                              ctx.dims)
        return g - torch.exp(logp) * tot, None, None


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    """float32 log-softmax over the last dim; vocab-parallel on a DTensor
    whose last dim is sharded (the output keeps ``x``'s placements)."""
    x = x.to(torch.float32)
    if not isinstance(x, DTensor) or not sharded_dims(x, -1):
        return torch.log_softmax(x, dim=-1)
    mesh, pl, dims = x.device_mesh, tuple(x.placements), sharded_dims(x, -1)
    fn = local_map(lambda xl: _LogSoftmax.apply(xl, mesh, dims),
                   out_placements=list(pl), in_placements=(pl,),
                   device_mesh=mesh)
    return fn(x)


def softmax(x: torch.Tensor) -> torch.Tensor:
    """float32 softmax over the last dim; vocab-parallel as
    :func:`log_softmax`."""
    x = x.to(torch.float32)
    if not isinstance(x, DTensor) or not sharded_dims(x, -1):
        return torch.softmax(x, dim=-1)
    return torch.exp(log_softmax(x))


def _take_last(logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.take_along_dim(logp, idx[..., None], dim=-1)[..., 0]


def pick(logp: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logp[..., idx]`` at each position, ``idx`` one index a row of
    ``logp``'s leading dims. On DTensors each rank picks from its own
    rows (``local_map``; DTensor's own gather backward builds its zeros
    at the global shape, replicated on every rank); over a sharded last
    dim each rank picks the targets in its block and 0 elsewhere, a
    partial sum over the vocab's mesh dims."""
    if not isinstance(logp, DTensor):
        return _take_last(logp, idx)
    mesh, last = logp.device_mesh, logp.ndim - 1
    rows = tuple(q if q.is_shard() and not q.is_shard(last) else
                 Replicate() for q in logp.placements)
    if not isinstance(idx, DTensor):
        idx = distribute_full(idx, mesh, rows)
    dims = sharded_dims(logp, -1)
    if not dims:
        fn = local_map(_take_last, out_placements=list(rows),
                       in_placements=(rows, rows), device_mesh=mesh,
                       redistribute_inputs=True)
        return fn(logp, idx)
    ranks, block = mesh_block(mesh, dims)
    width = logp.shape[-1] // ranks
    offset = block * width

    def local(lp, ix):
        rel = ix.long() - offset
        inside = (rel >= 0) & (rel < width)
        got = _take_last(lp, rel.clamp(0, width - 1))
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype,
                                                    device=got.device))

    out = [Partial() if i in dims else q for i, q in enumerate(rows)]
    fn = local_map(local, out_placements=out,
                   in_placements=(tuple(logp.placements), rows),
                   device_mesh=mesh, redistribute_inputs=True)
    return fn(logp, idx)
