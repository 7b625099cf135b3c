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
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from .specs import DEFAULT_RULES, logical_placements

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
