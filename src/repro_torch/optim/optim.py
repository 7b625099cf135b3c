"""Optimizers over trees of tensors — the port of ``repro.optim.optim``.

``sgd``   — SGD with momentum; the paper's local optimizer (lr 0.01,
            momentum 0.5) and the default of the gradient-level FL step.
``adamw`` — AdamW with bias correction, for non-FL baselines and
            fine-tuning.

Each factory returns ``Optimizer(init, update)`` where
``update(grads, state, params) -> (new_params, new_state)`` makes new
tensors and changes none of its arguments. State trees mirror the param
tree (a dict of tensors, such as ``Model.params()``, or any nested dict);
``count`` is an int32 scalar on the params' device, and the moments are
float32, as in the reference.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.utils import _pytree as pytree


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]


def _count(params) -> torch.Tensor:
    leaf = pytree.tree_leaves(params)[0]
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def sgd(lr: float = 0.01, momentum: float = 0.5,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"count": _count(params)}
        return {"mu": pytree.tree_map(torch.zeros_like, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        if weight_decay:
            grads = pytree.tree_map(
                lambda g, p: g + weight_decay * p.to(g.dtype), grads, params)
        if momentum == 0.0:
            new_p = pytree.tree_map(
                lambda p, g: p - (lr * g).to(p.dtype), params, grads)
            return new_p, {"count": state["count"] + 1}
        mu = pytree.tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                             state["mu"], grads)
        new_p = pytree.tree_map(lambda p, m: p - (lr * m).to(p.dtype),
                                params, mu)
        return new_p, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, update)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
        return {"m": pytree.tree_map(z, params),
                "v": pytree.tree_map(z, params),
                "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params):
        c = state["count"] + 1
        m = pytree.tree_map(
            lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
            state["m"], grads)
        v = pytree.tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * g.to(torch.float32) ** 2,
            state["v"], grads)
        # b ** count in float32, as the reference's weakly typed power
        cf = c.to(torch.float32)
        bc1 = 1 - torch.pow(torch.full_like(cf, b1), cf)
        bc2 = 1 - torch.pow(torch.full_like(cf, b2), cf)

        def step(p, m_, v_):
            upd = (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps)
            if weight_decay:
                upd = upd + weight_decay * p.to(torch.float32)
            return p - (lr * upd).to(p.dtype)

        new_p = pytree.tree_map(step, params, m, v)
        return new_p, {"m": m, "v": v, "count": c}

    return Optimizer(init, update)
