"""Local client-update rules (``ClientUpdate`` in paper Alg. 2 line 11).

FedEntropy is optimizer-agnostic (paper Sec. 3.4 / Table 3): the judgment
wraps any of these local strategies, the paper's baselines:

* ``fedavg``   — E epochs of minibatch SGD(+momentum) on CE loss.
* ``fedprox``  — + (mu/2)||w - w_global||^2 proximal term  [Li et al. 2020].
* ``scaffold`` — control-variate-corrected SGD; client variate update
                 "option II": c_i+ = c_i - c + (w_g - w_i)/(K*eta)
                 [Karimireddy et al. 2020]. Doubles uplink payload.
* ``moon``     — model-contrastive term between current, global and previous
                 local representations [Li et al. 2021].

``client_update`` is written for ONE client and mapped over the cohort's
client axis with ``torch.func.vmap`` (see ``fl.server``), as the JAX
package vmaps it: under vmap each convolution with per-client weights
becomes one grouped convolution over the whole cohort. Per-sample
``weight`` masks make padded client datasets exact.

The model is abstracted as ``apply(params, x) -> (logits, features)`` on
a dict of tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch.func import grad
from torch.utils import _pytree as pytree

Params = Any
ApplyFn = Callable[[Params, torch.Tensor], tuple[torch.Tensor, torch.Tensor]]


@dataclass(frozen=True)
class LocalSpec:
    strategy: str = "fedavg"          # fedavg | fedprox | scaffold | moon
    lr: float = 0.01                  # paper Sec. 4.1
    momentum: float = 0.5             # paper Sec. 4.1
    epochs: int = 5                   # paper E = 5
    batch_size: int = 50              # paper Sec. 4.1
    prox_mu: float = 0.01             # paper's FedProx mu
    moon_mu: float = 0.1              # paper's Moon mu
    moon_tau: float = 0.5             # paper's Moon temperature
    scaffold_lr_g: float = 1.0        # paper's SCAFFOLD global step size


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels.long()[..., None], dim=-1)[..., 0]
    if weights is None:
        return nll.mean()
    return (nll * weights).sum() / weights.sum().clamp(min=1e-12)


def _sqnorm_diff(a, b):
    return sum(((x - y.to(x.dtype)) ** 2).sum()
               for x, y in zip(pytree.tree_leaves(a), pytree.tree_leaves(b)))


def _moon_term(z, z_glob, z_prev, tau):
    """-log( e^{sim(z,zg)/tau} / (e^{sim(z,zg)/tau} + e^{sim(z,zp)/tau}) )."""
    def cos(a, b):
        a = a / a.norm(dim=-1, keepdim=True).clamp(min=1e-9)
        b = b / b.norm(dim=-1, keepdim=True).clamp(min=1e-9)
        return (a * b).sum(dim=-1)
    pos = cos(z, z_glob) / tau
    neg = cos(z, z_prev) / tau
    return (torch.logaddexp(pos, neg) - pos).mean()


def client_update(apply_fn: ApplyFn, global_params: Params, data: dict,
                  spec: LocalSpec, *, prev_params: Params | None = None,
                  c_local: Params | None = None,
                  c_global: Params | None = None) -> dict:
    """Run E local epochs; return new params (+ strategy state + soft label).

    data: x (S, ...), y (S,), w (S,) sample mask. The dataset is consumed
    in fixed minibatches and the tail that does not fill one is dropped
    (nb = S // bs); sample weights keep padded entries exact (zero loss
    and zero soft-label mass).

    ``prev_params`` (moon) adds the contrastive term against the global
    and previous models' features, which come from forward passes that
    are not differentiated; ``c_local``/``c_global`` (scaffold) correct
    each gradient by ``- c_i + c`` before momentum, and the output then
    carries the option-II variate ``c_local`` and its change ``c_delta``.
    """
    x, y, w = data["x"], data["y"], data["w"]
    s = x.shape[0]
    bs = min(spec.batch_size, s)
    nb = s // bs
    moon = spec.strategy == "moon" and prev_params is not None
    scaffold = spec.strategy == "scaffold" and c_local is not None

    def loss_fn(p, bx, by, bw, zg, zp):
        logits, feats = apply_fn(p, bx)
        loss = cross_entropy(logits, by, bw)
        if spec.strategy == "fedprox":
            loss = loss + 0.5 * spec.prox_mu * _sqnorm_diff(p, global_params)
        elif moon:
            loss = loss + spec.moon_mu * _moon_term(feats, zg, zp,
                                                    spec.moon_tau)
        return loss

    grad_fn = grad(loss_fn)
    params = global_params
    mom = pytree.tree_map(torch.zeros_like, params)
    for _ in range(spec.epochs):
        for b in range(nb):
            sl = slice(b * bs, (b + 1) * bs)
            zg = zp = None
            if moon:
                zg = apply_fn(global_params, x[sl])[1]
                zp = apply_fn(prev_params, x[sl])[1]
            g = grad_fn(params, x[sl], y[sl], w[sl], zg, zp)
            if scaffold:
                g = pytree.tree_map(lambda gi, ci, cg: gi - ci + cg,
                                    g, c_local, c_global)
            mom = pytree.tree_map(lambda m, gi: spec.momentum * m + gi,
                                  mom, g)
            params = pytree.tree_map(lambda pi, m: pi - spec.lr * m,
                                     params, mom)

    # ---- soft label (paper Eq. 2) over the WHOLE local dataset -----------
    logits, _ = apply_fn(params, x)
    probs = F.softmax(logits, dim=-1)
    size = w.sum()
    soft = (w @ probs) / size.clamp(min=1e-12)
    out = {"params": params, "soft_label": soft, "size": size}

    if scaffold:
        k = nb * spec.epochs
        new_c = pytree.tree_map(
            lambda ci, cg, wg, wi: ci - cg + (wg - wi) / (k * spec.lr),
            c_local, c_global, global_params, params)
        out["c_local"] = new_c
        out["c_delta"] = pytree.tree_map(lambda a, b: a - b, new_c, c_local)
    return out
