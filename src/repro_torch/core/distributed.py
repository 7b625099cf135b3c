"""FedEntropy at the gradient level: the paper's round as ONE train step —
the one-card part of ``repro.core.distributed``.

The global batch is tiled into M client groups along the batch axis
(client-major rows: rows ``[i * B/M, (i + 1) * B/M)`` are client i's).
With one local step (E = 1), masked FedAvg of per-client gradients is
exactly the gradient of the mask-and-size-weighted loss, so the whole
round is one forward and one backward:

  1. forward -> logits; per-client soft labels = mean softmax over the
     client's tokens (paper Eq. 2), detached;
  2. maximum-entropy judgment (Alg. 1) -> mask (M,): ``judge_fn``, on
     the ``"cuda"`` route one launch of K1's loop that reads nothing back;
  3. loss = sum_m mask_m size_m loss_m / sum_m mask_m size_m (paper Alg. 2
     line 21 at the gradient level); ``torch.autograd.grad`` reuses the
     forward's activations.

The step differentiates with ``torch.autograd`` over leaf copies of the
params, not with ``torch.func.grad``: the judge's CUDA kernel is a C call
on raw device pointers, which a ``torch.func`` transform cannot give it
(a tensor inside one has no storage to point at), while under plain
autograd the detached soft labels are ordinary tensors. The reference
calls its judge inside ``jax.grad`` under ``stop_gradient``.

Soft labels stay full-vocabulary (paper Eq. 2), over the padded vocab:
the masked slots carry probability 0. On one card the reference's
``shard_act`` constraints are the identity; the logical-axis rules of its
meshes wait for the several-card slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models.api import Model
from ..models.layers import logits_apply
from ..models.transformer import token_nll
from ..optim import Optimizer
from .judgment import judge


@dataclass(frozen=True)
class FedSpec:
    num_clients: int = 16          # M client groups tiled over the batch
    enabled: bool = True           # False -> plain data-parallel baseline
    eps_tol: float = 1e-6
    # stream the vocab projection + CE + soft-label accumulation in
    # sequence chunks instead of materialising (B, S, V) logits
    chunked_head: bool = False
    seq_chunk: int = 512


def _tok_params(params: dict) -> dict:
    """The output head's weights (``embed``, ``head``) out of a
    ``Model.params()`` dict."""
    return {k[len("tok."):]: v for k, v in params.items()
            if k.startswith("tok.")}


def chunked_head_stats(cfg: ModelConfig, tok_params: dict, h: torch.Tensor,
                       tokens: torch.Tensor, m: int, seq_chunk: int = 512
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-client (loss (M,), soft labels (M, V)) without a full logits
    tensor: a loop over sequence chunks computes the vocab projection,
    next-token CE and softmax accumulation per chunk and drops the chunk's
    logits; each chunk is recomputed for the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so
    head activations peak at O(B * seq_chunk * V), not O(B * S * V).
    ``tok_params``: ``embed`` (and ``head`` when untied)."""
    b, s, _ = h.shape
    sc = min(seq_chunk, s)
    # target for position j is tokens[j + 1]; weight 0 at j >= S - 1
    tgt = torch.nn.functional.pad(tokens[:, 1:].long(), (0, 1))

    def chunk(hc, tc, b0):
        nll, logp = token_nll(logits_apply(cfg, tok_params, hc), tc)
        pos = b0 + torch.arange(hc.shape[1], device=h.device)[None, :]
        wgt = (pos < s - 1).to(torch.float32)           # next-token mask
        probs = logp.detach().exp()
        return ((nll * wgt).reshape(m, -1).sum(1),
                probs.reshape(m, -1, probs.shape[-1]).sum(1))

    nll_sum = soft_sum = 0
    for b0 in range(0, s, sc):
        n, p = checkpoint(chunk, h[:, b0:b0 + sc], tgt[:, b0:b0 + sc], b0,
                          use_reentrant=False)
        nll_sum, soft_sum = nll_sum + n, soft_sum + p
    per_client = nll_sum / ((s - 1) * (b // m))
    soft = soft_sum / (s * (b // m))
    return per_client, soft


def per_client_soft_labels(logits: torch.Tensor, m: int) -> torch.Tensor:
    """(B, S, V) -> (M, V) mean softmax per client group (paper Eq. 2)."""
    b, s, v = logits.shape
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return probs.reshape(m, (b // m) * s, v).mean(dim=1)


def _per_client_loss(cfg: ModelConfig, logits, tokens, m: int):
    """(M,) mean next-token CE per client group."""
    nll, _ = token_nll(logits[:, :-1], tokens[:, 1:])
    return nll.reshape(m, -1).mean(dim=1)


def _grad_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum()
                          for g in grads.values()))


def _judged(fed: FedSpec, judge_fn, soft, sizes, device):
    """(mask, entropy, initial entropy), detached; all ones and zeros
    when judgment is off."""
    m = fed.num_clients
    if not fed.enabled:
        zero = torch.zeros((), device=device)
        return torch.ones(m, device=device), zero, zero
    jr = judge_fn(soft.detach(), sizes.detach())
    return (jr.mask.detach().to(torch.float32), jr.entropy,
            jr.initial_entropy)


def _update_donated(opt: Optimizer, grads: dict, state: dict,
                    params: dict) -> tuple[dict, dict]:
    """``opt.update`` one leaf at a time, each new leaf written into the
    donated ``params`` and ``state`` and each gradient dropped once used:
    the reference's ``jax.jit(step, donate_argnums=(0, 1))``. The same
    arithmetic on the same values as one ``opt.update`` of the whole
    tree, so the same bits; at the peak, params, state and gradients and
    one leaf's temporaries, not a second params and state. ``state``'s
    entries that mirror the params are dicts; the others (``count``) are
    taken from the last leaf's update, each leaf's computed from the old
    ones."""
    scalars = {}
    for k in list(grads):
        sub = {n: ({k: v[k]} if isinstance(v, dict) else v)
               for n, v in state.items()}
        new_p, new_s = opt.update({k: grads.pop(k)}, sub, {k: params[k]})
        params[k].copy_(new_p[k])
        for n, v in new_s.items():
            if isinstance(v, dict):
                state[n][k].copy_(v[k])
            else:
                scalars[n] = v
    state.update(scalars)
    return params, state


def make_train_step(model: Model, opt: Optimizer, fed: FedSpec,
                    judge_fn: Callable | None = None, *,
                    donate: bool = False) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params,
    opt_state, metrics)`` over a ``Model.params()``-shaped dict. ``batch``
    needs ``tokens`` (B, S) on the model's device, B a multiple of M, and
    optionally ``client_sizes`` (M,) (default uniform). With ``donate``
    the step writes the new params and state into the tensors of
    ``params`` and ``opt_state`` and returns those (the reference jits
    the step with ``donate_argnums=(0, 1)``): the caller gives them up,
    and the step holds one copy of each instead of two
    (:func:`_update_donated`).

    ``judge_fn`` is the judge axis: ``(soft (M, V), sizes (M,)) ->
    JudgmentResult``, default the plain float32 loop; pass a judge's
    ``traced(backend)`` (``"cuda"``: one launch of K1's loop). The metric
    keys are the reference's: loss, aux_loss, mask, num_positive,
    entropy, entropy_initial, per_client_loss, grad_norm (tensors on the
    device; the step reads nothing back)."""
    cfg = model.cfg
    if judge_fn is None:
        judge_fn = judge

    def train_step(params, opt_state, batch):
        tokens = batch["tokens"]
        m = fed.num_clients
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        sizes = batch.get("client_sizes")
        sizes = (torch.ones(m, device=tokens.device) if sizes is None
                 else sizes.to(tokens.device, torch.float32))
        with torch.enable_grad():
            if fed.chunked_head:
                h, aux = model.apply_hidden(leaves, batch)
                client_loss, soft = chunked_head_stats(
                    cfg, _tok_params(leaves), h, tokens, m, fed.seq_chunk)
            else:
                logits, aux = model.apply(leaves, batch)
                client_loss = _per_client_loss(cfg, logits, tokens, m)
                soft = (per_client_soft_labels(logits.detach(), m)
                        if fed.enabled else None)
            mask, ent, ent0 = _judged(fed, judge_fn, soft, sizes,
                                      tokens.device)
            w = mask * sizes
            loss = (w * client_loss).sum() / w.sum().clamp(min=1e-9)
            loss = loss + cfg.router_aux_weight * aux
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        del leaves
        metrics = {
            "loss": loss.detach(),
            "aux_loss": aux.detach(),
            "mask": mask,
            "num_positive": mask.sum(),
            "entropy": ent,
            "entropy_initial": ent0,
            "per_client_loss": client_loss.detach(),
            "grad_norm": _grad_norm(grads),
        }
        if donate:
            new_params, new_state = _update_donated(opt, grads, opt_state,
                                                    params)
        else:
            new_params, new_state = opt.update(grads, opt_state, params)
        return new_params, new_state, metrics

    return train_step


def _split(batch: dict, m: int, n: int) -> list[dict]:
    """The batch's n microbatches, each keeping every client's rows
    (client-major): (B, ...) -> n x (M * B/M/n, ...)."""
    def sp(x):
        per = x.shape[0] // m
        x2 = x.reshape(m, n, per // n, *x.shape[1:])
        return [x2[:, i].reshape(m * (per // n), *x.shape[1:])
                for i in range(n)]
    parts = {k: sp(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def make_microbatched_train_step(model: Model, opt: Optimizer, fed: FedSpec,
                                 num_microbatches: int,
                                 judge_fn: Callable | None = None
                                 ) -> Callable:
    """The two-phase microbatched round — the paper's two-stage protocol
    made literal, and the memory lever when a full global batch's
    activations do not fit:

    Phase 1 (stage 1): a forward-only pass over the microbatches
    accumulates per-client soft labels; judge ONCE on the full batch's
    soft labels (the unbatched step's mask). Phase 2 (stage 2):
    gradients accumulated over the same microbatches with the judged mask
    weighting each client's loss.

    ``judge_fn`` as in :func:`make_train_step`.
    """
    cfg = model.cfg
    if judge_fn is None:
        judge_fn = judge
    n = num_microbatches

    def train_step(params, opt_state, batch):
        m = fed.num_clients
        mbs = _split({k: v for k, v in batch.items()
                      if k != "client_sizes"}, m, n)
        dev = batch["tokens"].device
        sizes = torch.ones(m, device=dev)
        soft = None
        if fed.enabled:
            with torch.no_grad():
                soft = sum(per_client_soft_labels(model.apply(params, mb)[0],
                                                  m) for mb in mbs) / n
        mask, ent, ent0 = _judged(fed, judge_fn, soft, sizes, dev)
        w = mask * sizes
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=dev)
                 for k, v in params.items()}
        loss_sum, cl_sum = 0.0, 0.0
        for mb in mbs:
            with torch.enable_grad():
                logits, aux = model.apply(leaves, mb)
                cl = _per_client_loss(cfg, logits, mb["tokens"], m)
                loss = (w * cl).sum() / w.sum().clamp(min=1e-9)
                total = loss + cfg.router_aux_weight * aux
            for k, g in zip(leaves, torch.autograd.grad(
                    total, list(leaves.values()))):
                grads[k] += g
            loss_sum = loss_sum + loss.detach()
            cl_sum = cl_sum + cl.detach()
        grads = {k: g / n for k, g in grads.items()}
        new_params, new_state = opt.update(grads, opt_state, params)
        metrics = {
            "loss": loss_sum / n,
            "mask": mask,
            "num_positive": mask.sum(),
            "entropy": ent,
            "entropy_initial": ent0,
            "per_client_loss": cl_sum / n,
        }
        return new_params, new_state, metrics

    return train_step


def make_serve_steps(model: Model, *, window: int | None = None):
    """(prefill_step, decode_step) for the serving shapes, over the
    model's own weights (``Model.prefill`` / ``decode_step``: the
    ``params`` argument of the reference's steps is the model here)."""
    def prefill_step(batch, cache_len: int | None = None):
        return model.prefill(batch, window=window, cache_len=cache_len)

    def decode_step(cache, tokens):
        return model.decode_step(cache, tokens, window=window)

    return prefill_step, decode_step
