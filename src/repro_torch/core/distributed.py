"""FedEntropy at the gradient level: the paper's round as ONE train step —
the port of ``repro.core.distributed``, on one card or over a mesh.

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
the masked slots carry probability 0.

Over a mesh (the step called under ``sharding.ctx.use_mesh(mesh)``, one
process a rank of a ``torch.distributed`` group): the params are
DTensors in whatever layout the caller gave (:func:`lay_out_params`:
replicated, as the reference's ``run_mesh_engine`` leaves them, or by
:func:`param_logical_axes`, the dry-run's), the batch is laid out on the
``"batch"`` rule (``batch_logical_axes``), every op of the model runs on
DTensors and the ``shard_act`` sites redistribute the hot activations,
as the reference's ``with_sharding_constraint`` under pjit. The
products run on each rank's blocks after the FSDP weight's gather
(``sharding.ctx.sharded_matmul``), so the logits and their gradient
stay split over the batch and the vocabulary, and the softmax,
log-softmax and target pick are vocab-parallel (``sharding.vocab``).
The soft labels are gathered to a plain tensor on every rank, so the
judge (K1's loop on the ``"cuda"`` route) reads raw device memory; every
rank judges the same (M, V) and gets the same mask, which re-enters as a
replicated DTensor. Each gradient is redistributed to its parameter's
placement (an all-reduce or a reduce-scatter of the partial sums) before
the update; the metrics come back as plain, replicated tensors. The
microbatched step runs under a mesh the same way. Outside a context the
steps are the one-card steps above, op for op.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor import zeros as dtensor_zeros
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models.api import Model
from ..models.layers import logits_apply
from ..models.transformer import token_nll
from ..optim import Optimizer
from ..sharding import vocab
from ..sharding.ctx import current, shard_act
from ..sharding.specs import distribute_full, tree_shardings
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
    return per_client, shard_act(soft, ("fl_clients", "vocab"))


def per_client_soft_labels(logits: torch.Tensor, m: int) -> torch.Tensor:
    """(B, S, V) -> (M, V) mean softmax per client group (paper Eq. 2)."""
    b, s, v = logits.shape
    probs = vocab.softmax(logits)
    soft = probs.reshape(m, (b // m) * s, v).mean(dim=1)
    return shard_act(soft, ("fl_clients", "vocab"))


def _per_client_loss(cfg: ModelConfig, logits, tokens, m: int):
    """(M,) mean next-token CE per client group."""
    nll, _ = token_nll(logits[:, :-1], tokens[:, 1:])
    return nll.reshape(m, -1).mean(dim=1)


def _grad_norm(grads: dict) -> torch.Tensor:
    return torch.sqrt(sum((g.to(torch.float32) ** 2).sum()
                          for g in grads.values()))


# ------------------------------------------------------------------ mesh

def _full(x):
    """The whole value of a DTensor as a plain tensor on every rank (a
    gather or a reduction where it is sharded or partial); anything else
    as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def replicated(x: torch.Tensor, mesh) -> DTensor:
    """A plain tensor that every rank holds alike, as a replicated
    DTensor (no collective)."""
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def placed_like(g, p):
    """Gradient ``g`` in the placement of its parameter ``p`` (partial
    sums all-reduced or reduce-scattered), never ``Partial``; a plain
    ``g`` as it is."""
    if isinstance(p, DTensor) and tuple(g.placements) != \
            tuple(p.placements):
        g = g.redistribute(p.device_mesh, p.placements)
    return g


def batch_logical_axes(batch: dict) -> dict:
    """Logical axes of each batch input (the reference dry-run's
    ``batch_logical``): the batch dim of ``tokens``, ``patches`` and
    ``frames``, the cache's by :func:`cache_logical_axes`; anything else
    (``client_sizes``) replicated."""
    out = {}
    for k, v in batch.items():
        if k == "cache":
            out[k] = cache_logical_axes(v)
        elif k in ("tokens", "patches", "frames"):
            out[k] = ("batch",) + (None,) * (v.ndim - 1)
        else:
            out[k] = (None,) * v.ndim
    return out


def distribute_batch(batch: dict, ctx) -> dict:
    """The batch's plain tensors as DTensors on their logical axes under
    ``ctx`` (each rank holds the whole batch; DTensors stay as they are);
    ``client_sizes`` stays plain, the judge's input."""
    axes = batch_logical_axes(batch)

    def put(v, ax):
        if isinstance(v, dict):
            return {k: put(v[k], ax[k]) for k in v}
        if isinstance(v, list):
            return [put(x, a) for x, a in zip(v, ax)]
        if not isinstance(v, torch.Tensor) or isinstance(v, DTensor):
            return v
        return distribute_full(v, ctx.mesh, ctx.placements(ax, v.shape))

    return {k: (v if k == "client_sizes" else put(v, axes[k]))
            for k, v in batch.items()}


LAYOUTS = ("replicated", "logical")


def lay_out_params(params: dict, mesh, layout: str = "replicated",
                   rules: dict | None = None) -> dict:
    """A ``Model.params()`` dict (every rank holding the same values) as
    DTensors on ``mesh``: ``"replicated"`` on every rank, as the
    reference's ``run_mesh_engine`` leaves its params, or ``"logical"``,
    each leaf by :func:`param_logical_axes` under the rule table (the
    reference dry-run's ``in_shardings``)."""
    if layout == "replicated":
        pl = {k: (Replicate(),) * mesh.ndim for k in params}
    elif layout == "logical":
        pl = tree_shardings(param_logical_axes(params), params, mesh, rules)
    else:
        raise ValueError(f"layout {layout!r}; expected one of {LAYOUTS}")
    return {k: distribute_full(v.detach(), mesh, pl[k])
            for k, v in params.items()}


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
        ctx = current()
        if ctx is not None:
            batch = distribute_batch(batch, ctx)
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
            mask, ent, ent0 = _judged(fed, judge_fn, _full(soft), sizes,
                                      tokens.device)
            if ctx is not None:
                mask = replicated(mask, ctx.mesh)
            w = mask * sizes
            loss = (w * client_loss).sum() / w.sum().clamp(min=1e-9)
            loss = loss + cfg.router_aux_weight * aux
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        del leaves
        if ctx is not None:
            grads = {k: placed_like(g, params[k]) for k, g in grads.items()}
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
        if ctx is not None:
            metrics = {k: _full(v) for k, v in metrics.items()}
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


def _zeros_placed(p, device) -> torch.Tensor:
    """A float32 gradient accumulator for parameter ``p``: zeros of its
    shape, a DTensor in its placements where it is one (on ``device``
    otherwise)."""
    if isinstance(p, DTensor):
        return dtensor_zeros(p.shape, dtype=torch.float32,
                             device_mesh=p.device_mesh,
                             placements=p.placements)
    return torch.zeros(p.shape, dtype=torch.float32, device=device)


def make_microbatched_train_step(model: Model, opt: Optimizer, fed: FedSpec,
                                 num_microbatches: int,
                                 judge_fn: Callable | None = None, *,
                                 donate: bool = False) -> Callable:
    """The two-phase microbatched round — the paper's two-stage protocol
    made literal, and the memory lever when a full global batch's
    activations do not fit:

    Phase 1 (stage 1): a forward-only pass over the microbatches
    accumulates per-client soft labels; judge ONCE on the full batch's
    soft labels (the unbatched step's mask). Phase 2 (stage 2):
    gradients accumulated over the same microbatches with the judged mask
    weighting each client's loss.

    ``judge_fn`` and ``donate`` as in :func:`make_train_step`; the
    metrics are the reference's (loss, mask, num_positive, entropy,
    entropy_initial, per_client_loss) and ``grad_norm``, the norm of the
    averaged gradient.

    Under ``sharding.ctx.use_mesh`` it runs as :func:`make_train_step`
    does: the batch laid out on the ``"batch"`` rule, each microbatch
    keeping each client's rows on their shard; phase 1's soft labels
    gathered once a step for the judge and the mask replicated; the
    gradient accumulators DTensors placed like their params, each
    microbatch's gradient brought to that placement before it is added.
    """
    cfg = model.cfg
    if judge_fn is None:
        judge_fn = judge
    n = num_microbatches

    def train_step(params, opt_state, batch):
        ctx = current()
        if ctx is not None:
            batch = distribute_batch(batch, ctx)
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
        mask, ent, ent0 = _judged(fed, judge_fn, _full(soft), sizes, dev)
        if ctx is not None:
            mask = replicated(mask, ctx.mesh)
        w = mask * sizes
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        grads = {k: _zeros_placed(v, dev) for k, v in params.items()}
        loss_sum, cl_sum = 0.0, 0.0
        for mb in mbs:
            with torch.enable_grad():
                logits, aux = model.apply(leaves, mb)
                cl = _per_client_loss(cfg, logits, mb["tokens"], m)
                loss = (w * cl).sum() / w.sum().clamp(min=1e-9)
                total = loss + cfg.router_aux_weight * aux
            for k, g in zip(leaves, torch.autograd.grad(
                    total, list(leaves.values()))):
                grads[k] += placed_like(g, params[k])
            loss_sum = loss_sum + loss.detach()
            cl_sum = cl_sum + cl.detach()
        del leaves
        grads = {k: g / n for k, g in grads.items()}
        metrics = {
            "loss": loss_sum / n,
            "mask": mask,
            "num_positive": mask.sum(),
            "entropy": ent,
            "entropy_initial": ent0,
            "per_client_loss": cl_sum / n,
            "grad_norm": _grad_norm(grads),
        }
        if ctx is not None:
            metrics = {k: _full(v) for k, v in metrics.items()}
        if donate:
            new_params, new_state = _update_donated(opt, grads, opt_state,
                                                    params)
        else:
            new_params, new_state = opt.update(grads, opt_state, params)
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


# ---------------------------------------------------------------- specs

# logical axes for the trailing dims of each param, keyed by path suffix
_PARAM_RULES: list[tuple[tuple[str, ...], tuple]] = [
    (("tok", "embed"), ("vocab", "embed")),
    (("tok", "head"), ("embed", "vocab")),
    (("patch_proj", "w"), ("embed", None)),
    (("attn", "w_q", "w"), ("embed", "heads")),
    (("attn", "w_k", "w"), ("embed", "kv_heads")),
    (("attn", "w_v", "w"), ("embed", "kv_heads")),
    (("attn", "w_o", "w"), ("heads", "embed")),
    (("xattn", "w_q", "w"), ("embed", "heads")),
    (("xattn", "w_k", "w"), ("embed", "kv_heads")),
    (("xattn", "w_v", "w"), ("embed", "kv_heads")),
    (("xattn", "w_o", "w"), ("heads", "embed")),
    (("mlp", "w_in", "w"), ("embed", "ffn")),
    (("mlp", "w_gate", "w"), ("embed", "ffn")),
    (("mlp", "w_out", "w"), ("ffn", "embed")),
    (("moe", "router", "w"), ("embed", "experts")),
    (("moe", "w_in"), ("experts", "embed", "ffn")),
    (("moe", "w_gate"), ("experts", "embed", "ffn")),
    (("moe", "w_out"), ("experts", "ffn", "embed")),
    (("ssm", "in_proj", "w"), ("embed", "ssm_inner")),
    (("ssm", "out_proj", "w"), ("ssm_inner", "embed")),
    (("ssm", "conv_w"), (None, "ssm_inner")),
    (("ssm", "conv_b"), ("ssm_inner",)),
    (("ssm", "norm_scale"), ("ssm_inner",)),
]


def param_logical_axes(params: dict) -> dict:
    """{name: logical-axis tuple} for a ``Model.params()``-shaped dict
    (tensors, or anything with ``.shape``). Rules match suffixes of the
    dotted name (``layers.3.attn.w_q.w``); a rule's axes bind to the
    trailing dims, any leading dim gets None. Unmatched leaves (norms,
    biases, scalars) replicate. The reference's leading layer-stacking
    dims have no counterpart: the port keeps one module a layer."""
    out = {}
    for name, leaf in params.items():
        names, ndim = tuple(name.split(".")), len(leaf.shape)
        out[name] = (None,) * ndim
        for suffix, axes in _PARAM_RULES:
            if names[-len(suffix):] == suffix:
                pad = ndim - len(axes)
                if pad >= 0:       # rank-reduced: replicate
                    out[name] = (None,) * pad + tuple(axes)
                break
    return out


def _cache_axes(name: str, ndim: int) -> tuple:
    if name in ("k", "v"):          # (B, T, K, hd)
        return (None,) * (ndim - 4) + ("batch", "kv_time", "kv_heads",
                                       None)
    if name == "state":             # (B, H, P, N)
        return (None,) * (ndim - 4) + ("batch", "ssm_inner", None, None)
    if name == "conv":              # (B, K-1, C)
        return (None,) * (ndim - 3) + ("batch", None, "ssm_inner")
    return (None,) * ndim


def cache_logical_axes(cache: Any) -> Any:
    """The decode cache's tree (dicts and lists, as ``init_cache``
    builds it) with a logical-axis tuple at each tensor, keyed by the
    leaf's name: the batch dim and the KV heads or SSM heads shard; the
    KV time dim is ``"kv_time"``, which maps to no mesh axis unless a
    rule says so (architectures whose kv heads do not divide the model
    axis: chatglm3's 2, kimi-k2's 8 on a 16-way axis). A non-tensor leaf
    (the cache's ``index``) gets ``()``."""
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if isinstance(node, torch.Tensor):
            return _cache_axes(name, node.ndim)
        return ()

    return walk(cache, "")
