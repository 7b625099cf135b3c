"""Aggregator implementations: merging admitted updates (Alg. 2 line 21).

``WeightedAverageAggregator`` — size-weighted FedAvg over the admitted
                                mask (``core.aggregation.aggregate``), one
                                reduction per leaf.
``FusedAverageAggregator``    — the same mean as ONE flat reduction
                                (``core.aggregation.fused_aggregate``):
                                every leaf flattened into a single (M, P)
                                buffer and reduced in one call — the plain
                                version or the fused_aggregate CUDA kernel.
                                Float32-tolerance equal to ``weighted``,
                                not bitwise.
``ScaffoldAggregator``        — the same average as ``weighted``, then the
                                SCAFFOLD damped server step
                                w_g <- w_g + eta_g*(avg - w_g).
``DeviceConcatAggregator``    — FedCAT (arXiv 2202.12751): identity within
                                a chain, size-weighted average across the
                                chains' representative models.
``PerClusterAggregator``      — clustered FL: any base aggregator masked
                                over the K-center cluster axis (one
                                admitted-member average per center; an
                                empty cluster keeps its center).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

from ..core.aggregation import aggregate, fused_aggregate
from .registry import register


@register("aggregator", "weighted")
class WeightedAverageAggregator:
    """w_g = sum_{i in A} L_i W_i / sum_{i in A} L_i."""

    @classmethod
    def from_config(cls, config, local):
        return cls()

    def __call__(self, global_params, out, sizes, mask):
        return aggregate(out["params"], sizes, mask)


@register("aggregator", "fused")
class FusedAverageAggregator:
    """``weighted``'s mean as one flat (M, P) reduction.

    ``backend="cuda"`` reduces through the fused_aggregate kernel;
    ``"torch"`` through its plain version.
    """

    def __init__(self, backend: str = "torch"):
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown aggregation backend {backend!r}")
        self.backend = backend

    @classmethod
    def from_config(cls, config, local):
        return cls()

    def __call__(self, global_params, out, sizes, mask):
        return fused_aggregate(out["params"], sizes, mask,
                               backend=self.backend)


@register("aggregator", "scaffold")
class ScaffoldAggregator:
    """Weighted average followed by a global step of size ``lr_g``.

    The step is ``wg + eta * (avg - wg)`` as the reference writes it: at
    ``eta = 1`` that is not bit-equal to ``avg``.
    """

    def __init__(self, lr_g: float = 1.0):
        self.lr_g = float(lr_g)

    @classmethod
    def from_config(cls, config, local):
        return cls(local.scaffold_lr_g)

    def __call__(self, global_params, out, sizes, mask):
        avg = aggregate(out["params"], sizes, mask)
        eta = self.lr_g
        return pytree.tree_map(
            lambda wg, ag: wg + eta * (ag.to(wg.dtype) - wg),
            global_params, avg)


@register("aggregator", "devconcat")
class DeviceConcatAggregator:
    """FedCAT merge: one model per chain, size-weighted across chains.

    ``out`` rows are per-device chain-stage outputs (device i's params are
    the chain state after i trained), annotated with ``group_id`` and
    ``chain_pos`` by ``CatChainStrategy``. Within a chain the merge is the
    identity: the deepest stage whose admitted prefix is unbroken *is* the
    group's model, as it already holds its predecessors' training. Across
    chains those representatives average weighted by their admitted-prefix
    data sizes, leaf by leaf through ``aggregate`` as in the reference. So
    judgment filters chain membership *before* concatenation: a rejected
    device truncates its chain before itself. A chain whose first device
    is rejected contributes nothing; if every chain is emptied the global
    model is kept, through a ``torch.where`` on a 0-d device boolean (no
    host read, so the pipelined engine never waits here).

    With group size 1 every device is its own chain and this equals
    ``WeightedAverageAggregator`` bit for bit. A cohort without chain
    annotations takes the same plain weighted average.
    """

    @classmethod
    def from_config(cls, config, local):
        return cls()

    def __call__(self, global_params, out, sizes, mask):
        if "group_id" not in out:        # not a chain cohort: plain FedAvg
            return aggregate(out["params"], sizes, mask)
        gid, pos = out["group_id"], out["chain_pos"]
        m = mask.to(gid.device, torch.float32) > 0
        same = gid[None, :] == gid[:, None]
        prefix = same & (pos[None, :] <= pos[:, None])
        # ok[i]: every chain stage up to and including i was admitted
        ok = (~prefix | m[None, :]).all(dim=1)
        # the deepest unbroken stage represents its chain
        deeper = same & (pos[None, :] > pos[:, None])
        rep = (ok & ~(deeper & ok[None, :]).any(dim=1)).to(torch.float32)
        # chain weight: total data size along the admitted prefix (sums
        # of integer sizes, exact in float32)
        size = sizes.to(gid.device, torch.float32)
        w = torch.where(prefix, size[None, :], 0.0).sum(dim=1)
        avg = aggregate(out["params"], w, rep)
        kept = (w * rep).sum() > 0
        return pytree.tree_map(
            lambda ag, wg: torch.where(kept, ag, wg.to(ag.dtype)),
            avg, global_params)


@register("aggregator", "perclstr")
class PerClusterAggregator:
    """Clustered merge: the base aggregator's weighted mean, masked over
    the cluster axis.

    On a clustered round ``global_params`` is the :class:`ModelBank`'s
    stacked (K, ...) tree and ``out["cluster"]`` carries the round's
    per-client cluster ids (a device tensor); each center averages ONLY
    its own admitted members (``mask * (cluster == k)``) through the base
    aggregator, one call per center (with
    ``FusedAverageAggregator("cuda")`` as the base, K launches of K2 over
    the same (M, P) rows). A cluster with no admitted member keeps its
    center bit for bit, through a ``torch.where`` on a 0-d device boolean
    (no host read).

    Unclustered cohorts (no ``"cluster"`` key: every K=1 round) pass
    straight through to the base aggregator, so ``ifca+maxent`` at K=1
    is the ``weighted`` path bit for bit.
    """

    def __init__(self, base=None):
        self.base = base if base is not None \
            else WeightedAverageAggregator()

    @classmethod
    def from_config(cls, config, local):
        return cls()

    def __call__(self, global_params, out, sizes, mask):
        if "cluster" not in out:
            return self.base(global_params, out, sizes, mask)
        cids = out["cluster"]
        sizes = sizes.to(cids.device, torch.float32)
        mask = mask.to(cids.device, torch.float32)
        k = pytree.tree_leaves(global_params)[0].shape[0]
        centers = []
        for c in range(k):
            mk = mask * (cids == c).to(torch.float32)
            old = pytree.tree_map(lambda s, c=c: s[c], global_params)
            avg = self.base(old, out, sizes, mk)
            kept = (sizes * mk).sum() > 0
            centers.append(pytree.tree_map(
                lambda a, o, kept=kept: torch.where(kept, a.to(o.dtype), o),
                avg, old))
        return pytree.tree_map(lambda *xs: torch.stack(xs), *centers)
