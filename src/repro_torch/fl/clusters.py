"""Clustered federated learning: the K-center ``ModelBank`` axis.

FedEntropy screens local models against ONE global model; clustered FL
(FedGroup, arXiv 2010.06870; IFCA; FeSEM) attacks the same non-IID bias
with several concurrent group models. This module adds that axis to the
registry without forking the engines:

* :class:`ModelBank` — a stacked K-center param tree (leading cluster
  axis on every leaf). Center 0 is exactly the init params; centers
  1..K-1 are jittered copies drawn from a ``torch.Generator`` seeded with
  the server's seed, so K=1 *is* the single-model path bit for bit.
* :class:`IFCAAssigner` (registry ``cluster="ifca"``) — loss-based
  assignment: every center evaluated on every selected client's local
  data (a (K, m) loss matrix, ``torch.func.vmap`` over centers and
  clients, no gradient), then ``argmin`` per client on the host (float64,
  lowest index on ties).
* :class:`FeSEMAssigner` (registry ``cluster="fesem"``) — weight-distance
  alternation: sticky per-client assignments (seeded init), re-filed
  *after* each round by ``argmin_k ||w_i - c_k||^2`` against the
  pre-aggregation centers. Assignment is verdict-independent, which is
  what lets the pipelined engine speculate through it.

Judgment and aggregation run *within* each cluster: the server judges each
cluster's rows on their own (``Server._judge_clusters``) and the
``perclstr`` aggregator averages each center over its admitted members
only, keeping an empty cluster's center unchanged. Compositions: ``ifca``,
``ifca+maxent`` (per-cluster max-entropy judgment) and ``fesem``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import vmap
from torch.utils import _pytree as pytree

from .registry import register


@dataclass(frozen=True)
class ModelBank:
    """K stacked model centers: every leaf carries a leading cluster axis.
    Immutable; the engines swap whole banks each round."""
    stacked: Any          # param tree, leading axis K on every leaf
    k: int

    @classmethod
    def init(cls, params, k: int, *, seed: int = 0,
             jitter: float = 1e-2) -> "ModelBank":
        """Center 0 is ``params`` EXACTLY (the K=1 reduction); centers
        1..K-1 add gaussian jitter of scale ``jitter`` drawn on the CPU
        from ``torch.Generator().manual_seed(seed)``, center by center and
        leaf by leaf, so every device draws the same bank. This is the
        port's own stream: the reference's ``jax.random.fold_in`` keys
        cannot be matched, so parity tests take the reference's bank."""
        if k < 1:
            raise ValueError("ModelBank needs k >= 1 centers")
        leaves, spec = pytree.tree_flatten(params)
        gen = torch.Generator().manual_seed(int(seed))
        centers = [leaves]
        for _ in range(1, k):
            jittered = []
            for leaf in leaves:
                if leaf.is_floating_point():
                    noise = torch.randn(leaf.shape, generator=gen,
                                        dtype=leaf.dtype)
                    jittered.append(leaf + jitter * noise.to(leaf.device))
                else:
                    jittered.append(leaf)
            centers.append(jittered)
        stacked = [torch.stack([c[i] for c in centers])
                   for i in range(len(leaves))]
        return cls(stacked=pytree.tree_unflatten(stacked, spec), k=int(k))

    def replace(self, stacked) -> "ModelBank":
        return ModelBank(stacked=stacked, k=self.k)

    def center(self, i: int):
        """Center ``i`` as a plain (unstacked) param tree."""
        return pytree.tree_map(lambda s: s[i], self.stacked)

    def gather(self, cluster_ids):
        """Per-client start params: row ``j`` is the center assigned to
        client ``j`` — the (m, ...) stacked tree the banked client program
        maps over (in-dim 0 on the params slot)."""
        leaves = pytree.tree_leaves(self.stacked)
        ids = torch.as_tensor(np.asarray(cluster_ids, np.int64),
                              device=leaves[0].device)
        return pytree.tree_map(lambda s: s.index_select(0, ids),
                               self.stacked)


def argmin_assign(scores) -> np.ndarray:
    """Host-deterministic per-client assignment from a (K, m) score
    matrix: float64, ``argmin`` over the center axis, lowest index on
    ties — the one place both assigners' verdicts are decided."""
    if isinstance(scores, torch.Tensor):
        scores = scores.detach().cpu().numpy()
    scores = np.asarray(scores, np.float64)
    if scores.ndim != 2:
        raise ValueError(f"scores must be (K, m), got {scores.shape}")
    return np.argmin(scores, axis=0).astype(np.int64)


def _loss_program(apply_fn):
    """The (K, m) weighted cross-entropy of every center on every
    client's data: ``vmap`` over centers of a ``vmap`` over clients."""
    def losses(stacked, x, y, w):
        def one_center(center):
            def one_client(xc, yc, wc):
                logits = apply_fn(center, xc)[0].to(torch.float32)
                logp = F.log_softmax(logits, dim=-1)
                nll = -torch.take_along_dim(
                    logp, yc.long()[:, None], dim=1)[:, 0]
                return (nll * wc).sum() / wc.sum().clamp(min=1.0)
            return vmap(one_client)(x, y, w)
        return vmap(one_center)(stacked)
    return losses


@register("cluster", "ifca")
class IFCAAssigner:
    """IFCA-style loss-based assignment (cluster id = argmin-loss center).

    ``bind(server)`` once at construction; ``assign(sel)`` evaluates the
    weighted cross-entropy of every center on every selected client's
    local data in one eager program without gradients (kept in the
    server's program cache under its own ``"ifca-assign"`` key, so it
    never aliases a client program), then takes the per-client argmin on
    the host: one device-to-host copy of the (K, m) losses. Assignment is
    recomputed every round from the current bank (``bank=`` overrides it:
    the pipelined engine assigns round t+1 against the speculatively
    aggregated bank).
    """

    def __init__(self, num_clusters: int):
        if num_clusters < 1:
            raise ValueError("num_clusters must be >= 1")
        self.num_clusters = int(num_clusters)
        self._server = None
        self.assign_rounds = 0

    @classmethod
    def from_config(cls, config, local):
        return cls(getattr(config, "num_clusters", 1))

    def bind(self, server) -> None:
        self._server = server

    def _loss_fn(self):
        srv = self._server
        return srv._compile_cache().get(
            ("ifca-assign", srv.apply_fn, srv.corpus.signature(),
             srv._param_sig, str(srv.device)),
            lambda: _loss_program(srv.apply_fn))

    def losses(self, sel, bank: ModelBank | None = None) -> torch.Tensor:
        """The (K, m) loss matrix on the server's device."""
        srv = self._server
        bank = srv.bank if bank is None else bank
        data = srv.corpus.cohort(np.asarray(sel))
        with torch.no_grad():
            return self._loss_fn()(bank.stacked, data["x"], data["y"],
                                   data["w"])

    def assign(self, sel, bank: ModelBank | None = None) -> np.ndarray:
        scores = self.losses(sel, bank)
        self.assign_rounds += 1
        return argmin_assign(scores)

    def update(self, sel, cluster_ids, out, bank) -> None:
        """IFCA re-assigns from scratch each round; nothing to fold."""

    def stats(self) -> dict:
        return {"kind": "ifca", "num_clusters": self.num_clusters,
                "assign_rounds": self.assign_rounds}


def _weight_distances(stacked, rows) -> torch.Tensor:
    """(K, m) squared distances between every center and every client's
    trained params, float32, summed leaf by leaf."""
    total = None
    for s, r in zip(pytree.tree_leaves(stacked), pytree.tree_leaves(rows)):
        d = torch.square(r.to(torch.float32)[None]
                         - s.to(torch.float32)[:, None])
        d = d.sum(dim=tuple(range(2, d.dim())))
        total = d if total is None else total + d
    return total


@register("cluster", "fesem")
class FeSEMAssigner:
    """FeSEM-style weight-distance assignment with sticky memberships.

    Every client holds a persistent cluster id (seeded uniform init over
    the K centers, ``np.random.default_rng(SeedSequence([seed,
    0xFE5E]))`` as in the reference); ``assign(sel)`` reads it. After each
    round ``update`` re-files the participating clients by squared weight
    distance between their trained params and the round's
    *pre-aggregation* centers — verdict-independent, so speculation
    replays it exactly.
    """

    def __init__(self, num_clusters: int, num_clients: int, seed: int = 0):
        if num_clusters < 1:
            raise ValueError("num_clusters must be >= 1")
        self.num_clusters = int(num_clusters)
        self.num_clients = int(num_clients)
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), 0xFE5E]))
        self.assignments = (
            np.zeros(self.num_clients, np.int64) if self.num_clusters == 1
            else rng.integers(0, self.num_clusters, size=self.num_clients,
                              dtype=np.int64))
        self._server = None
        self.reassigned = 0

    @classmethod
    def from_config(cls, config, local):
        return cls(getattr(config, "num_clusters", 1),
                   config.num_clients, config.seed)

    def bind(self, server) -> None:
        self._server = server

    def assign(self, sel, bank: ModelBank | None = None) -> np.ndarray:
        return self.assignments[np.asarray(sel, np.int64)].copy()

    def update(self, sel, cluster_ids, out, bank: ModelBank) -> None:
        with torch.no_grad():
            scores = _weight_distances(bank.stacked, out["params"])
        new = argmin_assign(scores)
        idx = np.asarray(sel, np.int64)
        self.reassigned += int(np.sum(self.assignments[idx] != new))
        self.assignments[idx] = new

    def stats(self) -> dict:
        counts = np.bincount(self.assignments,
                             minlength=self.num_clusters)
        return {"kind": "fesem", "num_clusters": self.num_clusters,
                "reassigned": self.reassigned,
                "cluster_counts": [int(c) for c in counts]}
