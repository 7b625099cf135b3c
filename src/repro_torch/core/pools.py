"""Positive/negative device pools with epsilon-greedy selection (Alg. 2 l.4-8).

Host-side bookkeeping on a numpy RNG: pool membership is control-plane
state. An exact transcription of ``repro.core.pools.DevicePools``, so a
seed draws the same cohorts in both packages:

* both pools start with all devices in the positive pool;
* each round, with probability eps (default 0.8) the round's |S_t| = N*C
  devices are drawn from the positive pool, otherwise from the negative
  pool; if the chosen pool has too few members, the remainder is drawn
  from the other pool (Sec. 3.4);
* selected devices are removed from their pools for the round and
  re-filed according to the judgment verdict.

``pools_draw`` and ``pools_refile`` are the same semantics as tensor
functions of (threefry key, membership masks) — the traced pools, which
the scan engine carries on the device through a block of rounds — drawn
on :mod:`.threefry`, JAX's own stream, so they select what the
reference's traced pools select.

``label_histograms`` and ``hist_entropy`` are the per-client label
statistics the queue selector ranks on, and ``greedy_entropy_groups`` the
FedCAT grouping built on them, transcribed from the same module.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import threefry
from .entropy import entropy_np


@dataclass
class DevicePools:
    num_devices: int
    eps: float = 0.8
    seed: int = 0
    positive: set[int] = field(init=False)
    negative: set[int] = field(init=False)
    _rng: np.random.Generator = field(init=False, repr=False)

    def __post_init__(self):
        self.positive = set(range(self.num_devices))
        self.negative = set()
        self._rng = np.random.default_rng(self.seed)

    # -- paper Alg.2 lines 4-8 -------------------------------------------
    def select(self, num: int) -> list[int]:
        """Draw the round's device set S_t (removed from the pools)."""
        num = min(num, self.num_devices)
        use_positive = self._rng.random() < self.eps
        first = self.positive if use_positive else self.negative
        second = self.negative if use_positive else self.positive

        take_first = min(num, len(first))
        chosen = list(self._rng.choice(sorted(first), take_first,
                                       replace=False)) if take_first else []
        remaining = num - take_first
        if remaining > 0:
            extra = list(self._rng.choice(sorted(second),
                                          min(remaining, len(second)),
                                          replace=False))
            chosen += extra
        chosen = [int(c) for c in chosen]
        for c in chosen:
            self.positive.discard(c)
            self.negative.discard(c)
        return chosen

    # -- paper Alg.2 line 22 ----------------------------------------------
    def update(self, positives: list[int], negatives: list[int]) -> None:
        self.positive.update(int(i) for i in positives)
        self.negative.update(int(i) for i in negatives)

    def stats(self) -> dict:
        return {"positive": len(self.positive), "negative": len(self.negative)}


# ---- traced pools (the scan engine's device-resident carry) --------------

def pools_draw(key: torch.Tensor, pos_mask: torch.Tensor,
               neg_mask: torch.Tensor, *, num: int, eps: float
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 lines 4-8 as a draw on tensors (the reference's jitted
    ``pools_draw``, on the same threefry stream).

    With probability ``eps`` (compared in float32) the round draws from
    the positive pool, otherwise the negative; a pool with fewer than
    ``num`` members spills into the other. Returns ``(sel, new_key)``:
    (num,) int32 client ids and the key after the draw, on the device of
    ``key``; the masks are not changed (:func:`pools_refile` removes and
    re-files). A random 31-bit score per client fixes a permutation
    (stable argsort of the negated scores, in int64), and a second stable
    argsort by membership of the first pool floats its members to the
    front with that order kept within each pool. Nothing is read back to
    the host.
    """
    keys = threefry.split(key, 3)
    k_eps, k_bits, new_key = keys[0], keys[1], keys[2]
    # eps rounded to float32, the reference's weakly typed compare; exact
    # in float64 too, so no tensor is made (and nothing copied) for it
    use_pos = threefry.uniform(k_eps) < float(np.float32(eps))
    first = torch.where(use_pos, pos_mask, neg_mask).to(torch.float32)
    n = pos_mask.shape[0]
    score = threefry.random_bits(k_bits, n) >> 1
    perm = torch.argsort(-score, stable=True)
    front = torch.argsort(-first[perm], stable=True)
    sel = perm[front][:num].to(torch.int32)
    return sel, new_key


def pools_refile(pos_mask: torch.Tensor, neg_mask: torch.Tensor,
                 sel: torch.Tensor, admitted: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Alg. 2 line 22 with the draw's removal: the round's cohort ``sel``
    leaves both pools and re-files by the (m,) 0/1 verdict ``admitted``
    (admitted -> positive), by a scatter over ``sel``; every other
    client's membership stays. Returns the new (N,) float32 masks."""
    n = pos_mask.shape[0]
    at = sel.to(torch.int64)
    zero = torch.zeros(n, dtype=torch.float32, device=pos_mask.device)
    hot = zero.scatter(0, at, 1.0)
    acc = zero.scatter(0, at, admitted.to(torch.float32))
    new_pos = torch.where(hot > 0, acc, pos_mask.to(torch.float32))
    new_neg = torch.where(hot > 0, 1.0 - acc, neg_mask.to(torch.float32))
    return new_pos, new_neg


# ---- label-distribution stats (the queue selector's ranking input) -------

def label_histograms(y: np.ndarray, w: np.ndarray | None = None,
                     num_classes: int | None = None) -> np.ndarray:
    """Per-device weighted label counts: (N, S) labels -> (N, C) histograms.

    ``w`` is the per-sample weight mask ``stack_clients`` produces (padded
    samples carry weight 0, so they never count toward a distribution).
    """
    y = np.asarray(y)
    w = (np.ones(y.shape, np.float64) if w is None
         else np.asarray(w, np.float64))
    c = int(num_classes) if num_classes else int(y.max()) + 1
    hists = np.zeros((y.shape[0], c), np.float64)
    for i in range(y.shape[0]):
        hists[i] = np.bincount(y[i].reshape(-1),
                               weights=w[i].reshape(-1), minlength=c)[:c]
    return hists


def hist_entropy(hist: np.ndarray) -> float:
    """Shannon entropy (nats) of a count histogram; empty -> 0."""
    tot = float(np.sum(hist))
    if tot <= 0.0:
        return 0.0
    return float(entropy_np(np.asarray(hist, np.float64) / tot))


def greedy_entropy_groups(hists: np.ndarray,
                          group_size: int) -> list[list[int]]:
    """Partition rows into ordered groups of ``group_size``, greedily
    maximizing each group's combined label entropy (FedCAT grouping).

    Each group is seeded with the most label-skewed device left, then grown
    by the device whose addition raises the pooled histogram's entropy the
    most. Deterministic (ties break to the lowest index, through the same
    tuple keys as the reference), so a speculative re-selection on a
    selector copy reproduces the same chains. The final group may be
    smaller when ``group_size`` does not divide the row count.
    """
    n = len(hists)
    k = max(1, int(group_size))
    remaining = list(range(n))
    groups: list[list[int]] = []
    while remaining:
        seed = min(remaining, key=lambda i: (hist_entropy(hists[i]), i))
        remaining.remove(seed)
        group = [seed]
        acc = np.array(hists[seed], np.float64)
        while len(group) < k and remaining:
            best = max(remaining,
                       key=lambda i: (hist_entropy(acc + hists[i]), -i))
            remaining.remove(best)
            group.append(best)
            acc += hists[best]
        groups.append(group)
    return groups
