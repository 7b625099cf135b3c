"""Selector implementations: who is asked to train this round.

``PoolSelector``    — the paper's epsilon-greedy positive/negative pools
                      (Alg. 2 lines 4-8/22), delegating to
                      ``core.pools.DevicePools``.
``UniformSelector`` — uniform sampling without replacement. Seeded with
                      ``seed + 1`` by the registry, as in the JAX package,
                      so both draw the same cohorts.
``TracedPoolSelector`` — the same eps-greedy pools drawn on JAX's
                      threefry stream (``core.pools.pools_draw`` /
                      ``pools_refile``), so the draw can also run inside
                      the scan engine's block on the card (the
                      ``fedentropy-traced`` composition); it selects what
                      the reference's ``TracedPoolSelector`` selects.
``CatGrouper``      — FedCAT (arXiv 2202.12751) device grouping over an
                      inner selector: who trains is delegated, and the
                      selection is packed into ordered groups by
                      ``core.pools.greedy_entropy_groups``; ``catgroups``
                      wraps ``uniform`` (plain fedcat), ``catgroups-pools``
                      wraps ``pools`` (fedcat+maxent).
``QueueSelector``   — entropy-driven participant selection with dynamic
                      data queues (arXiv 2410.17792): clients ranked by
                      label-distribution entropy off the bound corpus
                      stats, eps-greedy explored, and each round releasing
                      a growing prefix of every selected client's local
                      dataset via a ``DataQueue`` schedule that the server
                      applies inside the cohort gather.

Selectors that consume corpus statistics implement ``bind_data``: the
server passes its corpus once, whose cached ``label_histograms()`` and
``sizes()`` the selector keeps as numpy. The stats surface is duck-typed,
so a corpus of either plane binds (the streaming ``HostCorpus`` computes
the same stats in one pass at open time), and a raw stacked dict too.
Selectors hold no device tensors, so the pipelined engine's
``copy.deepcopy`` of one copies host state only. Every selector here is
an exact transcription of ``repro.fl.selectors``: its selection is a pure
function of its generator (numpy's, or the traced pools' threefry key)
and its counts.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..core import threefry
from ..core.pools import (DevicePools, greedy_entropy_groups, hist_entropy,
                          label_histograms, pools_draw)
from ..data.corpus import DataQueue
from .registry import register


def _corpus_histograms(client_data) -> np.ndarray:
    """Label histograms from a corpus of either plane (cached, duck-typed)
    or a raw stacked dict."""
    cached = getattr(client_data, "label_histograms", None)
    if cached is not None:
        return cached()
    return label_histograms(np.asarray(client_data["y"]),
                            np.asarray(client_data["w"])
                            if "w" in client_data else None)


@register("selector", "pools")
class PoolSelector:
    """Epsilon-greedy over the paper's positive/negative device pools."""

    def __init__(self, num_clients: int, eps: float = 0.8, seed: int = 0):
        self.pools = DevicePools(num_clients, eps, seed)

    @classmethod
    def from_config(cls, config, local):
        return cls(config.num_clients, config.eps, config.seed)

    def select(self, num: int) -> list[int]:
        return self.pools.select(min(num, self.pools.num_devices))

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        self.pools.update(list(positives), list(negatives))

    def stats(self) -> dict:
        return self.pools.stats()


@register("selector", "pools-traced")
class TracedPoolSelector:
    """Epsilon-greedy pools on JAX's threefry stream: the scan-foldable
    twin of :class:`PoolSelector`.

    The semantics are the paper's (eps-greedy pool pick with spillover,
    the cohort out of both pools for the round, re-filed by verdict), but
    the draw is :func:`repro_torch.core.pools.pools_draw` over (key,
    membership masks), state the scan engine carries on the card through
    a block of rounds. :meth:`select` runs that draw on the host's CPU
    (the same integers as on the card), so a block and the sequential
    ``Server`` walk the same selector states, and the reference's
    selector on the same seed draws the same cohorts.

    The scan engine's fold surface: :meth:`fold_carry`, the (key, pos,
    neg) carry a block starts from; :meth:`fold_drawn`, which mirrors one
    draw made in a block (the cohort leaves the pools, the key after the
    draw is adopted) before the engine confirms the round with
    :meth:`update`, the sequential select/update cycle.
    """

    def __init__(self, num_clients: int, eps: float = 0.8, seed: int = 0):
        self.num_clients = int(num_clients)
        self.eps = float(eps)
        self._key = threefry.prng_key(seed)
        self.positive: set[int] = set(range(self.num_clients))
        self.negative: set[int] = set()

    @classmethod
    def from_config(cls, config, local):
        return cls(config.num_clients, config.eps, config.seed)

    def _masks(self, device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
        both = torch.zeros(2, self.num_clients, dtype=torch.float32)
        both[0, sorted(self.positive)] = 1.0
        both[1, sorted(self.negative)] = 1.0
        both = both.to(device)
        return both[0], both[1]

    def select(self, num: int) -> list[int]:
        num = min(num, self.num_clients)
        pos, neg = self._masks()
        sel, self._key = pools_draw(self._key, pos, neg, num=num,
                                    eps=self.eps)
        chosen = sel.tolist()
        for c in chosen:        # out for the round, like DevicePools
            self.positive.discard(c)
            self.negative.discard(c)
        return chosen

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        self.positive.update(int(i) for i in positives)
        self.negative.update(int(i) for i in negatives)

    # ---- the scan engine's fold surface ---------------------------------
    def fold_carry(self, device="cpu"
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(key (2,) int64, pos (N,), neg (N,) float32) on ``device``: the
        state the next :meth:`select` would draw from."""
        pos, neg = self._masks(device)
        return self._key.to(device), pos, neg

    def fold_drawn(self, sel, key_after) -> None:
        """Mirror a draw made in a block that the engine confirmed (or
        replays eagerly): the cohort leaves both pools and the key moves
        to the key after that draw."""
        for c in torch.as_tensor(sel).tolist():
            self.positive.discard(int(c))
            self.negative.discard(int(c))
        self._key = torch.as_tensor(key_after).to("cpu", torch.int64,
                                                  copy=True)

    def stats(self) -> dict:
        return {"selector": "pools-traced",
                "positive": len(self.positive),
                "negative": len(self.negative)}


@register("selector", "uniform")
class UniformSelector:
    """Uniform sampling without replacement; ignores judgment feedback."""

    def __init__(self, num_clients: int, seed: int = 0):
        self.num_clients = num_clients
        self._rng = np.random.default_rng(seed)

    @classmethod
    def from_config(cls, config, local):
        return cls(config.num_clients, config.seed + 1)

    def select(self, num: int) -> list[int]:
        num = min(num, self.num_clients)
        return [int(i) for i in
                self._rng.choice(self.num_clients, num, replace=False)]

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        pass

    def stats(self) -> dict:
        return {"selector": "uniform", "num_clients": self.num_clients}


@register("selector", "catgroups")
class CatGrouper:
    """FedCAT device grouping over an inner selector (default uniform).

    ``select`` delegates to ``inner`` (so the draw stream, and with it a
    fixed seed's history, is the wrapped selector's), then packs the
    selection into ordered groups of ``group_size`` whose pooled label
    distributions are greedily entropy-maximized. The server binds the
    corpus at construction (:meth:`bind_data`), which gives the per-device
    label histograms; an unbound grouper chains devices in selection
    order.

    ``last_groups`` holds the round's groups as lists of *relative*
    indices into the selection: what ``CatChainStrategy`` lays the cohort
    out by. Grouping is deterministic in the selection, and the grouper
    holds numpy state only, so a speculative re-selection on a
    ``copy.deepcopy`` reproduces the same chains.
    """

    inner_cls = UniformSelector

    def __init__(self, inner, group_size: int = 2):
        self.inner = inner
        self.group_size = max(1, int(group_size))
        self._hists: np.ndarray | None = None
        self.last_groups: list[list[int]] | None = None

    @classmethod
    def from_config(cls, config, local):
        return cls(cls.inner_cls.from_config(config, local),
                   config.group_size)

    def bind_data(self, client_data) -> None:
        """Per-device label histograms off a corpus of either plane
        (cached there) or a raw stacked dict, kept as numpy."""
        self._hists = _corpus_histograms(client_data)

    def select(self, num: int) -> list[int]:
        sel = self.inner.select(num)
        if self._hists is not None:
            hists = self._hists[np.asarray(sel)]
        else:
            # unbound: equal one-class histograms, so the groups chain the
            # selection in index order
            hists = np.ones((len(sel), 1))
        self.last_groups = greedy_entropy_groups(hists, self.group_size)
        return sel

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        self.inner.update(positives, negatives)

    def stats(self) -> dict:
        s = dict(self.inner.stats())
        s["group_size"] = self.group_size
        if self.last_groups is not None:
            s["num_groups"] = len(self.last_groups)
        return s


@register("selector", "catgroups-pools")
class PoolCatGrouper(CatGrouper):
    """CatGrouper over the paper's epsilon-greedy pools: judgment feedback
    re-files chain members (the selector of ``fedcat+maxent``)."""

    inner_cls = PoolSelector


@register("selector", "queue")
class QueueSelector:
    """Entropy-driven participation with dynamic data queues
    (arXiv 2410.17792).

    Ranking: with probability ``eps`` the round exploits — the ``num``
    clients with the highest label-distribution entropy (read once off the
    bound corpus's cached histograms), fairness-damped by a per-selection
    ``fairness`` penalty; otherwise it explores uniformly. Ties break to
    the lowest client id, so selection is a pure function of (rng stream,
    visit counts) and a speculative deepcopy replays it exactly.

    Queueing: every ``select`` advances a :class:`DataQueue` schedule and
    records each chosen client's released sample count;
    :meth:`data_schedule` hands those counts to the server, which masks
    them into the cohort's weight rows inside the corpus gather.

    Unbound (no corpus stats), selection is uniform and the queue stays
    off.
    """

    def __init__(self, num_clients: int, eps: float = 0.8, seed: int = 0,
                 queue: DataQueue | None = None, fairness: float = 0.05):
        self.num_clients = num_clients
        self.eps = eps
        self.fairness = fairness
        self.queue = queue or DataQueue()
        self._rng = np.random.default_rng(seed)
        self._uses = np.zeros(num_clients, np.int64)
        self._entropy: np.ndarray | None = None
        self._sizes: np.ndarray | None = None
        self._last_active: np.ndarray | None = None
        self._last_frac: float | None = None   # schedule last applied
        self.round_idx = 0
        self._pos = 0
        self._neg = 0

    @classmethod
    def from_config(cls, config, local):
        return cls(config.num_clients, config.eps, config.seed)

    def bind_data(self, client_data) -> None:
        """Per-client entropy ranks and real sizes off a corpus of either
        plane (the stats surface is duck-typed) or a raw stacked dict,
        kept as numpy."""
        if hasattr(client_data, "label_entropy"):
            self._entropy = client_data.label_entropy()
            self._sizes = client_data.sizes()
        else:
            hists = _corpus_histograms(client_data)
            self._entropy = np.asarray(
                [hist_entropy(h) for h in hists], np.float64)
            w = np.asarray(client_data["w"]) if "w" in client_data else None
            self._sizes = (np.full(len(hists), np.asarray(
                client_data["y"]).shape[1], np.int64) if w is None
                else w.sum(axis=1).astype(np.int64))

    def select(self, num: int) -> list[int]:
        num = min(num, self.num_clients)
        if self._entropy is not None and self._rng.random() < self.eps:
            score = self._entropy - self.fairness * self._uses
            order = np.lexsort((np.arange(self.num_clients), -score))
            sel = order[:num]
        else:
            sel = self._rng.choice(self.num_clients, num, replace=False)
        sel = [int(i) for i in sel]
        self._uses[sel] += 1
        if self._sizes is None:
            self._last_active = None
        else:
            self._last_active = self.queue.active(self.round_idx,
                                                  self._sizes[sel])
            self._last_frac = self.queue.frac(self.round_idx)
        self.round_idx += 1
        return sel

    def data_schedule(self, sel) -> np.ndarray | None:
        """Released-sample counts for the selection :meth:`select` just
        produced (what ``Server._run_cohort`` reads); None until a corpus
        is bound."""
        return self._last_active

    def update(self, positives: Sequence[int],
               negatives: Sequence[int]) -> None:
        self._pos += len(positives)
        self._neg += len(negatives)

    def stats(self) -> dict:
        # queue_frac is the schedule the last select applied; None before
        # any select, or while unbound
        return {"selector": "queue", "round": self.round_idx,
                "queue_frac": self._last_frac,
                "positive_total": self._pos, "negative_total": self._neg}
