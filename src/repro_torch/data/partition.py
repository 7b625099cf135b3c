"""Non-IID client partitioners — the paper's three heterogeneity settings
(Sec. 4.1, Fig. 4):

* case 1 — every client holds samples of a SINGLE label;
* case 2 — every client holds samples of exactly TWO labels, evenly;
* case 3 — label proportions per client drawn from Dirichlet(beta), beta=0.1.

``stack_clients`` pads per-client datasets to a common length and emits
the (x, y, w) stacked arrays (w masks padding). ``drift_schedule``
builds drift events (:class:`DriftEvent`): at a scheduled round a seeded
share of the clients swap their rows for fresh label shards. Exact numpy
transcriptions of ``repro.data.partition``: one seed gives the same
partition and the same events in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _by_class(y: np.ndarray, num_classes: int, rng) -> list[np.ndarray]:
    out = []
    for c in range(num_classes):
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        out.append(idx)
    return out


def partition_case1(y, num_clients, num_classes, seed=0):
    """Single label per client; clients cycle through the classes."""
    rng = np.random.default_rng(seed)
    pools = _by_class(y, num_classes, rng)
    cls_of = [i % num_classes for i in range(num_clients)]
    counts = np.bincount(cls_of, minlength=num_classes)
    parts, used = [], np.zeros(num_classes, np.int64)
    for i in range(num_clients):
        c = cls_of[i]
        share = len(pools[c]) // counts[c]
        parts.append(pools[c][used[c]: used[c] + share])
        used[c] += share
    return parts


def partition_case2(y, num_clients, num_classes, seed=0):
    """Exactly two labels per client, evenly split (paper case 2)."""
    rng = np.random.default_rng(seed)
    pools = _by_class(y, num_classes, rng)
    # pair classes (c, c+1 mod C) cycling over clients
    pair_of = [(i % num_classes, (i + 1) % num_classes)
               for i in range(num_clients)]
    per_class_users = np.zeros(num_classes, np.int64)
    for a, b in pair_of:
        per_class_users[a] += 1
        per_class_users[b] += 1
    used = np.zeros(num_classes, np.int64)
    parts = []
    for a, b in pair_of:
        pa = len(pools[a]) // per_class_users[a]
        pb = len(pools[b]) // per_class_users[b]
        take = min(pa, pb)
        pt = np.concatenate([pools[a][used[a]:used[a] + take],
                             pools[b][used[b]:used[b] + take]])
        used[a] += take
        used[b] += take
        rng.shuffle(pt)
        parts.append(pt)
    return parts


def partition_dirichlet(y, num_clients, num_classes, beta=0.1, seed=0,
                        min_samples=2, max_retries=1000):
    """Dirichlet(beta) label proportions per client (paper case 3).

    Draws are resampled until every client holds at least ``min_samples``;
    an infeasible (beta, min_samples, N) combination fails loudly after
    ``max_retries`` attempts instead of hanging the run.
    """
    rng = np.random.default_rng(seed)
    for _ in range(max(1, int(max_retries))):
        pools = _by_class(y, num_classes, rng)
        parts = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            props = rng.dirichlet(np.full(num_clients, beta))
            cuts = (np.cumsum(props) * len(pools[c])).astype(int)[:-1]
            for i, chunk in enumerate(np.split(pools[c], cuts)):
                parts[i].append(chunk)
        parts = [np.concatenate(p) for p in parts]
        if min(len(p) for p in parts) >= min_samples:
            return [rng.permutation(p) for p in parts]
    raise RuntimeError(
        f"partition_dirichlet: no draw gave every one of {num_clients} "
        f"clients >= {min_samples} samples after {max_retries} resamples "
        f"(beta={beta}, {len(y)} samples); lower min_samples, raise beta, "
        "or reduce num_clients")


def partition(case: str, y, num_clients, num_classes, seed=0, beta=0.1):
    if case == "case1":
        return partition_case1(y, num_clients, num_classes, seed)
    if case == "case2":
        return partition_case2(y, num_clients, num_classes, seed)
    if case in ("case3", "dirichlet"):
        return partition_dirichlet(y, num_clients, num_classes, beta, seed)
    raise ValueError(f"unknown heterogeneity case: {case}")


def stack_clients(x, y, parts, batch_multiple: int = 1):
    """Pad client shards to a common length -> stacked {x, y, w} arrays.

    The common length is rounded up to ``batch_multiple`` so every client
    dataset reshapes exactly into local minibatches.
    """
    smax = max(len(p) for p in parts)
    if batch_multiple > 1:
        smax = int(np.ceil(smax / batch_multiple) * batch_multiple)
    n = len(parts)
    xs = np.zeros((n, smax) + x.shape[1:], x.dtype)
    ys = np.zeros((n, smax), np.int32)
    ws = np.zeros((n, smax), np.float32)
    for i, p in enumerate(parts):
        xs[i, :len(p)] = x[p]
        ys[i, :len(p)] = y[p]
        ws[i, :len(p)] = 1.0
    return {"x": xs, "y": ys, "w": ws}


# --------------------------------------------------------------- drift

@dataclass(frozen=True)
class DriftEvent:
    """One scheduled drift: at round ``round`` the listed clients swap
    their stacked rows for ``data`` (same ``{x, y, w}`` layout and
    per-client sample length as the corpus they drift inside)."""
    round: int
    clients: tuple
    data: dict

    def __post_init__(self):
        if self.round < 0:
            raise ValueError("drift round must be >= 0")
        if len(set(self.clients)) != len(self.clients):
            raise ValueError("drift clients must be distinct")
        rows = {k: np.shape(v)[0] for k, v in self.data.items()}
        if any(r != len(self.clients) for r in rows.values()):
            raise ValueError(
                f"drift data rows {rows} must match the "
                f"{len(self.clients)} drifting clients")


def _restack(x, y, shards, samples_per_client: int):
    """``stack_clients`` for a client subset at a FIXED common length
    (the corpus's existing per-client sample axis): shards longer than
    the corpus row truncate, shorter ones pad with w=0."""
    s = int(samples_per_client)
    k = len(shards)
    xs = np.zeros((k, s) + x.shape[1:], x.dtype)
    ys = np.zeros((k, s), np.int32)
    ws = np.zeros((k, s), np.float32)
    for i, p in enumerate(shards):
        p = np.asarray(p)[:s]
        xs[i, :len(p)] = x[p]
        ys[i, :len(p)] = y[p]
        ws[i, :len(p)] = 1.0
    return {"x": xs, "y": ys, "w": ws}


def drift_schedule(x, y, num_clients, num_classes, *, at, frac=0.5,
                   case="case1", seed=0, beta=0.1,
                   samples_per_client=None) -> list:
    """Deterministic drift events: at each round in ``at``, a seeded
    ``frac`` of clients re-partition onto fresh label shards.

    Each event draws its own client subset and a fresh :func:`partition`
    (seed derived from ``seed`` and the event index, so the whole
    schedule is a pure function of its arguments), then assigns drifting
    client ``c`` the shard of rotated client ``c+1``: under case1/case2
    that changes the label distribution, not just the samples.

    ``samples_per_client`` pins the stacked row length to the corpus the
    events will be applied to (required: the server checks it). Returns a
    list of :class:`DriftEvent`, sorted by round.
    """
    if samples_per_client is None:
        raise ValueError(
            "samples_per_client is required (the corpus's per-client "
            "sample axis the replacement rows must match)")
    if not 0.0 < frac <= 1.0:
        raise ValueError("frac must be in (0, 1]")
    rounds = (int(at),) if np.isscalar(at) else tuple(int(r) for r in at)
    if len(set(rounds)) != len(rounds):
        raise ValueError("drift rounds must be distinct")
    events = []
    for j, r in enumerate(sorted(rounds)):
        rng = np.random.default_rng(
            np.random.SeedSequence([int(seed), j, r]))
        k = max(1, int(np.round(frac * num_clients)))
        drifting = np.sort(rng.choice(num_clients, size=k, replace=False))
        parts = partition(case, y, num_clients, num_classes,
                          seed=int(seed) + 1 + j, beta=beta)
        shards = [parts[(int(c) + 1) % num_clients] for c in drifting]
        events.append(DriftEvent(
            round=r, clients=tuple(int(c) for c in drifting),
            data=_restack(x, y, shards, samples_per_client)))
    return events
