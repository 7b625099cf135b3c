"""Non-IID client partitioners — the paper's three heterogeneity settings
(Sec. 4.1, Fig. 4):

* case 1 — every client holds samples of a SINGLE label;
* case 2 — every client holds samples of exactly TWO labels, evenly;
* case 3 — label proportions per client drawn from Dirichlet(beta), beta=0.1.

``stack_clients`` pads per-client datasets to a common length and emits
the (x, y, w) stacked arrays (w masks padding). Exact numpy
transcriptions of ``repro.data.partition``: one seed gives the same
partition in both packages.
"""
from __future__ import annotations

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
