"""The ``Server`` round loop: paper Alg. 2 with every axis pluggable.

One ``round()`` = select -> ClientUpdate mapped over the cohort -> judge
-> aggregate -> state/pool feedback. The data plane (client updates,
aggregation) is tensor code on ``device`` over a stacked client axis; the
control plane (selection, pool bookkeeping, the numpy judgment) is
host-side numpy. The cohort comes off the device-resident
:class:`repro_torch.data.corpus.ClientCorpus`, so per round only the
cohort's ids cross from host to device.

On a CUDA device the vmapped client program runs as a captured CUDA graph,
one per key in a per-server LRU of ``ServerConfig.jit_cache_size``
entries (``fl.graph_cache``), the counterpart of the reference's jitted
program in its ``BoundedJitCache``; on the CPU, and inside
``graph_cache.disable_capture()``, it runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..core.aggregation import comm_bytes
from ..core.strategies import ApplyFn, client_update, cross_entropy
from ..data.corpus import ClientCorpus
from ..device import resolve_device
from .graph_cache import BoundedGraphCache, CapturedProgram, capture_enabled
from .protocols import Aggregator, ClientStrategy, Judge, Selector


@dataclass(frozen=True)
class ServerConfig:
    """Round-loop parameters (paper Sec. 4.1 defaults)."""
    num_clients: int = 100          # paper N
    participation: float = 0.1      # paper C
    eps: float = 0.8                # paper epsilon (eps-greedy selectors)
    seed: int = 0
    jit_cache_size: int = 4         # per-server captured-program LRU bound

    def cohort_size(self) -> int:
        """|S_t| = max(1, round(N * C)). Python's ``round`` is banker's
        (half-to-even): N=25, C=0.1 selects 2."""
        return max(1, int(round(self.num_clients * self.participation)))


def _make_client_fn(apply_fn: ApplyFn, spec, in_axes):
    """vmapped ClientUpdate with the strategy's state slices as extra args
    (``None`` where the strategy has none)."""

    def one(global_params, data, prev_p, c_loc, c_glob):
        return client_update(apply_fn, global_params, data, spec,
                             prev_params=prev_p, c_local=c_loc,
                             c_global=c_glob)

    return vmap(one, in_dims=tuple(in_axes))


class Server:
    """Host-side FL server; compose with :func:`repro_torch.fl.build` or
    directly::

        server = Server(cnn.apply, params, corpus, ServerConfig(),
                        selector=PoolSelector(100), strategy=FedAvgStrategy(),
                        judge=MaxEntropyJudge(),
                        aggregator=WeightedAverageAggregator())
        server.fit(rounds=60, eval_every=5, eval_data=(xte, yte))
    """

    def __init__(
        self,
        apply_fn: ApplyFn,
        init_params,
        client_data,                # ClientCorpus or x:(N,S,...), y, w dict
        config: ServerConfig,
        *,
        selector: Selector,
        strategy: ClientStrategy,
        judge: Judge,
        aggregator: Aggregator,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.global_params = pytree.tree_map(
            lambda t: torch.as_tensor(t).to(self.device), init_params)
        self.corpus = ClientCorpus.from_stacked(client_data,
                                                device=self.device)
        self.config = config
        self.selector = selector
        self.strategy = strategy
        self.judge = judge
        self.aggregator = aggregator
        self.state = strategy.init_state(self.global_params,
                                         config.num_clients)
        self.round_idx = 0
        self.history: list[dict] = []
        self._eager_fn = _make_client_fn(apply_fn, strategy.spec,
                                         strategy.client_in_axes())
        self._graphs = BoundedGraphCache(config.jit_cache_size)

    # ------------------------------------------------------------------
    def _client_key(self, cohort: int) -> tuple:
        # the reference's key also holds the apply fn, the spec and the
        # in-axes; the cache is per server and those are fixed with
        # ``_eager_fn`` in __init__, so only the corpus and the cohort
        # size (a graph's shapes are fixed) can vary
        return (self.corpus.signature(), cohort)

    def _run_cohort(self, idx: np.ndarray) -> dict:
        """The cohort's client updates: captured on a CUDA device (the
        outputs are the graph's, overwritten by the next round's replay),
        eager on the CPU or inside ``disable_capture()``."""
        args = (self.global_params, self.corpus.cohort(idx),
                *self.strategy.client_inputs(self.state, idx))
        if self.device.type != "cuda" or not capture_enabled():
            return self._eager_fn(*args)
        program = self._graphs.get(
            self._client_key(len(idx)),
            lambda: CapturedProgram(self._eager_fn, args))
        return program(*args)

    @property
    def graphs_captured(self) -> int:
        """How many client programs this server has captured."""
        return self._graphs.captures

    def round(self) -> dict:
        """One paper Alg. 2 round; returns the history record."""
        cfg = self.config
        sel = self.selector.select(cfg.cohort_size())
        idx = np.asarray(sel)
        out = self._run_cohort(idx)

        soft, sizes = out["soft_label"], out["size"]  # (|S_t|, C), (|S_t|,)
        a_rel, r_rel, ent = self.judge(soft, sizes)
        mask = torch.zeros(len(sel), device=self.device)
        mask[a_rel] = 1.0

        new_global = self.aggregator(self.global_params, out, sizes, mask)
        self.state = self.strategy.update_state(
            self.state, self.global_params, out, idx, cfg.num_clients)
        self.global_params = new_global

        pos = [sel[i] for i in a_rel]
        neg = [sel[i] for i in r_rel]
        self.selector.update(pos, neg)

        comm = comm_bytes(self.global_params, len(sel), len(pos),
                          soft.shape[-1],
                          control_variate=self.strategy.doubles_uplink)
        rec = {"round": self.round_idx, "selected": sel, "positive": pos,
               "negative": neg, "entropy": ent, "comm": comm}
        self.history.append(rec)
        self.round_idx += 1
        return rec

    # ------------------------------------------------------------------
    @torch.no_grad()
    def evaluate(self, x, y, batch: int = 512) -> dict:
        """Test-set accuracy/loss of the global model; ``x`` NHWC."""
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty eval set (x has 0 rows)")
        correct, loss_sum = 0.0, 0.0
        for i in range(0, n, batch):
            bx, by = x[i:i + batch], y[i:i + batch]
            logits = self.apply_fn(self.global_params, bx)[0]
            correct += float((logits.argmax(-1) == by).sum())
            loss_sum += float(cross_entropy(logits, by)) * bx.shape[0]
        return {"accuracy": correct / n, "loss": loss_sum / n}

    def fit(self, rounds: int, eval_every: int = 0, eval_data=None) -> list:
        """Run ``rounds`` rounds; returns periodic eval metrics (if any)."""
        evals = []
        for r in range(rounds):
            self.round()
            if eval_every and eval_data is not None and \
                    (r + 1) % eval_every == 0:
                m = self.evaluate(*eval_data)
                m["round"] = self.round_idx
                evals.append(m)
        return evals


def total_uplink_bytes(history: list[dict]) -> int:
    return int(sum(h["comm"]["total_bytes"] for h in history))
