"""The ``Server`` round loop: paper Alg. 2 with every axis pluggable.

One ``round()`` = (drift) -> select -> ClientUpdate mapped over the cohort
-> judge -> aggregate -> state/pool feedback. The data plane (client
updates, aggregation) is tensor code on ``device`` over a stacked client
axis; the control plane (selection, pool bookkeeping, the numpy judgment)
is host-side numpy. The client data lives on a *data plane*
(``data_plane=``, resolved by :func:`repro_torch.data.stream.as_data_plane`):
the device-resident :class:`repro_torch.data.corpus.ClientCorpus`, whose
cohort gather runs on the device so only the cohort's ids cross from host
to device, or the host-resident streaming
:class:`repro_torch.data.stream.HostCorpus`, which gathers the cohort on
the host and uploads it. Either way ``corpus.cohort(idx, active)`` applies
the transform and the released-sample counts of a selector that has a
``data_schedule`` (the dynamic data queue) as a weight mask, the same bits
on both planes. Selectors that rank on corpus statistics bind the corpus
once (``bind_data``). Scheduled drift events (``drift=``,
:func:`repro_torch.data.partition.drift_schedule`) replace the drifting
clients' rows at the start of their round, on the corpus's own plane.

Group-aware strategies (FedCAT's ``CatChainStrategy``) bring their own
client program (``make_client_fn``) and lay the gathered cohort out in
chain groups read off the selector that made the selection
(``prepare_round``), then put the outputs back in cohort order
(``finish_round``).

An optional fifth axis, ``cluster=`` (a :mod:`repro_torch.fl.clusters`
assigner with ``ServerConfig.num_clusters`` > 1), swaps the single global
model for a K-center ``ModelBank``: each client trains from its assigned
center (the banked program maps the params slot on axis 0), judgment runs
on each cluster's rows on their own, and the aggregator (``perclstr``)
averages each center over its admitted members. With K = 1, or with no
assigner, ``bank`` is None and the round is the single-model one.

On a CUDA device the client program (vmapped, or a strategy's chain
program) runs as a captured CUDA graph, one per key in a per-server LRU of
``ServerConfig.jit_cache_size`` entries (``fl.graph_cache``), the
counterpart of the reference's jitted program in its ``BoundedJitCache``,
or in the process-wide cache while
:func:`repro_torch.fl.runtime.enable_process_cache` is on; on the CPU, and
inside ``graph_cache.disable_capture()``, it runs eagerly.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..core.aggregation import comm_bytes
from ..core.strategies import ApplyFn, client_update, cross_entropy
from ..data.stream import as_data_plane
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
    group_size: int = 2             # FedCAT chain length (catgroups/catchain)
    num_clusters: int = 1           # K model-bank centers (1 = unclustered)

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

    ``data_plane`` is ``"auto"`` (a built corpus keeps its plane; a
    stacked dict stays on the device while its storage bytes fit
    ``RESIDENT_BUDGET_BYTES``, 1 GiB, and streams from the host past it),
    ``"resident"`` or ``"streaming"``, as in the reference; any other
    name raises ``ValueError``.
    """

    def __init__(
        self,
        apply_fn: ApplyFn,
        init_params,
        client_data,                # a corpus or x:(N,S,...), y, w dict
        config: ServerConfig,
        *,
        selector: Selector,
        strategy: ClientStrategy,
        judge: Judge,
        aggregator: Aggregator,
        data_plane: str = "auto",
        cluster=None,
        drift=None,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.global_params = pytree.tree_map(
            lambda t: torch.as_tensor(t).to(self.device), init_params)
        self._param_sig = tuple(
            (tuple(t.shape), str(t.dtype))
            for t in pytree.tree_leaves(self.global_params))
        self.corpus = as_data_plane(client_data, data_plane,
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
        # ---- the optional cluster axis (K-center ModelBank) ----------
        # K = 1 (or no assigner) keeps bank = None: every path below is
        # the single-model server's, so clustered compositions reduce to
        # it exactly
        self.cluster = cluster
        k = (getattr(cluster, "num_clusters", 1)
             if cluster is not None else 1)
        if k > 1:
            if getattr(strategy, "make_client_fn", None) is not None or \
                    getattr(strategy, "prepare_round", None) is not None:
                raise ValueError(
                    f"{type(strategy).__name__} builds its own client "
                    "fan-out (chains/groups); the clustered ModelBank "
                    "needs the plain vmapped ClientUpdate to thread "
                    "per-client start params")
            if self.state is not None:
                raise ValueError(
                    f"{type(strategy).__name__} carries cross-round "
                    "client state; clustered rounds support stateless "
                    "strategies only (per-cluster control variates are a "
                    "recorded ROADMAP follow-up)")
            from .clusters import ModelBank
            self.bank = ModelBank.init(self.global_params, k,
                                       seed=config.seed)
            self.global_params = self.bank.stacked
        else:
            self.bank = None
        make = getattr(strategy, "make_client_fn", None)
        self._eager_fn = (
            _make_client_fn(apply_fn, strategy.spec, self._client_in_axes())
            if make is None else make(apply_fn))
        self._graphs = BoundedGraphCache(config.jit_cache_size)
        self._captures = 0
        if cluster is not None:
            bindc = getattr(cluster, "bind", None)
            if bindc is not None:
                bindc(self)
        # selectors that rank on corpus stats (the queue selector's label
        # entropy) bind the corpus once; the corpus caches the stats
        bind = getattr(selector, "bind_data", None)
        if bind is not None:
            bind(self.corpus)
        # drift events apply at the START of their round (before
        # selection), replacing the drifting clients' rows
        self._drift = sorted(list(drift or ()), key=lambda e: e.round)
        s = self.corpus.samples_per_client
        for ev in self._drift:
            got = {kk: np.shape(v)[1] for kk, v in ev.data.items()}
            if any(v != s for v in got.values()):
                raise ValueError(
                    f"drift event at round {ev.round} carries rows of "
                    f"sample length {got}, corpus has {s} "
                    "(regenerate with samples_per_client=corpus's)")

    # ------------------------------------------------------------------
    def _compile_cache(self):
        """The per-server LRU, or the process-wide cache while
        ``fl.runtime.enable_process_cache()`` is on."""
        from .runtime.compile_cache import process_cache
        cache = process_cache()
        # explicit None check: an empty cache is len() == 0, hence falsy
        return self._graphs if cache is None else cache

    def _client_key(self, cohort: int, layout=None, shard=None) -> tuple:
        # a captured program fits any server with the same program and
        # argument shapes: the program (vmapped, or a strategy's own
        # chain program, tagged by the strategy's class as the reference
        # does), the apply fn (by identity; the key pins it), the
        # strategy's spec and in-axes, the params' shapes, the device, the
        # corpus signature, the cohort size and a chain cohort's (G, K)
        # layout. A drifted corpus keeps its signature, so its rounds
        # replay the same graph. The in-axes map the params slot on a
        # clustered server, so banked and broadcast graphs never alias.
        # A shard's program (``shard``: its position and the mesh) keys
        # on its position, the mesh size and its own device, so sharded
        # and unsharded programs never alias either.
        tag = ("client" if getattr(self.strategy, "make_client_fn", None)
               is None else f"client-{type(self.strategy).__name__}")
        where = str(self.device)
        if shard is not None:
            j, mesh = shard
            where = ("shard", j, len(mesh), str(mesh.devices[j]))
        return (tag, self.apply_fn, self.strategy.spec,
                self._client_in_axes(), self._param_sig,
                where, self.corpus.signature(), cohort, layout)

    def _client_in_axes(self) -> tuple:
        """The strategy's vmap in-dims, with the params slot mapped (axis
        0) on a clustered server: each cohort row then trains from its own
        center (``ModelBank.gather``'s (m, ...) stack) instead of one
        broadcast global model."""
        ax = tuple(self.strategy.client_in_axes())
        return ((0,) + ax[1:]) if self.bank is not None else ax

    def _capture(self, args, device=None) -> CapturedProgram:
        program = CapturedProgram(self._eager_fn, args, device)
        self._captures += 1
        return program

    def _client_program(self, args, cohort: int, layout=None, shard=None):
        """The client program for ``args``: a captured graph on the card,
        the eager function on the CPU (shared under the same key while
        the process cache is on) and inside ``disable_capture()``.
        ``shard`` (position, mesh): the program of one shard of a client
        fan-out, on that shard's device."""
        key = self._client_key(cohort, layout, shard)
        device = self.device if shard is None \
            else shard[1].devices[shard[0]]
        if device.type != "cuda":
            cache = self._compile_cache()
            if cache is self._graphs:
                return self._eager_fn
            return cache.get(key, lambda: self._eager_fn)
        if not capture_enabled():
            return self._eager_fn
        return self._compile_cache().get(
            key, lambda: self._capture(args, device))

    def _run_cohort(self, sel, selector, global_params=None) -> dict:
        """Gather the cohort ``sel`` and run its client updates from
        ``global_params`` (default the server's).

        ``selector`` is the one that produced ``sel`` (under speculation a
        throwaway copy): its ``data_schedule``, if it has one, gives the
        released-sample counts the gather masks into ``w``, and a
        group-aware strategy (``prepare_round``) reads the chain layout
        off it: the group, not the device, is the dispatch unit. On the
        card the vmapped program's outputs are the captured graph's, which
        the next replay overwrites; a caller clones what must outlive it.
        """
        gp = self.global_params if global_params is None else global_params
        idx = np.asarray(sel)
        sched = getattr(selector, "data_schedule", None)
        active = None if sched is None else sched(sel)
        inputs = self.strategy.client_inputs(self.state, idx)
        mesh = self._shard_mesh()
        if mesh is not None:
            return self._run_sharded(mesh, idx, selector, gp, active, inputs)
        data = self.corpus.cohort(idx, active=active)
        prep = getattr(self.strategy, "prepare_round", None)
        if prep is None:
            args = (gp, data, *inputs)
            return self._client_program(args, len(idx))(*args)
        gdata, aux = prep(data, selector)
        args = (gp, gdata, *inputs, aux["valid"])
        out = self._client_program(args, len(idx),
                                   tuple(aux["valid"].shape))(*args)
        return self.strategy.finish_round(out, aux)

    # ------------------------------------------------------ client fan-out
    def _shard_mesh(self):
        """The client mesh the cohort fans out over, or None: one program
        on the server's device (the sequential server always; the
        pipelined engine under ``RuntimeConfig.shard``)."""
        return None

    def _run_sharded(self, mesh, idx, selector, gp, active, inputs) -> dict:
        """The cohort over ``mesh``: padded to a multiple of the mesh
        (last row, or last whole chain group, repeated), each block
        gathered on its shard's device by the corpus, each shard's
        program run there, the outputs gathered on the server's device
        and cut back to the real cohort
        (:func:`repro_torch.fl.runtime.sharding.make_sharded_client_fn`).
        A chain strategy shards whole groups with their validity mask."""
        from .runtime.sharding import (ShardBlocks, make_sharded_client_fn,
                                       pad_to_multiple)
        n, m = len(mesh), len(idx)
        chain = getattr(self.strategy, "prepare_round", None) is not None
        if chain:
            lay = self.strategy.layout(m, selector)
            g, k = lay["valid"].shape
            rows = pad_to_multiple(lay["perm"], n).reshape(n, -1)
            shape, length = (g, k), g
        else:
            rows = pad_to_multiple(np.arange(m), n).reshape(n, -1)
            shape, length = None, m
        blocks = self.corpus.cohort_blocks(idx, active, rows, mesh.devices)
        if chain:
            blocks = [{key: v.reshape((-1, k) + tuple(v.shape[1:]))
                       for key, v in b.items()} for b in blocks]
        fn = make_sharded_client_fn(
            self.apply_fn, self.strategy.spec, self._client_in_axes(), mesh,
            inner=self._eager_fn, inner_axes=(0,) if chain else (),
            program=lambda j, args: self._client_program(
                args, m, shape, (j, mesh)))
        if not chain:
            return fn(gp, ShardBlocks(blocks, length), *inputs)
        aux = self.strategy.layout_aux(lay, self.device)
        out = fn(gp, ShardBlocks(blocks, length), *inputs, aux["valid"])
        return self.strategy.finish_round(out, aux)

    @property
    def graphs_captured(self) -> int:
        """How many client programs this server has captured (a program
        found in the process cache counts for the server that built
        it)."""
        return self._captures

    def drop_graphs(self) -> None:
        """Drop this server's captured client programs (not the process
        cache's) and with them the memory pools their graphs hold; the
        next round captures again."""
        self._graphs.clear()

    # -------------------------------------------------------------- drift
    def _apply_drift(self) -> list:
        """Apply every drift event scheduled for the current round (before
        selection): a new corpus on the same plane with the drifting
        clients' rows replaced (on the device for the resident plane; on
        the host, copying only the rewritten arrays, for the streaming
        one), and the selector's stats bound to it. Returns the applied
        events (a clustered record notes them)."""
        applied = []
        while self._drift and self._drift[0].round == self.round_idx:
            ev = self._drift.pop(0)
            self.corpus = self.corpus.with_rows(ev.clients, ev.data)
            bind = getattr(self.selector, "bind_data", None)
            if bind is not None:
                bind(self.corpus)
            applied.append(ev)
        return applied

    def _drift_at(self, round_no: int) -> bool:
        """True if a drift event is still scheduled for ``round_no``: the
        pipelined engine must not speculate across that boundary."""
        return any(ev.round == round_no for ev in self._drift)

    # ---------------------------------------------------------- clustering
    def _dispatch_banked(self, sel, selector, cluster_ids, bank=None):
        """The clustered cohort dispatch: each client starts from its
        assigned center, gathered off ``bank`` (the server's own unless a
        speculative bank is passed)."""
        bank = self.bank if bank is None else bank
        return self._run_cohort(sel, selector, bank.gather(cluster_ids))

    def _judge_inputs(self, out) -> tuple[torch.Tensor, torch.Tensor]:
        """The round's soft labels and sizes where the judge reads them:
        one host copy of both for a judge ``on_host``, else the device
        tensors."""
        soft, sizes = out["soft_label"], out["size"]
        if not getattr(self.judge, "on_host", False):
            return soft, sizes
        m, c = soft.shape
        host = torch.cat([soft.reshape(-1), sizes.reshape(-1)]).cpu()
        return host[:m * c].view(m, c), host[m * c:]

    def _judge_clusters(self, soft, sizes, cluster_ids, sel):
        """Per-cluster judgment: the composition's judge runs on each
        cluster's member rows on their own (clusters ascending; on the
        ``"cuda"`` judge one launch of K1's loop per non-empty cluster).

        Returns ``(mask, pos, neg, entropy, clusters)``: the combined 0/1
        admission mask over the cohort (numpy float32), positive and
        negative client ids (clusters ascending, the judge's own order
        within each), the member-count-weighted mean of the per-cluster
        group entropies, and the per-cluster verdicts the record keeps.
        """
        cluster_ids = np.asarray(cluster_ids)
        mask = np.zeros(len(sel), np.float32)
        pos, neg, clusters = [], [], {}
        ents = []
        for k in sorted(int(c) for c in np.unique(cluster_ids)):
            rows = np.where(cluster_ids == k)[0]
            at = torch.as_tensor(rows, device=soft.device)
            a_rel, r_rel, ent = self.judge(soft.index_select(0, at),
                                           sizes.index_select(0, at))
            mask[rows[a_rel]] = 1.0
            p = [sel[int(rows[i])] for i in a_rel]
            n = [sel[int(rows[i])] for i in r_rel]
            pos.extend(p)
            neg.extend(n)
            clusters[str(k)] = {
                "members": [sel[int(i)] for i in rows],
                "positive": p, "negative": n, "entropy": ent}
            if not np.isnan(ent):
                ents.append((len(rows), ent))
        total = sum(n for n, _ in ents)
        entropy = (sum(n * e for n, e in ents) / total
                   if total else float("nan"))
        return mask, pos, neg, entropy, clusters

    def _with_clusters(self, out, cluster_ids) -> dict:
        """``out`` with the round's cluster ids on the device, for
        ``perclstr``."""
        out_c = dict(out)
        out_c["cluster"] = torch.as_tensor(
            np.asarray(cluster_ids, np.int32), device=self.device)
        return out_c

    def _clustered_round(self) -> dict:
        """One clustered Alg. 2 round: assign -> per-center ClientUpdate
        -> per-cluster judgment -> per-cluster aggregation -> feedback."""
        cfg = self.config
        sel = self.selector.select(cfg.cohort_size())
        idx = np.asarray(sel)
        cids = self.cluster.assign(sel)
        out = self._dispatch_banked(sel, self.selector, cids)

        soft, sizes = self._judge_inputs(out)
        mask, pos, neg, ent, clusters = self._judge_clusters(
            soft, sizes, cids, sel)

        new_stacked = self.aggregator(
            self.bank.stacked, self._with_clusters(out, cids), out["size"],
            torch.as_tensor(mask, device=self.device))
        self.state = self.strategy.update_state(
            self.state, self.bank.stacked, out, idx, cfg.num_clients)
        # assignment state folds against the PRE-aggregation centers
        # (verdict-independent: the speculation contract)
        self.cluster.update(sel, cids, out, self.bank)
        self.bank = self.bank.replace(new_stacked)
        self.global_params = self.bank.stacked
        self.selector.update(pos, neg)

        # positives ship ONE model each (their own center), so the
        # template is a single center, never the K-stacked bank
        comm = comm_bytes(self.bank.center(0), len(sel), len(pos),
                          soft.shape[-1],
                          control_variate=self.strategy.doubles_uplink)
        rec = {"round": self.round_idx, "selected": sel, "positive": pos,
               "negative": neg, "entropy": ent, "comm": comm,
               "cluster": [int(c) for c in cids], "clusters": clusters}
        self.history.append(rec)
        self.round_idx += 1
        return rec

    # ------------------------------------------------------------------
    def round(self) -> dict:
        """One paper Alg. 2 round; returns the history record."""
        drifted = self._apply_drift()
        if self.bank is not None:
            rec = self._clustered_round()
            if drifted:
                rec["drift"] = [list(ev.clients) for ev in drifted]
            return rec
        cfg = self.config
        sel = self.selector.select(cfg.cohort_size())
        idx = np.asarray(sel)
        out = self._run_cohort(sel, self.selector)

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
    def evaluate(self, x, y, batch: int = 512,
                 center: int | None = None) -> dict:
        """Test-set accuracy/loss of the global model; ``x`` NHWC. On a
        clustered server ``center`` picks the bank center to score
        (default 0, the un-jittered lineage of the init params);
        unclustered servers ignore it."""
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        n = x.shape[0]
        if n == 0:
            raise ValueError("empty eval set (x has 0 rows)")
        params = self.global_params if self.bank is None \
            else self.bank.center(0 if center is None else int(center))
        correct, loss_sum = 0.0, 0.0
        for i in range(0, n, batch):
            bx, by = x[i:i + batch], y[i:i + batch]
            logits = self.apply_fn(params, bx)[0]
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
