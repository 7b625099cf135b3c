"""The pipelined round engine, on one card.

``PipelinedServer`` runs the exact Selector/ClientStrategy/Judge/Aggregator
composition of :class:`repro_torch.fl.Server`. With
``RuntimeConfig(speculate=True)`` it breaks the chain that paper Alg. 2
puts between the device and the host-side float64 judgment oracle by
*speculating the verdict on the device*: the traced float32 judge
(``spec_backend="cuda"``: one launch of K1's loop; ``"torch"``: its plain
loop) gives a mask without a host read, and the aggregation on that mask
(K2 with ``FusedAverageAggregator("cuda")``) queues behind it. The
round's one device-to-host copy then brings back the speculated verdict,
the soft labels and the sizes in one buffer; the host selects round t+1
on a throwaway copy of the selector and dispatches its client program
from the speculated params, and only then runs the float64 oracle, the
records and the selector work, while round t+1's graph runs. On a hit
the oracle only confirms; on a miss the speculated params and round t+1
are discarded, the oracle's verdict is aggregated, and round t+1 is
dispatched again from it (the history records ``spec_hit`` each round and
``redispatched`` on a round whose compute was re-issued).

History and params equal the sequential ``Server``'s bit for bit: the
records come from the float64 oracle; the selector's RNG stream advances
as it would sequentially (the speculative draw is on a copy, adopted only
when the verdict matches); what a selection carries rides with the copy
that made it: a queue selector's schedule, and a chain strategy's group
layout (the group, not the device, is the dispatch unit, so round t+1's
chains are read off the copy, never off the server's own selector); a
confirmed speculative aggregation is the sequential path's call on equal
inputs (``sizes`` as float32 of the same integers, a mask of equal
values). A captured client program's outputs are the graph's and round
t+1's replay overwrites them, so what outlives the dispatch is kept
first: the soft labels and sizes on the host, the client outputs cloned
on the card (2.5 MB at the paper's width), a chain cohort's
``group_id``/``chain_pos`` with them, so a miss re-aggregates round t
with round t's chains.

On a clustered server (a ``ModelBank``) the round speculates per
cluster (``_clustered_spec_round``): the traced judge runs once on each
non-empty cluster's rows (one launch of K1's loop each), the speculative
aggregation is ``perclstr`` over the bank on the combined mask, and round
t+1 is assigned against the speculatively aggregated bank and dispatched
from it; the one device-to-host copy brings back every cluster's verdict
with the soft labels and sizes.

On the streaming plane (a corpus with ``prefetch``, the
:class:`repro_torch.data.stream.HostCorpus`) round t+1 is not dispatched
before the oracle: its speculated cohort (with the selector copy's queue
schedule) is staged on the corpus's prefetch thread, gathered into pinned
memory and copied to the card on a side stream while the oracle runs;
the dispatch waits for the verdict and takes the staged cohort on a hit,
and a miss cancels it. The clustered dispatch stays eager, as in the
reference: its assignment reads the cohort's data first.

A drift event scheduled for round t+1 gates the speculative dispatch: the
round keeps its speculated aggregation but feeds the oracle's verdict back
directly, and round t+1 selects after the drift. A judge without
``traced()`` runs sequentially, as in the reference: that is the engine's
semantics, not a fallback.

**Sharding** (``RuntimeConfig.shard``): the cohort fans out over a client
mesh (:mod:`.sharding`), one block a shard position, each block's client
program on its own device and the outputs gathered on the server's
device, the mesh's first, where judgment, speculation, aggregation and the
pools stay. The server lays its corpus out over the same mesh once, at
construction (``corpus.laid_out``: a copy unless the corpus is laid out
over that mesh already, so servers that share a corpus never re-lay it
out), and each shard's block is gathered on its device. Every
dispatch (round t+1's under speculation, and a miss's re-dispatch) goes
through the same fan-out; the gathers are device copies ordered by stream
events, so speculation keeps its overlap with the oracle. ``"auto"``
shards only when more than one card is visible and the server is on a
card; ``True`` shards over ``mesh=`` (a :class:`.sharding.ClientMesh`, a
sequence of devices, or a :mod:`repro_torch.launch.mesh` grid reduced to
its client rows), by default every visible card, the server's first. A
sharded run changes the bits by the vmap's width (cuDNN and the batched
products sum in another order over a shard's block than over the whole
cohort), so bit-equality with the sequential server holds only
unsharded; ``"auto"`` on several cards shards. A mesh of another kind
of device than the server's, or not starting at the server's device,
raises: nothing runs unsharded, or on another device, in its place.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ...core.aggregation import comm_bytes
from ...core.judgment import JudgmentResult
from ...device import canonical_device, visible_devices
from ..judges import MaxEntropyJudge
from ..registry import register
from ..server import Server
from .sharding import ClientMesh, client_mesh_from, make_client_mesh


@dataclass(frozen=True)
class RuntimeConfig:
    """Engine knobs; the defaults reproduce the sequential ``Server``.

    ``spec_backend`` is the device judge of speculation: ``"cuda"`` (K1's
    loop, the default; on CPU tensors its plain version, as every kernel
    wrapper) or ``"torch"`` (the plain loop). ``shard``: ``True`` fans the
    cohort out over the engine's client mesh, ``False`` runs it on the
    server's one device, ``"auto"`` shards only when more than one card is
    visible and the server is on a card. ``donate_data`` has no
    counterpart in PyTorch (the reference donates the cohort's buffers to
    XLA) and changes nothing.
    """
    speculate: bool = False        # overlap oracle judgment with round t+1
    shard: object = "auto"         # True | False | "auto" (>1 card)
    spec_backend: str = "cuda"     # device judge for speculation
    donate_data: bool = True       # accepted; no effect in PyTorch

    def __post_init__(self):
        if self.spec_backend not in ("torch", "cuda"):
            raise ValueError(f"unknown spec_backend {self.spec_backend!r}; "
                             "expected 'torch' or 'cuda'")
        if self.shard not in ("auto", False, True):
            raise ValueError(f"shard must be 'auto', False or True, got "
                             f"{self.shard!r}")


@register("engine", "sequential")
class SequentialEngine(Server):
    """Alias of :class:`repro_torch.fl.Server` under the engine registry;
    accepts (and ignores) ``runtime=`` so ``build(..., engine=...)`` is
    uniform."""

    runtime_cls = RuntimeConfig   # build() rejects mismatched configs

    def __init__(self, *args, runtime: RuntimeConfig | None = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.runtime = runtime or RuntimeConfig()


def _combined(results, rows, m: int, device) -> JudgmentResult:
    """Per-cluster traced verdicts as one cohort-wide result on the
    device: the mask scattered to each cluster's rows, and the removal
    orders (cluster-relative) concatenated in cluster order (None if any
    judge is order-less)."""
    at = torch.as_tensor(np.concatenate(rows), device=device)
    mask = torch.zeros(m, device=device).index_copy(
        0, at, torch.cat([jr.mask.to(torch.float32) for jr in results]))
    order = None
    if all(jr.removal_order is not None for jr in results):
        order = torch.cat([jr.removal_order.to(torch.int32)
                           for jr in results])
    return JudgmentResult(mask=mask, entropy=None, initial_entropy=None,
                          num_removed=None, removal_order=order)


def _host_copy(jr, soft: torch.Tensor, sizes: torch.Tensor):
    """The round's one device-to-host copy: the speculated mask and
    removal order (int32 bits; absent for order-less judges), the soft
    labels and the sizes, concatenated on the device and copied in one
    piece. Returns (mask, order or None, soft (M, C), sizes (M,)) as
    numpy float32 (order int32)."""
    m, c = soft.shape
    parts = [jr.mask.to(torch.float32).reshape(m)]
    if jr.removal_order is not None:
        parts.append(jr.removal_order.to(torch.int32).reshape(m)
                     .view(torch.float32))
    parts += [soft.reshape(-1), sizes.reshape(m)]
    host = torch.cat(parts).cpu().numpy()
    mask, off, order = host[:m], m, None
    if jr.removal_order is not None:
        order, off = host[m:2 * m].view(np.int32), 2 * m
    return (mask, order, host[off:off + m * c].reshape(m, c),
            host[off + m * c:])


@register("engine", "pipelined")
class PipelinedServer(Server):
    """Pipelined drop-in for ``Server`` (same composition axes)."""

    runtime_cls = RuntimeConfig   # build() rejects mismatched configs

    def __init__(self, *args, runtime: RuntimeConfig | None = None,
                 mesh=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.runtime = runtime or RuntimeConfig()
        if not isinstance(self.runtime, RuntimeConfig):
            raise ValueError(
                f"{type(self).__name__} takes runtime=RuntimeConfig, got "
                f"{type(self.runtime).__name__}")
        self._mesh = mesh
        self._pending = None           # (sel, out) dispatched for round t+1
        self._redispatch_next = False  # previous speculation missed
        # the corpus is laid out over the client mesh once, here (a drifted
        # corpus keeps the layout): each cohort block is then gathered on
        # its shard's device, and the signature the programs key on holds
        # the pad. The server owns that layout; a caller's corpus laid out
        # over another mesh, or none, is copied, never re-laid out. The
        # corpus's check that the mesh starts at its device, on the same
        # kind of device, is the server's: a mesh that cannot serve this
        # server raises here, before a round.
        self._fanout = None
        if self._shard_enabled():
            self._fanout = self.client_mesh()
            self.corpus = self.corpus.laid_out(self._fanout)

    # ---------------------------------------------------------- sharding
    def _shard_enabled(self) -> bool:
        if self.runtime.shard == "auto":
            return self.device.type == "cuda" \
                and torch.cuda.device_count() > 1
        return bool(self.runtime.shard)

    def client_mesh(self) -> ClientMesh:
        """The client mesh sharded rounds run on: ``mesh=`` as given (a
        sequence of devices made a mesh; a device grid of
        :mod:`repro_torch.launch.mesh` reduced to its client rows, see
        :func:`.sharding.client_mesh_from`), or every visible card once,
        the server's first (the server alone on the CPU)."""
        if self._mesh is None:
            home = canonical_device(self.device)
            self._mesh = make_client_mesh(
                [home] + [d for d in visible_devices() if d != home]
                if home.type == "cuda" else [home])
        elif isinstance(self._mesh, (list, tuple)):
            self._mesh = make_client_mesh(self._mesh)
        elif not isinstance(self._mesh, ClientMesh):
            self._mesh = client_mesh_from(self._mesh)
        return self._mesh

    def _shard_mesh(self):
        return self._fanout

    # -------------------------------------------------------- speculation
    def _traced_judge_fn(self):
        """The on-device verdict for speculation; None disables it."""
        def make():
            # exact class (subclasses may override traced()): the
            # runtime's spec_backend picks the device implementation
            if type(self.judge) is MaxEntropyJudge:
                return self.judge.traced(self.runtime.spec_backend)
            traced = getattr(self.judge, "traced", None)
            return None if traced is None else traced()
        return self._compile_cache().get(
            ("spec-judge", self.judge, self.runtime.spec_backend), make)

    # ------------------------------------------------------------- rounds
    def round(self) -> dict:
        if not self.runtime.speculate:
            return super().round()
        spec_fn = self._traced_judge_fn()
        if spec_fn is None:       # judge has no traced form: sequential
            return super().round()
        return self._speculative_round(spec_fn)

    def _speculative_round(self, spec_fn) -> dict:
        # drift applies BEFORE selection, as sequentially; the spec_next
        # gate below keeps any pending dispatch from spanning a drift
        drifted = self._apply_drift()
        if self.bank is not None:
            return self._clustered_spec_round(spec_fn, drifted)
        cfg = self.config
        num = cfg.cohort_size()

        if self._pending is not None:
            sel, out = self._pending
            self._pending = None
            redispatched = False
        else:
            sel = self.selector.select(num)
            out = self._run_cohort(sel, self.selector)
            redispatched = self._redispatch_next
        self._redispatch_next = False
        idx = np.asarray(sel)
        # round t+1 re-partitions some clients' data: dispatching it now
        # would train on the pre-drift corpus
        spec_next = not self._drift_at(self.round_idx + 1)

        # --- device-side speculative verdict and aggregation (queued) ---
        sizes32 = out["size"].to(torch.float32)
        soft32 = out["soft_label"].to(torch.float32)
        jr = spec_fn(soft32, sizes32)
        new_global_spec = self.aggregator(self.global_params, out, sizes32,
                                          jr.mask)
        # state folding is mask-independent (Alg. 2): valid either way
        new_state = self.strategy.update_state(
            self.state, self.global_params, out, idx, cfg.num_clients)

        spec_mask, order, soft, sizes = _host_copy(jr, soft32, sizes32)
        spec_pos = [sel[i] for i in range(len(sel)) if spec_mask[i] > 0]
        if order is not None:
            spec_neg = [sel[int(k)] for k in order if k >= 0]
        else:
            # order-less judges (budgeted): index order; pools are
            # set-based, so only the SET must match the oracle's
            spec_neg = [sel[i] for i in range(len(sel))
                        if spec_mask[i] == 0]
        self.state = new_state

        # --- speculatively select and dispatch round t+1 on a copy -------
        prefetch = getattr(self.corpus, "prefetch", None)
        kept, next_out = out, None
        if spec_next:
            sel_copy = copy.deepcopy(self.selector)
            sel_copy.update(spec_pos, spec_neg)
            next_sel = sel_copy.select(num)
            # the copy made this selection, so its queue schedule rides
            # with the dispatch (and with the prefetch)
            if prefetch is None:
                # round t+1's replay overwrites a captured program's
                # outputs; the miss path (and a judge on the device) read
                # them after it
                kept = pytree.tree_map(torch.clone, out)
                next_out = self._run_cohort(next_sel, sel_copy,
                                            new_global_spec)
            else:
                # streaming plane: a dispatch here would block this thread
                # on the host gather and upload of round t+1's cohort.
                # Stage it on the prefetch thread instead, while the oracle
                # runs below; the dispatch waits for the verdict (a hit
                # takes the staged cohort, a miss only discards it). The
                # schedule's counts are fixed at select time, so the
                # dispatch's own read gives the same key.
                sched = getattr(sel_copy, "data_schedule", None)
                prefetch(np.asarray(next_sel),
                         None if sched is None else sched(next_sel))

        # --- the oracle, on the host while round t+1 runs ----------------
        if getattr(self.judge, "on_host", False):
            a_rel, r_rel, ent = self.judge(torch.from_numpy(soft),
                                           torch.from_numpy(sizes))
        else:
            a_rel, r_rel, ent = self.judge(kept["soft_label"], kept["size"])
        mask = np.zeros(len(sel), np.float32)
        mask[a_rel] = 1.0
        pos = [sel[i] for i in a_rel]
        neg = [sel[i] for i in r_rel]

        hit = bool(np.array_equal(mask, spec_mask))
        if hit:
            self.global_params = new_global_spec
            if spec_next:
                self.selector = sel_copy      # same verdict -> same stream
                if next_out is None:
                    # streaming plane: the cohort was staged above; this
                    # dispatch takes it (a prefetch hit)
                    next_out = self._run_cohort(next_sel, sel_copy,
                                                new_global_spec)
                self._pending = (next_sel, next_out)
            else:
                # drift boundary: nothing in flight; feed the verdict back
                # directly (the sequential call)
                self.selector.update(pos, neg)
        else:                                  # discard, redo from oracle
            if spec_next and prefetch is not None:
                # selector misprediction: drop the staged cohort; the
                # re-selected round t+1 gathers synchronously
                self.corpus.cancel_prefetch()
            self.global_params = self.aggregator(
                self.global_params, kept, kept["size"],
                torch.as_tensor(mask, device=self.device))
            self.selector.update(pos, neg)
            # a miss forces a re-dispatch only if round t+1 was issued
            self._redispatch_next = spec_next

        comm = comm_bytes(self.global_params, len(sel), len(pos),
                          soft.shape[-1],
                          control_variate=self.strategy.doubles_uplink)
        rec = {"round": self.round_idx, "selected": sel, "positive": pos,
               "negative": neg, "entropy": ent, "comm": comm,
               "spec_hit": hit, "redispatched": redispatched}
        self.history.append(rec)
        self.round_idx += 1
        return rec

    # ------------------------------------------------- clustered speculation
    def _clustered_spec_round(self, spec_fn, drifted) -> dict:
        """The speculative round over a K-center ModelBank.

        As ``_speculative_round`` with three differences: the traced judge
        runs per cluster (masks combined over the cohort), the speculative
        aggregation is the ``perclstr`` masked mean over the bank, and the
        speculative NEXT assignment is computed against the speculatively
        aggregated bank. On an oracle hit that bank is bitwise the one the
        sequential path makes, so the assignment is too; on a miss the
        dispatch is discarded as in the unclustered path. Assignment-state
        folding (FeSEM) is verdict-independent and runs once a round,
        before any speculative next-round assignment reads it.
        """
        cfg = self.config
        num = cfg.cohort_size()

        if self._pending is not None:
            sel, cids, out = self._pending
            self._pending = None
            redispatched = False
        else:
            sel = self.selector.select(num)
            cids = self.cluster.assign(sel)
            out = self._dispatch_banked(sel, self.selector, cids)
            redispatched = self._redispatch_next
        self._redispatch_next = False
        idx = np.asarray(sel)
        cids = np.asarray(cids)
        spec_next = not self._drift_at(self.round_idx + 1)

        # --- per-cluster device verdicts (clusters ascending, the
        # oracle's own order), combined into one cohort mask (queued) ---
        sizes32 = out["size"].to(torch.float32)
        soft32 = out["soft_label"].to(torch.float32)
        rows, results = [], []
        for k in sorted(int(c) for c in np.unique(cids)):
            r = np.where(cids == k)[0]
            at = torch.as_tensor(r, device=self.device)
            rows.append(r)
            results.append(spec_fn(soft32.index_select(0, at),
                                   sizes32.index_select(0, at)))
        jr = _combined(results, rows, len(sel), self.device)
        out_c = self._with_clusters(out, cids)
        bank_spec = self.bank.replace(self.aggregator(
            self.bank.stacked, out_c, sizes32, jr.mask))
        new_state = self.strategy.update_state(
            self.state, self.bank.stacked, out, idx, cfg.num_clients)

        spec_mask, order, soft, sizes = _host_copy(jr, soft32, sizes32)
        spec_pos, spec_neg, off = [], [], 0
        for r in rows:
            spec_pos.extend(sel[int(r[i])] for i in range(len(r))
                            if spec_mask[r[i]] > 0)
            if order is not None:
                spec_neg.extend(sel[int(r[int(j)])]
                                for j in order[off:off + len(r)] if j >= 0)
            else:
                spec_neg.extend(sel[int(r[i])] for i in range(len(r))
                                if spec_mask[r[i]] == 0)
            off += len(r)
        self.state = new_state
        # once a round, against the PRE-aggregation centers, BEFORE the
        # speculative next assignment reads the sticky state it may change
        self.cluster.update(sel, cids, out, self.bank)

        # --- speculatively select, assign and dispatch round t+1 ---------
        kept_c = out_c
        if spec_next:
            # round t+1's replay overwrites a captured program's outputs;
            # the miss path (and a judge on the device) read them after it
            kept_c = pytree.tree_map(torch.clone, out_c)
            sel_copy = copy.deepcopy(self.selector)
            sel_copy.update(spec_pos, spec_neg)
            next_sel = sel_copy.select(num)
            next_cids = self.cluster.assign(next_sel, bank=bank_spec)
            next_out = self._dispatch_banked(next_sel, sel_copy, next_cids,
                                             bank=bank_spec)

        # --- the per-cluster oracle, while round t+1 runs ----------------
        if getattr(self.judge, "on_host", False):
            jsoft, jsizes = torch.from_numpy(soft), torch.from_numpy(sizes)
        else:
            jsoft, jsizes = kept_c["soft_label"], kept_c["size"]
        mask, pos, neg, ent, clusters = self._judge_clusters(
            jsoft, jsizes, cids, sel)

        hit = bool(np.array_equal(mask, spec_mask))
        if hit:
            self.bank = bank_spec
            if spec_next:
                self.selector = sel_copy      # same verdict -> same stream
                self._pending = (next_sel, next_cids, next_out)
            else:
                self.selector.update(pos, neg)
        else:                                  # discard, redo from oracle
            self.bank = self.bank.replace(self.aggregator(
                self.bank.stacked, kept_c, kept_c["size"],
                torch.as_tensor(mask, device=self.device)))
            self.selector.update(pos, neg)
            self._redispatch_next = spec_next
        self.global_params = self.bank.stacked

        comm = comm_bytes(self.bank.center(0), len(sel), len(pos),
                          soft.shape[-1],
                          control_variate=self.strategy.doubles_uplink)
        rec = {"round": self.round_idx, "selected": sel, "positive": pos,
               "negative": neg, "entropy": ent, "comm": comm,
               "cluster": [int(c) for c in cids], "clusters": clusters,
               "spec_hit": hit, "redispatched": redispatched}
        if drifted:
            rec["drift"] = [list(ev.clients) for ev in drifted]
        self.history.append(rec)
        self.round_idx += 1
        return rec
