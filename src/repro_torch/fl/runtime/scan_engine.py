"""Blocks of rounds: R speculative rounds as one CUDA graph.

Every other engine comes back to the host once a round: the selector's
draw, the float64 judgment, the record. ``ScanServer`` (registry
``engine="scan"``, ``ScanConfig(rounds_per_scan=R)``) runs R whole rounds
as one *block*, the port's counterpart of the reference's ``lax.scan``:
each step draws its cohort, gathers it from the resident corpus
(:meth:`repro_torch.data.corpus.ClientCorpus.traced_cohort`), runs the
client program, *speculates the verdict on the device* with the judge's
traced form (``spec_backend="cuda"``: one launch of K1's loop) and
aggregates on that mask (K2 under ``FusedAverageAggregator("cuda")``); the
params are the carry, so the host touches the card once a block.

On the card, with ``spec_backend="cuda"``, the whole block is captured as
one CUDA graph (:class:`repro_torch.fl.graph_cache.CapturedProgram`, in
a cache of the server's own with one entry per depth 1..R, or in the
process cache while it is on) and replayed: gather, client program,
K1's loop, aggregation and pool refile of R rounds in one launch from
the host. A graph cannot replay inside another's capture, so the block
calls the eager client function, and its graph holds R copies of the
client program. Everywhere else the block runs eagerly: on the CPU,
inside ``fl.disable_capture()``, and with ``spec_backend="torch"``,
whose plain loop reads a stop flag on the host every iteration.
``stats()["captured_block"]`` says which route ran. A capture that fails
raises.

**The client axis** (``ScanConfig(shard=True)``, or ``"auto"`` on
several visible cards, the pipelined engine's rule): each step fans its
cohort out over the server's :class:`~.sharding.ClientMesh`, as the
reference's ``lax.scan`` does over its ``"clients"`` mesh. The server
lays the corpus out over the mesh once, at construction
(``ClientCorpus.laid_out``); each step gathers one block a shard position
on its device from the cohort's ids on the device
(:meth:`repro_torch.data.corpus.ClientCorpus.traced_blocks`, no host
read), runs the eager client program on each shard
(:func:`~.sharding.make_sharded_client_fn`) and gathers the outputs on the
mesh's first device, the server's, cut to the real cohort. K1's loop, the
aggregation, the pools' refile and the per-round outputs run there, and
the params reach each shard's device at the next step's fan-out. On a
mesh whose positions all name the server's card the block is one captured
graph, as above. On a mesh over distinct cards it runs eagerly (a CUDA
graph is captured on one card's streams), decided from the mesh before
any launch and shown in ``stats()["captured_block"]``. The records are
the sequential server's; the params equal the pipelined engine's
``shard=True`` rounds on the same mesh bit for bit (the same per-shard
programs), and part from the unsharded engine's only by the vmap's width.

**Selection** (``ScanConfig.selection``):

* ``"replay"`` (default): the host draws all R cohorts from the real
  ``UniformSelector`` before the block and passes them in as (R, m) rows.
  A uniform draw does not depend on the verdict and its ``update`` does
  nothing, so the stream is the sequential ``Server``'s.
* ``"device"``: the block carries a threefry key and each step draws
  ``permutation(split(key)[1], N)[:m]`` on the card, the reference's
  ``jax.random.choice(..., replace=False)`` stream (reproducible per
  seed; not the numpy selector's).

**Traced pools**: with a :class:`repro_torch.fl.selectors.TracedPoolSelector`
(``selector="pools-traced"``, the ``fedentropy-traced`` composition) the
block carries the pool masks and the key, each step draws with
:func:`repro_torch.core.pools.pools_draw` and re-files with
:func:`~repro_torch.core.pools.pools_refile` on the *speculated* verdict,
and the host mirror replays the confirmed draws (``fold_drawn`` then
``update``), so a block walks the sequential server's selector states
(``selection`` is then ignored: the pool draw is the selection).

**Memory** (``ScanConfig.params_mode``): ``"stack"`` (default) keeps the
params after every round in the block's outputs, R rewind points;
``"remat"`` keeps only the verdict inputs (soft labels, sizes, cohorts,
masks, keys) and, on a mismatch at round j, rebuilds the rewind point by
running a depth-j block from the block's start carry: the same ops on the
same inputs, so bit for bit ``"stack"``'s.

**Oracle replay** (the ``PipelinedServer`` contract): the host copies the
block's per-round outputs to itself in one piece, then replays each
round's verdict through the composition's own judge (the float64 oracle).
The records always come from it. Rounds whose speculated mask matches are
confirmed (``spec_hit=True``); at the first mismatch the block is cut:
the params rewind to the last confirmed round's, the mismatched round
runs again eagerly from the oracle's verdict as the sequential ``Server``
runs it (``spec_hit=False``), and the rounds left run as a shorter block
whose confirmed rounds carry ``redispatched=True``.

**Eligibility**: a block without the host needs a verdict-independent or
traced selector, a stateless strategy without group dispatch, a traced
judge, a single model and no drift schedule. Anything else falls back to
``rounds_per_scan=1``, plain sequential rounds, with one warning and
machine-readable reasons (:attr:`ScanServer.fallback_reasons`, in
:meth:`ScanServer.stats` and on every fallback round's record under
``"scan_fallback"``), as in the reference.

Block semantics: ``round()`` returns one record at a time, but the params
advance a block at once; an ``evaluate()`` between two ``round()`` calls
of one block sees the block's last model.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ...core import threefry
from ...core.aggregation import comm_bytes
from ...core.pools import pools_draw, pools_refile
from ..graph_cache import BoundedGraphCache, CapturedProgram, capture_enabled
from ..registry import register
from ..selectors import TracedPoolSelector, UniformSelector
from .engine import PipelinedServer, RuntimeConfig
from .sharding import ShardBlocks, device_layout, make_sharded_client_fn

log = logging.getLogger(__name__)

_SELECTION = ("replay", "device")
_PARAMS_MODES = ("stack", "remat")
# the per-round outputs the host copies, in this order (the key first,
# so every field starts 8-byte aligned in the host copy)
_YS_HOST = ("key", "sel", "soft", "size", "mask")


@dataclass(frozen=True)
class ScanConfig:
    """Knobs of :class:`ScanServer`; R = 1 is the sequential ``Server``.

    ``spec_backend`` is the block's device judge, ``"cuda"`` (K1's loop,
    the default) or ``"torch"`` (the plain loop, which runs the block
    eagerly). ``shard`` as in ``RuntimeConfig``: ``True`` fans each block
    step's cohort out over the server's client mesh (``fl.build(...,
    mesh=...)``, default every visible card), ``"auto"`` does so on
    several visible cards and never on the CPU, ``False`` never.
    ``donate_data`` changes nothing.
    """
    rounds_per_scan: int = 4      # R rounds a block
    spec_backend: str = "cuda"    # the block's device judge
    selection: str = "replay"     # "replay" (host draws) | "device"
    params_mode: str = "stack"    # rewind points: "stack" | "remat"
    shard: object = "auto"
    donate_data: bool = True

    def __post_init__(self):
        if self.rounds_per_scan < 1:
            raise ValueError("rounds_per_scan must be >= 1")
        if self.selection not in _SELECTION:
            raise ValueError(f"unknown selection {self.selection!r}; "
                             f"expected one of {_SELECTION}")
        if self.params_mode not in _PARAMS_MODES:
            raise ValueError(f"unknown params_mode {self.params_mode!r}; "
                             f"expected one of {_PARAMS_MODES}")
        self.runtime()          # spec_backend and shard, checked there

    def runtime(self) -> RuntimeConfig:
        """The inherited engine's config: speculation per round off (the
        block speculates), the same device judge, ``shard`` unchanged (the
        inherited constructor lays the corpus out over the mesh)."""
        return RuntimeConfig(speculate=False, shard=self.shard,
                             spec_backend=self.spec_backend,
                             donate_data=self.donate_data)


def _host_copy(ys: dict) -> dict:
    """The block's per-round outputs but the params, copied to the host in
    one piece (each field's bytes, concatenated on the device) and viewed
    there as numpy arrays of their own dtypes and shapes."""
    names = [k for k in _YS_HOST if k in ys]
    host = torch.cat([ys[k].reshape(-1).view(torch.uint8)
                      for k in names]).cpu().numpy()
    out, off = {}, 0
    for k in names:
        t = ys[k]
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out[k] = host[off:off + nbytes].view(dtype).reshape(tuple(t.shape))
        off += nbytes
    return out


def _cloned(tree):
    return pytree.tree_map(torch.clone, tree)


class _Pinned:
    """A cache-key part that compares by identity and keeps its object
    alive: an entry keyed on it holds the object, so the device memory a
    captured graph reads through it is not freed or reused while the
    entry lives."""
    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Pinned) and other.obj is self.obj


@register("engine", "scan")
class ScanServer(PipelinedServer):
    """Blocks of R rounds, one CUDA graph each on the card; a drop-in for
    ``Server`` (the same composition axes)."""

    runtime_cls = ScanConfig      # build() rejects mismatched configs

    def __init__(self, *args, runtime: ScanConfig | None = None, **kwargs):
        cfg = runtime if runtime is not None else ScanConfig()
        if not isinstance(cfg, ScanConfig):
            raise ValueError(
                f"ScanServer takes runtime=ScanConfig, got "
                f"{type(cfg).__name__} (RuntimeConfig drives the "
                "sequential and pipelined engines, AsyncConfig async)")
        super().__init__(*args, runtime=cfg.runtime(), **kwargs)
        self.scan_config = cfg
        self._ready: list[dict] = []      # confirmed records, not yet popped
        self._scan_rounds: int | None = None   # the effective R, once
        self.fallback_reasons: list[dict] | None = None
        self._blocks = 0                  # block programs run
        self._mismatch_rounds = 0         # rounds replayed off the oracle
        self._captured_block: bool | None = None   # route of the last block
        # block graphs by depth, apart from the client programs' LRU: a cut
        # block runs at every depth 1..R, and sharing jit_cache_size
        # entries would evict the depth-R graph after a miss
        self._block_graphs = BoundedGraphCache(cfg.rounds_per_scan)
        self._key = (threefry.prng_key(self.config.seed)
                     if cfg.selection == "device" else None)

    # -------------------------------------------------------- eligibility
    def _pool_fold(self) -> bool:
        """The selector is the traced pools the block carries (the exact
        class: a subclass may change what the fold replays)."""
        return type(self.selector) is TracedPoolSelector

    def scan_rounds(self) -> int:
        """The effective R: ``rounds_per_scan`` when the composition can
        run as blocks, else 1 (sequential rounds, one warning)."""
        if self._scan_rounds is None:
            self._scan_rounds = self._resolve_scan_rounds()
        return self._scan_rounds

    def _resolve_scan_rounds(self) -> int:
        R = self.scan_config.rounds_per_scan
        reasons: list[dict] = []
        if (type(self.selector) is not UniformSelector
                and not self._pool_fold()):
            reasons.append({
                "code": "verdict-coupled-selector",
                "component": type(self.selector).__name__,
                "detail": "the selector couples the next draw to the "
                          "previous verdict on the host; only "
                          "UniformSelector (verdict-independent) or "
                          "TracedPoolSelector (selector=\"pools-traced\", "
                          "the eps-greedy pools carried on the device) "
                          "fold"})
        if self.state is not None:
            reasons.append({
                "code": "stateful-strategy",
                "component": type(self.strategy).__name__,
                "detail": "the strategy carries cross-round client state "
                          "the block cannot checkpoint per round"})
        if getattr(self.strategy, "prepare_round", None) is not None:
            reasons.append({
                "code": "group-dispatch",
                "component": type(self.strategy).__name__,
                "detail": "the strategy lays out whole device groups per "
                          "round (prepare_round)"})
        # the streaming plane (HostCorpus) gathers on the host, so a block
        # cannot carry its gather: only the resident plane folds
        if not hasattr(self.corpus, "traced_cohort"):
            reasons.append({
                "code": "host-data-plane",
                "component": type(self.corpus).__name__,
                "detail": "the data plane has no device-side gather"})
        if self._traced_judge_fn() is None:
            reasons.append({
                "code": "untraced-judge",
                "component": type(self.judge).__name__,
                "detail": "the judge has no traced form"})
        if self.bank is not None:
            reasons.append({
                "code": "cluster-dispatch",
                "component": type(self.cluster).__name__,
                "detail": "clustered rounds assign clients to ModelBank "
                          "centers on the host every round and judge per "
                          "cluster; a block cannot carry the K-center "
                          "bank without the host"})
        if self._drift:
            reasons.append({
                "code": "drift-schedule",
                "component": "DriftEvent",
                "detail": "a drift schedule rebuilds the corpus "
                          "mid-training; a block gathers from the corpus "
                          "it was built over, so its rounds would train "
                          "on pre-drift data"})
        self.fallback_reasons = reasons
        if R == 1:
            return 1
        if reasons:
            log.warning(
                "scan engine: falling back to rounds_per_scan=1 "
                "(sequential rounds) — %s",
                "; ".join(f"[{r['code']}] {r['component']}: {r['detail']}"
                          for r in reasons))
            return 1
        return R

    def _capture_block(self) -> bool:
        """True when the block runs as one captured graph: on the card,
        outside ``disable_capture()``, with K1's loop as the device judge
        (the plain loop reads the host), unsharded or on a mesh whose
        positions all name the server's card (a graph is captured on one
        card's streams; a mesh over distinct cards runs eagerly)."""
        mesh = self._fanout
        return (self.device.type == "cuda" and capture_enabled()
                and self.runtime.spec_backend == "cuda"
                and (mesh is None or set(mesh.devices) == {mesh.home}))

    def stats(self) -> dict:
        """The engine's state: the effective R, why a fold was refused
        (empty when folding), the modes, the block and mismatch counts,
        whether the last block ran as a captured graph (None before any
        block), and the shard positions a step fans out over (1
        unsharded)."""
        self.scan_rounds()
        sel_stats = getattr(self.selector, "stats", dict)()
        return {
            "engine": "scan",
            "rounds_per_scan": self.scan_config.rounds_per_scan,
            "effective_rounds_per_scan": self.scan_rounds(),
            "fallback_reasons": [dict(r) for r in self.fallback_reasons],
            "params_mode": self.scan_config.params_mode,
            "selection": self.scan_config.selection,
            "spec_backend": self.runtime.spec_backend,
            "pool_fold": self._pool_fold(),
            "blocks": self._blocks,
            "mismatch_rounds": self._mismatch_rounds,
            "captured_block": self._captured_block,
            "shards": 1 if self._fanout is None else len(self._fanout),
            "selector": sel_stats,
        }

    # ------------------------------------------------------ block program
    def _block_fn(self, r: int):
        """The eager block of ``r`` speculative rounds.

        ``block(params, key, pos, neg, rows) -> (params, key, pos, neg,
        ys)``: ``rows`` is the (r, m) int32 matrix of host-drawn cohorts
        (replay mode; unread otherwise), ``pos``/``neg`` the pool masks
        (pool fold; empty otherwise), ``key`` the threefry key (pool fold
        and device selection; unread in replay). ``ys`` holds per round
        (leading axis r, in buffers made before the steps, shaped as
        :meth:`block_ys_shapes`): the cohort, the soft labels and sizes
        (the oracle's inputs), the speculated mask, the key after the draw
        where one is carried, and in ``"stack"`` mode the params after the
        round. Pure in its inputs: the warm-up before a capture changes
        nothing.

        Sharded, each step gathers its cohort in one block a shard
        position (``ClientCorpus.traced_blocks`` on the layout
        :func:`~.sharding.device_layout` builds on the device) and fans
        the eager client program out over the mesh
        (:func:`~.sharding.make_sharded_client_fn`), whose outputs come
        back to the server's device cut to the m real rows.
        """
        spec_fn = self._traced_judge_fn()
        agg = self.aggregator
        corpus = self.corpus
        pool_fold = self._pool_fold()
        on_device_sel = (self.scan_config.selection == "device"
                         and not pool_fold)
        n = self.config.num_clients
        m = min(self.config.cohort_size(), n)
        mesh = self._fanout
        if mesh is None:
            client, gather = self._eager_fn, corpus.traced_cohort
        else:
            client = make_sharded_client_fn(
                self.apply_fn, self.strategy.spec, self._client_in_axes(),
                mesh, inner=self._eager_fn, inner_axes=())

            def gather(sel):
                return ShardBlocks(corpus.traced_blocks(
                    sel, device_layout(m, len(mesh), sel.device)), m)
        eps = self.selector.eps if pool_fold else 0.0
        shapes = self.block_ys_shapes(r)

        def block(params, key, pos, neg, rows):
            ys = pytree.tree_map(
                lambda s: torch.empty(s.shape, dtype=s.dtype,
                                      device=rows.device), shapes)
            for j in range(r):
                if pool_fold:
                    sel, key = pools_draw(key, pos, neg, num=m, eps=eps)
                elif on_device_sel:
                    keys = threefry.split(key)
                    key = keys[0]
                    sel = threefry.permutation(keys[1], n)[:m] \
                        .to(torch.int32)
                else:
                    sel = rows[j]
                out = client(params, gather(sel), None, None, None)
                sizes32 = out["size"].to(torch.float32)
                jr = spec_fn(out["soft_label"].to(torch.float32), sizes32)
                params = agg(params, out, sizes32, jr.mask)
                if pool_fold:
                    pos, neg = pools_refile(pos, neg, sel, jr.mask)
                ys["sel"][j] = sel
                ys["soft"][j] = out["soft_label"]
                ys["size"][j] = out["size"]
                ys["mask"][j] = jr.mask
                if "key" in ys:
                    ys["key"][j] = key
                if "params" in ys:
                    for dst, src in zip(pytree.tree_leaves(ys["params"]),
                                        pytree.tree_leaves(params)):
                        dst[j] = src
            return params, key, pos, neg, ys

        return block

    def _block_cache(self):
        """Where block graphs live: the process cache while it is on
        (shared by every server whose blocks fit), else this server's own
        LRU of ``rounds_per_scan`` entries, one for each depth."""
        from .compile_cache import process_cache
        cache = process_cache()
        return self._block_graphs if cache is None else cache

    def _block_key(self, r: int) -> tuple:
        """The cache key of a depth-``r`` block graph. The graph gathers
        from this corpus's tensors, so the corpus is in the key, pinned:
        the entry keeps it alive, and a later corpus never takes its
        address while the entry lives. The mesh's devices (None
        unsharded) keep sharded and unsharded blocks apart."""
        m = min(self.config.cohort_size(), self.config.num_clients)
        mesh = None if self._fanout is None else self._fanout.devices
        return (("scan-block", r, self.scan_config.selection,
                 self.scan_config.params_mode, self._pool_fold(),
                 self.selector.eps if self._pool_fold() else 0.0,
                 self.runtime.spec_backend, self.aggregator, self.judge,
                 _Pinned(self.corpus), mesh) + self._client_key(m))

    def _block_program(self, r: int, args: tuple):
        """The depth-``r`` block for ``args``: a captured graph from
        :meth:`_block_cache` on the card (see :meth:`_capture_block`),
        else the eager block."""
        self._captured_block = self._capture_block()
        if not self._captured_block:
            return self._block_fn(r)
        return self._block_cache().get(
            self._block_key(r),
            lambda: CapturedProgram(self._block_fn(r), args))

    # ------------------------------------------------- memory introspection
    def _soft_label_dtypes(self) -> tuple[int, torch.dtype, torch.dtype]:
        """(classes, soft-label dtype, size dtype) of the client program's
        outputs, from the model's forward on meta tensors (nothing
        runs). It reads one row of the corpus's first block (a laid-out
        corpus's ``corpus["x"]`` concatenates every block)."""
        block = getattr(self.corpus, "block", None)
        arrays = self.corpus if block is None else block(0)
        x = torch.as_tensor(arrays["x"][:1, :1]).to("meta")[0]
        if self.corpus.transform is not None:
            x = self.corpus.transform(x)
        params = pytree.tree_map(lambda t: t.to("meta"), self.global_params)
        logits = self.apply_fn(params, x)[0]
        w = torch.as_tensor(arrays["w"][:1, :1]).dtype
        return (int(logits.shape[-1]), torch.promote_types(logits.dtype, w),
                w)

    def block_ys_shapes(self, r: int | None = None) -> dict:
        """A depth-``r`` block's per-round outputs as meta tensors (shape
        and dtype; nothing runs). A ``"remat"`` block has no ``"params"``:
        its footprint is O(cohort x classes) a round, whatever the model's
        size. A sharded block's are the same: the fan-out's outputs are
        cut to the m real rows on the server's device before they are
        written."""
        R = int(r) if r is not None else self.scan_rounds()
        m = min(self.config.cohort_size(), self.config.num_clients)
        c, soft_dtype, size_dtype = self._soft_label_dtypes()

        def meta(shape, dtype):
            return torch.empty(shape, dtype=dtype, device="meta")

        ys = {"sel": meta((R, m), torch.int32),
              "soft": meta((R, m, c), soft_dtype),
              "size": meta((R, m), size_dtype),
              "mask": meta((R, m), torch.float32)}
        if self._pool_fold() or self.scan_config.selection == "device":
            ys["key"] = meta((R, 2), torch.int64)
        if self.scan_config.params_mode == "stack":
            ys["params"] = pytree.tree_map(
                lambda t: meta((R,) + tuple(t.shape), t.dtype),
                self.global_params)
        return ys

    def stacked_ys_nbytes(self, r: int | None = None) -> int:
        """Device bytes a depth-``r`` block's per-round outputs hold."""
        return int(sum(t.numel() * t.element_size() for t in
                       pytree.tree_leaves(self.block_ys_shapes(r))))

    def _fold_state(self):
        """(key, pos, neg) on the server's device: the pools' carry, or
        the device-selection key with empty masks (an unread key in
        replay mode)."""
        if self._pool_fold():
            return self.selector.fold_carry(self.device)
        empty = torch.zeros(0, device=self.device)
        key = self._key if self._key is not None else threefry.prng_key(0)
        return key.to(self.device), empty, empty

    # ------------------------------------------------------------- rounds
    def round(self) -> dict:
        """One Alg. 2 round record; runs a whole block of R rounds when no
        confirmed record is waiting."""
        if not self._ready:
            R = self.scan_rounds()
            if R == 1:
                rec = super().round()         # the sequential round
                if self.fallback_reasons:
                    rec["scan_fallback"] = [
                        r["code"] for r in self.fallback_reasons]
                return rec
            self._run_block(R)
        rec = self._ready.pop(0)
        self.history.append(rec)
        self.round_idx += 1
        return rec

    def _run_block(self, R: int) -> None:
        cfg = self.config
        num = min(cfg.cohort_size(), cfg.num_clients)
        base = self.round_idx
        pool_fold = self._pool_fold()
        replay = self.scan_config.selection == "replay" and not pool_fold
        remat = self.scan_config.params_mode == "remat"
        if replay:
            # all R cohorts from the real selector: a uniform draw does not
            # depend on the verdict, so this is the sequential stream
            rows = np.stack([np.asarray(self.selector.select(num), np.int32)
                             for _ in range(R)])
        else:
            rows = np.zeros((R, num), np.int32)      # unread
        rows = torch.as_tensor(rows, device=self.device)
        on_host = getattr(self.judge, "on_host", False)
        done = 0
        redispatched = False    # rounds of a block run after a cut
        params = self.global_params
        while done < R:
            r = R - done
            key, pos, neg = self._fold_state()
            seg = (params, key, pos, neg, rows[done:])   # the remat anchor
            params_out, _, _, _, ys = self._block_program(r, seg)(*seg)
            self._blocks += 1
            host = _host_copy(ys)

            mismatch_at = None
            for j in range(r):
                sel = host["sel"][j].tolist()
                if on_host:
                    soft = torch.from_numpy(host["soft"][j])
                    sizes = torch.from_numpy(host["size"][j])
                else:
                    soft, sizes = ys["soft"][j], ys["size"][j]
                a_rel, r_rel, ent = self.judge(soft, sizes)
                oracle = np.zeros(num, np.float32)
                oracle[a_rel] = 1.0
                if not np.array_equal(oracle, host["mask"][j]):
                    mismatch_at = j
                    break
                pos_ids = [sel[i] for i in a_rel]
                neg_ids = [sel[i] for i in r_rel]
                if pool_fold:
                    # the block's draw, then the verdict: the sequential
                    # select/update cycle
                    self.selector.fold_drawn(host["sel"][j], host["key"][j])
                self.selector.update(pos_ids, neg_ids)
                comm = comm_bytes(
                    self.global_params, len(sel), len(pos_ids),
                    host["soft"].shape[-1],
                    control_variate=self.strategy.doubles_uplink)
                self._ready.append({
                    "round": base + done + j, "selected": sel,
                    "positive": pos_ids, "negative": neg_ids,
                    "entropy": ent, "comm": comm, "spec_hit": True,
                    "redispatched": redispatched})

            if mismatch_at is None:
                # the block's outputs are its graph's: the next replay
                # overwrites them
                params = _cloned(params_out)
                if not replay:
                    self._key = torch.from_numpy(host["key"][r - 1].copy())
                done += r
                continue

            # --- cut: rewind to the last confirmed round, redo the
            #     mismatched round from the oracle, run the rest anew ---
            j = mismatch_at
            self._mismatch_rounds += 1
            if j > 0:
                params = _cloned(self._rewind(ys, seg, j, remat))
            if pool_fold:
                # round j's draw depended on confirmed state only: mirror
                # it, so the oracle round re-files against it
                self.selector.fold_drawn(host["sel"][j], host["key"][j])
            elif not replay:
                self._key = torch.from_numpy(host["key"][j].copy())
            params = self._oracle_round(params, host["sel"][j],
                                        base + done + j)
            done += j + 1
            redispatched = True
        self.global_params = params

    def _rewind(self, ys, seg, j: int, remat: bool):
        """The params after the block's round j - 1: ``ys["params"][j-1]``
        in ``"stack"`` mode; in ``"remat"`` the output of a depth-j block
        run from the block's start carry (the same ops on the same
        inputs, so the same bits)."""
        if not remat:
            return pytree.tree_map(lambda x: x[j - 1], ys["params"])
        args = seg[:4] + (seg[4][:j],)
        return self._block_program(j, args)(*args)[0]

    def _oracle_round(self, start_params, sel, round_no: int):
        """A mismatched round run again eagerly, as ``Server.round`` runs
        it from ``start_params``: the client program on the round's
        cohort, the oracle's verdict, the aggregation on it and the
        selector's update."""
        cfg = self.config
        sel = [int(c) for c in np.asarray(sel)]
        out = self._run_cohort(sel, self.selector, start_params)
        soft, sizes = out["soft_label"], out["size"]
        a_rel, r_rel, ent = self.judge(soft, sizes)
        mask = torch.zeros(len(sel), device=self.device)
        mask[a_rel] = 1.0
        new_params = self.aggregator(start_params, out, sizes, mask)
        self.state = self.strategy.update_state(
            self.state, start_params, out, np.asarray(sel), cfg.num_clients)
        pos = [sel[i] for i in a_rel]
        neg = [sel[i] for i in r_rel]
        self.selector.update(pos, neg)
        comm = comm_bytes(new_params, len(sel), len(pos), soft.shape[-1],
                          control_variate=self.strategy.doubles_uplink)
        self._ready.append({
            "round": round_no, "selected": sel, "positive": pos,
            "negative": neg, "entropy": ent, "comm": comm,
            "spec_hit": False, "redispatched": False})
        return new_params
