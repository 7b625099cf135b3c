"""Streaming host-resident data plane: the corpus stays on the host.

:class:`repro_torch.data.corpus.ClientCorpus` stacks all N clients on the
card, which is right at the paper's N = 100 and impossible at the
cross-device scale the paper frames. This module inverts the residency
contract, as ``repro.data.stream`` does:

* :class:`HostCorpus` keeps the stacked ``x/y/w`` arrays on the host
  (numpy, or ``np.load(mmap_mode="r")`` memory maps: :meth:`HostCorpus.save`
  and :meth:`HostCorpus.open`, and the packed ``.npy`` cache of
  :mod:`repro_torch.data.ingest`). Only the round's cohort reaches the
  device: ``cohort(idx)`` is a host gather in the storage dtype, an
  upload, then the same :func:`~repro_torch.data.corpus.finish_cohort`
  (``Normalize`` and queue mask) the resident plane runs after its
  gather, so cohorts are equal bit for bit across planes. Device bytes
  are O(|S_t|), never O(N).
* The control-plane stats (``sizes``, ``label_histograms``,
  ``label_entropy``) come from one pass over client chunks at open time,
  with the dense plane's per-row math, so they equal
  :class:`ClientCorpus`'s bit for bit at any chunk size.
* :class:`CohortPrefetcher` stages a predicted cohort on a background
  thread: the pipelined engine's speculated selection for round t+1 is
  gathered into a ring of reusable staging buffers (pinned host memory on
  the card) and copied to the device on a side stream while the round
  thread runs the float64 oracle. A misprediction discards it and the
  round gathers synchronously.
* ``HostCorpus.shard(mesh)`` records a client mesh; a fan-out's cohort
  blocks (``cohort_blocks``) are then each uploaded to its own device.

Both planes key ``signature()`` on the plane, so a program captured for
one is never replayed for the other, and both answer ``memory_report()``
with the same keys. :func:`as_data_plane` is the one wiring point the
servers build through: ``"resident"`` and ``"streaming"`` force a plane;
``"auto"`` keeps a stacked dict resident while its storage bytes fit
:data:`RESIDENT_BUDGET_BYTES` and streams it past that.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections.abc import Mapping

import numpy as np
import torch

from ..device import CAPTURE_LOCK, canonical_device, resolve_device
from .corpus import (CLIENT_AXIS, ClientCorpus, Normalize, cohort_nbytes,
                     finish_cohort, group_by_device, memory_report,
                     mesh_devices, storage_nbytes)

PLANES = ("resident", "streaming", "auto")

# "auto" keeps the corpus on the device while its storage-dtype bytes fit
# this budget, and streams past it (the reference's value)
RESIDENT_BUDGET_BYTES = 1 << 30

# clients per chunk of the open-time stats pass: bounds its host working
# set at chunk * S * itemsize bytes whatever N is
STATS_CHUNK_CLIENTS = 4096


def _host_array(v) -> np.ndarray:
    """A host numpy array of ``v``, dtype kept; ndarrays and memory maps
    pass through without a copy."""
    if isinstance(v, np.ndarray):
        return v
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    return np.asarray(v)


def _check_ids(idx: np.ndarray, n: int) -> None:
    """numpy's indexing rule (``-n <= i < n``), checked up front so the
    staging gather can run unbuffered."""
    if idx.size and (int(idx.max()) >= n or int(idx.min()) < -n):
        raise IndexError(f"client ids {idx.tolist()} out of bounds for "
                         f"{n} clients")


class HostCorpus(Mapping):
    """Host-resident stacked client corpus; see the module docstring.

    The surface of :class:`ClientCorpus` (a ``Mapping`` over the raw host
    arrays, ``cohort(idx, active=None)``, ``signature()``, the cached
    stats, ``with_rows``), so servers, selectors and strategies take
    either plane. ``device`` is where cohorts go.
    """

    plane = "streaming"

    def __init__(self, arrays: dict, *, transform: Normalize | None = None,
                 stats_chunk: int = STATS_CHUNK_CLIENTS,
                 prefetch_depth: int = 1, device="cuda"):
        if not arrays:
            raise ValueError("HostCorpus needs at least one array")
        n = {k: np.shape(v)[0] for k, v in arrays.items()}
        if len(set(n.values())) != 1:
            raise ValueError(f"client axes disagree: {n}")
        self.prefetch_depth = int(prefetch_depth)
        if self.prefetch_depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.device = resolve_device(device)
        self._arrays = {k: _host_array(v) for k, v in arrays.items()}
        self.transform = transform
        self._n = int(next(iter(self._arrays.values())).shape[0])
        self._stats_chunk = max(1, int(stats_chunk))
        self._prefetcher: CohortPrefetcher | None = None
        self._uploaded_nbytes = 0        # the latest cohort's device bytes
        self._mesh = None
        # bytes copied from the staged cohort's device into other blocks
        self.block_copy_nbytes = 0
        self._hists: dict = {}
        self._sizes, self._hists[None], self._entropy = self._stream_stats()

    # ------------------------------------------------------- constructors
    @classmethod
    def from_stacked(cls, data, *, transform: Normalize | None = None,
                     device="cuda") -> "HostCorpus":
        """Wrap a stacked dict or a resident corpus; identity on a
        ``HostCorpus`` whose cohorts go to ``device``."""
        if isinstance(data, HostCorpus):
            if canonical_device(data.device) != canonical_device(device):
                raise ValueError(f"corpus uploads to {data.device}, "
                                 f"not {device}")
            return data
        if isinstance(data, ClientCorpus):
            return cls(data.as_numpy(), transform=data.transform
                       if transform is None else transform, device=device)
        return cls(dict(data), transform=transform, device=device)

    @classmethod
    def from_parts(cls, x, y, parts, *, batch_multiple: int = 1,
                   transform: Normalize | None = None,
                   device="cuda") -> "HostCorpus":
        from .partition import stack_clients
        return cls(stack_clients(x, y, parts, batch_multiple),
                   transform=transform, device=device)

    # ------------------------------------------------------ mmap open/save
    def save(self, directory: str) -> str:
        """Write each array as ``<directory>/<key>.npy`` and a meta.json
        (the transform included), the layout :meth:`open` memory-maps.
        Returns ``directory``."""
        os.makedirs(directory, exist_ok=True)
        for k, v in self._arrays.items():
            np.save(os.path.join(directory, f"{k}.npy"), v)
        meta = {"keys": sorted(self._arrays)}
        if self.transform is not None:
            t = self.transform
            meta["transform"] = {"scale": t.scale, "mean": list(t.mean),
                                 "std": list(t.std)}
        with open(os.path.join(directory, "meta.json"), "w") as f:
            json.dump(meta, f)
        return directory

    @classmethod
    def open(cls, directory: str, *, transform: Normalize | None = None,
             device="cuda") -> "HostCorpus":
        """Memory-map a :meth:`save` layout (``np.load(mmap_mode="r")``):
        pages are read only as cohorts gather them. ``transform=None``
        restores the saved one, if any."""
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        arrays = {k: np.load(os.path.join(directory, f"{k}.npy"),
                             mmap_mode="r") for k in meta["keys"]}
        if transform is None and "transform" in meta:
            t = meta["transform"]
            transform = Normalize(scale=t["scale"], mean=tuple(t["mean"]),
                                  std=tuple(t["std"]))
        return cls(arrays, transform=transform, device=device)

    # ---------------------------------------------------- Mapping protocol
    def __getitem__(self, key):
        return self._arrays[key]

    def __iter__(self):
        return iter(self._arrays)

    def __len__(self):
        return len(self._arrays)

    # ----------------------------------------------------------- metadata
    @property
    def num_clients(self) -> int:
        return self._n

    @property
    def samples_per_client(self) -> int:
        return int(self._arrays["y"].shape[1]) if "y" in self._arrays \
            else int(next(iter(self._arrays.values())).shape[1])

    def signature(self) -> tuple:
        """Hashable key holding the *plane* with the shapes, dtypes and
        transform: a program captured for the streaming plane is never
        replayed for a resident corpus, or the other way round."""
        return ("stream",
                tuple((k, tuple(v.shape), str(v.dtype))
                      for k, v in sorted(self._arrays.items())),
                self.transform)

    @property
    def nbytes(self) -> int:
        """Host-resident (or host-mapped) bytes of the stored corpus."""
        return storage_nbytes(self._arrays)

    def device_nbytes(self) -> int:
        """Device bytes the plane holds: the latest cohort and any staged
        prefetch, O(|S_t|), never O(N)."""
        inflight = (self._prefetcher.inflight_nbytes
                    if self._prefetcher is not None else 0)
        return int(self._uploaded_nbytes + inflight)

    def cohort_nbytes(self, m: int) -> int:
        """Bytes a float32 host-slice plane would ship per round for an
        ``m``-client cohort (the resident plane's accounting)."""
        return cohort_nbytes(self._arrays, self.transform, m)

    def as_numpy(self) -> dict:
        return {k: np.asarray(v) for k, v in self._arrays.items()}

    def memory_report(self) -> dict:
        """Host-mapped bytes, device-resident bytes and staging-buffer
        bytes (the reference's keys)."""
        pf = self._prefetcher
        return memory_report(
            self, host_mapped_bytes=self.nbytes,
            host_is_mmap=any(isinstance(v, np.memmap)
                             for v in self._arrays.values()),
            staging_nbytes=0 if pf is None else pf.staging_nbytes)

    def shard(self, mesh, axis: str = CLIENT_AXIS) -> "HostCorpus":
        """Record the client mesh cohort blocks are uploaded over
        (:meth:`cohort_blocks`: each block to its own device). The corpus
        itself never moves — streaming *is* the placement. The mesh's
        first device must be the corpus's, and of its kind; anything else
        raises. Returns self (idempotent)."""
        if axis != getattr(mesh, "axis_name", CLIENT_AXIS):
            raise ValueError(f"mesh axis {mesh.axis_name!r}, not {axis!r}")
        mesh_devices(mesh, self.device)
        self._mesh = mesh
        return self

    @property
    def mesh(self):
        """The recorded client mesh (None: one device)."""
        return self._mesh

    def laid_out(self, mesh) -> "HostCorpus":
        """This corpus if it records ``mesh``, else a copy that does (the
        host arrays shared, a prefetcher of its own), this one untouched;
        see :meth:`~repro_torch.data.corpus.ClientCorpus.laid_out`."""
        if self._mesh is not None and self._mesh == mesh:
            return self
        new = object.__new__(HostCorpus)
        new.__dict__.update(self.__dict__)
        new._prefetcher, new._uploaded_nbytes = None, 0
        new._hists, new.block_copy_nbytes = dict(self._hists), 0
        return new.shard(mesh)

    def with_rows(self, clients, rows: dict) -> "HostCorpus":
        """A new corpus in which clients ``clients`` hold ``rows`` (a
        ``{x, y, w}`` subset of the same sample length) in place of their
        own; keys the corpus lacks are ignored. Only the arrays an event
        rewrites are copied (a memory map is read-only); the others are
        shared."""
        ids = np.asarray(clients, np.int64)
        arrays = dict(self._arrays)
        for k, v in self._arrays.items():
            if k in rows:
                new = np.array(v)
                new[ids] = np.asarray(rows[k], v.dtype)
                arrays[k] = new
        new = HostCorpus(arrays, transform=self.transform,
                         stats_chunk=self._stats_chunk,
                         prefetch_depth=self.prefetch_depth,
                         device=self.device)
        new._mesh = self._mesh
        return new

    # ------------------------------------------------- control-plane stats
    def _stream_stats(self):
        """One pass over client chunks: per-client sizes, label histograms
        (the global class width) and label entropy, each chunk by the
        dense plane's per-row math (``core.pools.label_histograms``,
        ``hist_entropy``, row-local float32 weight sums), so the results
        equal the dense plane's bit for bit at any N and chunk size."""
        from ..core.pools import hist_entropy, label_histograms
        y = self._arrays.get("y")
        w = self._arrays.get("w")
        sizes = np.empty(self._n, np.int64)
        chunks: list[np.ndarray] = []
        width = 0
        for lo in range(0, self._n, self._stats_chunk):
            hi = min(lo + self._stats_chunk, self._n)
            wc = None if w is None else np.asarray(w[lo:hi])
            if wc is None:
                sizes[lo:hi] = self.samples_per_client
            else:
                # row-local float32 sums: the resident plane's sum over w
                sizes[lo:hi] = np.sum(
                    wc.astype(np.float32), axis=1).astype(np.int64)
            if y is not None:
                h = label_histograms(np.asarray(y[lo:hi]), wc)
                width = max(width, h.shape[1])
                chunks.append(h)
        if y is None:
            return sizes, None, np.zeros(self._n, np.float64)
        hists = np.zeros((self._n, width), np.float64)
        lo = 0
        for h in chunks:
            hists[lo:lo + h.shape[0], :h.shape[1]] = h
            lo += h.shape[0]
        ent = np.asarray([hist_entropy(h) for h in hists], np.float64)
        return sizes, hists, ent

    def sizes(self) -> np.ndarray:
        return self._sizes

    def label_histograms(self, num_classes: int | None = None) -> np.ndarray:
        """(N, C) weighted label counts; the default width comes from the
        open-time pass, an explicit width streams a fresh pass (cached
        per ``num_classes``, as the resident plane)."""
        if num_classes not in self._hists:
            from ..core.pools import label_histograms
            y, w = self._arrays["y"], self._arrays.get("w")
            rows = []
            for lo in range(0, self._n, self._stats_chunk):
                hi = min(lo + self._stats_chunk, self._n)
                rows.append(label_histograms(
                    np.asarray(y[lo:hi]),
                    None if w is None else np.asarray(w[lo:hi]),
                    num_classes=num_classes))
            self._hists[num_classes] = np.concatenate(rows, axis=0)
        return self._hists[num_classes]

    def label_entropy(self) -> np.ndarray:
        return self._entropy

    # ------------------------------------------------------------ data plane
    def prefetcher(self) -> "CohortPrefetcher":
        """The background prefetcher, made on first use; ``prefetch_depth``
        predictions may stage ahead (1: one slot, double-buffered)."""
        if self._prefetcher is None:
            self._prefetcher = CohortPrefetcher(self, self.prefetch_depth)
        return self._prefetcher

    def prefetch(self, idx, active=None) -> None:
        """Start staging cohort ``idx`` (host gather and upload) on the
        background thread. A later :meth:`cohort` with the same (idx,
        active) takes the staged upload; :meth:`cancel_prefetch` discards
        it (a selector misprediction)."""
        self.prefetcher().start(np.asarray(idx, np.int64),
                                None if active is None
                                else np.asarray(active, np.int64))

    def cancel_prefetch(self) -> None:
        if self._prefetcher is not None:
            self._prefetcher.cancel()

    def prefetch_stats(self) -> dict:
        return (CohortPrefetcher.empty_stats() if self._prefetcher is None
                else self._prefetcher.stats())

    def _gather_host(self, idx: np.ndarray) -> dict:
        """Host gather of the cohort rows in the storage dtype (a memory
        map reads only the selected pages)."""
        return {k: np.asarray(v[idx]) for k, v in self._arrays.items()}

    def _upload(self, host: dict) -> dict:
        """Fresh host arrays -> tensors on the device (on the CPU the
        tensors share the arrays' memory)."""
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in host.items()}

    def cohort(self, idx, active=None) -> dict:
        """Gather clients ``idx``: the staged upload if a matching prefetch
        is queued, else a synchronous host gather and upload; then
        :func:`finish_cohort`, as the resident plane, so cohorts are equal
        bit for bit across planes."""
        idx = np.asarray(idx, np.int64)
        act = None if active is None else np.asarray(active, np.int64)
        staged = None
        if self._prefetcher is not None:
            staged = self._prefetcher.take(idx, act)
        if staged is None:
            staged = self._upload(self._gather_host(idx))
        self._uploaded_nbytes = storage_nbytes(staged)
        return finish_cohort(
            dict(staged), self.transform,
            None if act is None else torch.as_tensor(act,
                                                     device=self.device))


    def cohort_blocks(self, idx, active, layout, devices) -> list:
        """The cohort in blocks for a client fan-out (the resident plane's
        :meth:`~repro_torch.data.corpus.ClientCorpus.cohort_blocks`): block
        b holds the cohort rows at positions ``layout[b]``, gathered on the
        host and uploaded to ``devices[b]``, then finished there. A
        matching prefetch (of ``idx`` and ``active``) was staged on the
        corpus's device: its blocks are copied from there instead (those
        bound elsewhere counted in :attr:`block_copy_nbytes`)."""
        idx = np.asarray(idx, np.int64)
        layout = np.asarray(layout, np.int64)
        act = None if active is None else np.asarray(active, np.int64)
        devices = tuple(canonical_device(d) for d in devices)
        staged = None
        if self._prefetcher is not None:
            staged = self._prefetcher.take(idx, act)
        segs = [] if act is None else [act[row] for row in layout]
        where = [] if act is None else list(devices)
        home = canonical_device(self.device)
        if staged is not None:
            segs += list(layout)
            where += [home] * len(layout)
        ts = group_by_device(where, segs)
        out, per_dev = [], {}
        for b, (row, dst) in enumerate(zip(layout, devices)):
            if staged is None:
                host = self._gather_host(idx[row])
                block = {k: torch.from_numpy(v).to(dst)
                         for k, v in host.items()}
            else:
                at = ts[len(segs) - len(layout) + b]
                block = {k: v.index_select(0, at).to(dst)
                         for k, v in staged.items()}
                if dst != home:
                    self.block_copy_nbytes += storage_nbytes(block)
            per_dev[dst] = per_dev.get(dst, 0) + storage_nbytes(block)
            out.append(finish_cohort(block, self.transform,
                                     None if act is None else ts[b]))
        self._uploaded_nbytes = max(per_dev.values())
        return out


def _key(idx: np.ndarray, active: np.ndarray | None) -> tuple:
    return (idx.tobytes(), None if active is None else active.tobytes())


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class CohortPrefetcher:
    """Ring-buffered background staging of predicted cohort uploads.

    ``start(idx, active)`` hands a predicted selection to a daemon thread,
    which gathers its rows into one of ``depth + 1`` reusable staging
    buffers and copies them to the device. Up to ``depth`` predictions
    are queued, consumed in FIFO order; a ``depth + 1``-th evicts the
    oldest (counted cancelled). ``take(idx, active)`` walks the queue from
    the front: entries ahead of a match are stale and discarded as
    misses; a match is consumed (a hit); an empty queue returns ``None``
    (the caller gathers synchronously). ``cancel()`` discards the queue.
    A worker's exception is raised again by the ``take`` that meets it.
    The counters (hits, misses, cancels; staging and blocked seconds) are
    the reference's.

    On the card the staging buffers are pinned host memory; the copy is
    ``non_blocking`` on a side stream, followed by an event. ``take``
    makes the consumer's stream wait on that event and ``record_stream``s
    the uploaded tensors for it, so the allocator keeps their memory until
    the consumer's work is done. A buffer is written again only after its
    last copy's event has completed, and one writer at a time holds it,
    so a pending copy never reads a half-rewritten buffer. The worker's
    CUDA calls hold :data:`repro_torch.device.CAPTURE_LOCK`, so none falls
    inside a graph capture on the round thread. On the CPU the same code
    stages into plain host tensors, and the "upload" is a copy.
    """

    def __init__(self, corpus: HostCorpus, depth: int = 1):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self._corpus = corpus
        self.depth = int(depth)
        self._lock = threading.Lock()
        self._pending: list[tuple] = []   # FIFO of (key, event, holder)
        slots = self.depth + 1
        self._buffers: list[dict | None] = [None] * slots
        self._slot_locks = [threading.Lock() for _ in range(slots)]
        self._copied: list = [None] * slots   # each slot's last copy event
        self._ring = 0
        self._card = corpus.device.type == "cuda"
        self._stream = (torch.cuda.Stream(device=corpus.device)
                        if self._card else None)
        self.hits = 0
        self.misses = 0
        self.cancelled = 0
        self.stage_s = 0.0        # background gather and upload seconds
        self.wait_s = 0.0         # round-thread seconds blocked in take()

    @staticmethod
    def empty_stats() -> dict:
        return {"hits": 0, "misses": 0, "cancelled": 0, "hit_rate": 0.0,
                "stage_s": 0.0, "wait_s": 0.0, "overlap_s": 0.0}

    @property
    def staging_nbytes(self) -> int:
        return sum(storage_nbytes(b) for b in self._buffers if b is not None)

    @property
    def inflight_nbytes(self) -> int:
        with self._lock:
            staged = [p[2].get("staged") for p in self._pending]
        return sum(storage_nbytes(s["tensors"]) for s in staged
                   if s is not None)

    # ------------------------------------------------------------ staging
    def _staging_buffer(self, slot: int, m: int) -> dict:
        """Slot ``slot``'s buffer at an ``m``-client cohort's shapes,
        (re)allocated if they changed, else reused once its last copy has
        completed. Called with the slot's lock held."""
        arrays = self._corpus._arrays
        buf = self._buffers[slot]
        if buf is None or any(
                tuple(buf[k].shape) != (m,) + v.shape[1:]
                or buf[k].dtype != _torch_dtype(v.dtype)
                for k, v in arrays.items()):
            # a replaced pinned buffer stays alive until its copy ends
            # (the host allocator records the copy's stream)
            with CAPTURE_LOCK:
                buf = {k: torch.empty((m,) + v.shape[1:],
                                      dtype=_torch_dtype(v.dtype),
                                      pin_memory=self._card)
                       for k, v in arrays.items()}
            self._buffers[slot] = buf
        elif self._copied[slot] is not None:
            with CAPTURE_LOCK:
                self._copied[slot].synchronize()
        return buf

    def _ship(self, slot: int, buf: dict) -> dict:
        """The staged buffer on the device: on the card a ``non_blocking``
        copy on the side stream and its event, on the CPU a copy."""
        if not self._card:
            return {"tensors": {k: t.clone() for k, t in buf.items()},
                    "event": None}
        with CAPTURE_LOCK, torch.cuda.stream(self._stream):
            up = {k: t.to(self._corpus.device, non_blocking=True)
                  for k, t in buf.items()}
            done = torch.cuda.Event()
            done.record(self._stream)
        self._copied[slot] = done
        return {"tensors": up, "event": done}

    def _stage(self, idx: np.ndarray, slot: int, holder: dict,
               done: threading.Event) -> None:
        try:
            t0 = time.perf_counter()
            _check_ids(idx, self._corpus.num_clients)
            with self._slot_locks[slot]:
                buf = self._staging_buffer(slot, len(idx))
                for k, v in self._corpus._arrays.items():
                    # ids checked above: "wrap" takes numpy's negative
                    # ids and skips the buffered copy "raise" makes
                    np.take(v, idx, axis=0, out=buf[k].numpy(),
                            mode="wrap")
                holder["staged"] = self._ship(slot, buf)
            holder["stage_s"] = time.perf_counter() - t0
        except Exception as e:  # raised again on the consuming thread
            holder["error"] = e
        finally:
            done.set()

    def start(self, idx: np.ndarray, active: np.ndarray | None) -> None:
        with self._lock:
            while len(self._pending) >= self.depth:
                # queue full: the OLDEST prediction is dead either way
                self._pending.pop(0)
                self.cancelled += 1
            done = threading.Event()
            holder: dict = {}
            self._pending.append((_key(idx, active), done, holder))
            self._ring = (self._ring + 1) % len(self._buffers)
            slot = self._ring
        threading.Thread(target=self._stage,
                         args=(idx, slot, holder, done),
                         daemon=True).start()

    # ----------------------------------------------------------- consuming
    def take(self, idx: np.ndarray, active: np.ndarray | None):
        want = _key(idx, active)
        with self._lock:
            pending = None
            while self._pending:
                head = self._pending.pop(0)
                if head[0] == want:
                    pending = head
                    break
                self.misses += 1     # stale prediction ahead of the match
            if pending is None:
                return None
        _, done, holder = pending
        t0 = time.perf_counter()
        done.wait()
        self.wait_s += time.perf_counter() - t0
        if "error" in holder:
            raise holder["error"]
        self.hits += 1
        self.stage_s += holder["stage_s"]
        staged = holder["staged"]
        if staged["event"] is not None:
            stream = torch.cuda.current_stream(self._corpus.device)
            stream.wait_event(staged["event"])
            for t in staged["tensors"].values():
                t.record_stream(stream)
        return staged["tensors"]

    def cancel(self) -> None:
        with self._lock:
            self.cancelled += len(self._pending)
            self._pending.clear()

    def stats(self) -> dict:
        total = self.hits + self.misses + self.cancelled
        return {"hits": self.hits, "misses": self.misses,
                "cancelled": self.cancelled,
                "hit_rate": self.hits / max(total, 1),
                "stage_s": self.stage_s, "wait_s": self.wait_s,
                # staging time the round thread did not spend blocked:
                # what the overlap hid
                "overlap_s": max(self.stage_s - self.wait_s, 0.0)}


# ---------------------------------------------------------- plane wiring

def plane_of(corpus) -> str:
    """``"resident"`` or ``"streaming"`` for a corpus of either plane."""
    return getattr(corpus, "plane", "resident")


def estimate_nbytes(data) -> int:
    """Storage-dtype bytes of a stacked dict or a corpus of either plane
    (what ``"auto"`` decides on)."""
    if isinstance(data, (ClientCorpus, HostCorpus)):
        return data.nbytes
    return storage_nbytes({k: v if isinstance(v, torch.Tensor)
                           else np.asarray(v) for k, v in dict(data).items()})


def as_data_plane(client_data, plane: str = "auto", *,
                  transform: Normalize | None = None,
                  resident_budget: int = RESIDENT_BUDGET_BYTES,
                  device="cuda"):
    """Resolve ``client_data`` onto a data plane: the one wiring point
    ``fl.build`` and ``Server`` share, with the reference's rules.

    ``"resident"`` gives a :class:`ClientCorpus` (on the device, the fast
    path while N fits), ``"streaming"`` a :class:`HostCorpus`, and
    ``"auto"`` passes a built corpus through on its own plane and keeps a
    stacked dict resident while its storage bytes fit
    ``resident_budget``, streaming it past that. An explicit plane
    *converts* a corpus of the other plane (through the host). A corpus
    bound to another device than ``device`` raises.
    """
    if plane not in PLANES:
        raise ValueError(
            f"unknown data plane {plane!r}; expected one of {PLANES}")
    if plane == "auto":
        if isinstance(client_data, (ClientCorpus, HostCorpus)):
            return type(client_data).from_stacked(client_data,
                                                  device=device)
        plane = ("resident"
                 if estimate_nbytes(client_data) <= resident_budget
                 else "streaming")
    if plane == "resident":
        if isinstance(client_data, HostCorpus):
            return ClientCorpus(client_data.as_numpy(),
                                transform=client_data.transform
                                if transform is None else transform,
                                device=device)
        return ClientCorpus.from_stacked(client_data, transform=transform,
                                         device=device)
    return HostCorpus.from_stacked(client_data, transform=transform,
                                   device=device)
