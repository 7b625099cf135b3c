"""Device-resident client corpus: the FL data plane.

``ClientCorpus`` holds the stacked per-client arrays (``x:(N,S,...)``,
``y:(N,S)``, ``w:(N,S)``) on the device, once, in their storage dtype, and
answers the questions every layer above would otherwise re-derive per
round:

* **data plane** — :meth:`cohort` gathers the round's clients along the
  client axis on the device (optionally applying a :class:`Normalize`
  and a :class:`DataQueue` activity mask); per round only the ``idx``
  vector and the queue's counts cross from host to device.
* **control plane** — :meth:`sizes`, :meth:`label_histograms` and
  :meth:`label_entropy` are the per-client stats the selectors rank and
  weigh by, computed once on the host and cached.
* **placement** — :meth:`ClientCorpus.shard` lays the client axis out
  over a client mesh once, in equal blocks, zero rows padding an uneven
  N (:func:`pad_client_axis`); :meth:`ClientCorpus.cohort_blocks` then
  fills each block of a client fan-out on its shard's device.

It is the *resident* plane. The streaming plane,
:class:`repro_torch.data.stream.HostCorpus`, keeps the arrays on the host
and uploads one cohort a round; both planes finish a gathered cohort with
:func:`finish_cohort`, so their cohorts are equal bit for bit, and both
account their bytes with :func:`cohort_nbytes` and :func:`memory_report`.

``DataQueue`` is the round-indexed subset schedule behind the
dynamic-data-queue selector (arXiv 2410.17792): each client's effective
local dataset starts small and grows to the full shard; the corpus
applies it as a weight mask inside the cohort gather. Images stay NHWC,
as in the JAX package.
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch

from ..device import canonical_device, resolve_device

CLIENT_AXIS = "clients"


@dataclass(frozen=True)
class Normalize:
    """On-device dtype policy: ``(x * scale - mean) / std`` in float32.

    The identity transform is ``Normalize()``; uint8 ingest pairs
    ``scale=1/255`` with per-channel dataset statistics. Applied inside
    the cohort gather — the corpus stays in its storage dtype.
    """
    scale: float = 1.0
    mean: tuple = (0.0,)
    std: tuple = (1.0,)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32) * self.scale
        return (x - self._const(self.mean, x)) / self._const(self.std, x)

    @staticmethod
    def _const(values: tuple, x: torch.Tensor) -> torch.Tensor:
        # filled on the device rather than copied from the host, so the
        # gather can run inside a CUDA graph capture (the scan engine's)
        return torch.stack([torch.full((), float(v), dtype=torch.float32,
                                       device=x.device) for v in values])


@dataclass(frozen=True)
class DataQueue:
    """Round-indexed per-client effective-dataset schedule.

    ``active(round, sizes)`` maps each client's real sample count to the
    number of samples released to it at that round: a fraction ramping
    from ``start_frac`` to 1.0 over ``rounds_to_full`` rounds, either
    continuously (``growth="linear"``) or in ``stages`` discrete steps
    (``growth="staged"``). Deterministic in (round, sizes), so a
    speculative selector copy reproduces the exact schedule. An exact
    transcription of ``repro.data.corpus.DataQueue``.
    """
    start_frac: float = 0.25
    rounds_to_full: int = 100
    growth: str = "linear"          # "linear" | "staged"
    stages: int = 4
    min_samples: int = 1

    def __post_init__(self):
        if self.growth not in ("linear", "staged"):
            raise ValueError(
                f"DataQueue growth must be 'linear' or 'staged', "
                f"got {self.growth!r}")

    def frac(self, round_idx: int) -> float:
        t = min(max(round_idx, 0) / max(self.rounds_to_full, 1), 1.0)
        if self.growth == "staged":
            # graduate in `stages` equal steps; final stage is the full set
            step = np.ceil(t * self.stages) / self.stages
            t = float(step)
        return float(self.start_frac + (1.0 - self.start_frac) * t)

    def active(self, round_idx: int, sizes: np.ndarray) -> np.ndarray:
        sizes = np.asarray(sizes, np.int64)
        want = np.ceil(self.frac(round_idx) * sizes).astype(np.int64)
        return np.clip(np.maximum(want, self.min_samples), 0, sizes)


def finish_cohort(out: dict, transform: Normalize | None,
                  active: torch.Tensor | None = None) -> dict:
    """A gathered cohort's dtype transform and queue mask: the one op
    sequence both data planes run after their gathers, so a cohort is the
    same bits on either. ``out`` maps keys to tensors on one device (the
    storage dtype) and is updated in place; ``active`` (per-row released
    sample counts, on the same device) masks each row's ``w`` down to its
    first ``active[i]`` samples."""
    if transform is not None and "x" in out:
        out["x"] = transform(out["x"])
    if active is not None and "w" in out:
        s = out["w"].shape[1]
        live = torch.arange(s, device=out["w"].device)[None, :] \
            < active[:, None]
        out["w"] = out["w"] * live.to(out["w"].dtype)
    return out


def _itemsize(v) -> int:
    return v.element_size() if isinstance(v, torch.Tensor) \
        else v.dtype.itemsize


def storage_nbytes(arrays: dict) -> int:
    """Bytes of a dict of tensors or numpy arrays, each in its dtype."""
    return int(sum(int(np.prod(v.shape, dtype=np.int64)) * _itemsize(v)
                   for v in arrays.values()))


def cohort_nbytes(arrays: dict, transform: Normalize | None, m: int) -> int:
    """Bytes a host-slice data plane would ship per round for a cohort of
    ``m`` clients of ``arrays`` (either plane's): ``x`` in float32 after
    the transform, the other arrays in their storage dtype."""
    total = 0
    for k, v in arrays.items():
        itemsize = 4 if k == "x" and transform is not None else _itemsize(v)
        total += int(np.prod(v.shape[1:], dtype=np.int64)) * itemsize * m
    return total


def memory_report(corpus, *, host_mapped_bytes: int = 0,
                  host_is_mmap: bool = False,
                  staging_nbytes: int = 0) -> dict:
    """Plane-aware byte accounting, with the reference's keys, for a
    corpus of either plane; the defaults are the resident plane's."""
    return {
        "plane": corpus.plane,
        "host_mapped_bytes": int(host_mapped_bytes),
        "host_is_mmap": bool(host_is_mmap),
        "device_resident_bytes": corpus.device_nbytes(),
        "staging_nbytes": int(staging_nbytes),
        "num_clients": corpus.num_clients,
    }


def pad_client_axis(arrays: dict, pad: int) -> dict:
    """Append ``pad`` zero rows to every array's client axis.

    Zero rows (rather than edge repeats) make padded clients provably
    inert: their ``w`` mask is all-zero, so even a stray gather of a
    padded id contributes nothing to any weighted reduction. Real rows
    are untouched — global client ids keep their positions. Identity
    (the same tensors) at ``pad`` 0."""
    if pad <= 0:
        return dict(arrays)
    return {k: torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))])
            for k, v in arrays.items()}


def mesh_devices(mesh, device) -> tuple:
    """The devices of a client mesh (anything with ``devices``) for a
    corpus, and its server, on ``device``: canonical, the same kind as
    ``device`` and starting at it. Raises otherwise; nothing is moved to
    make it fit."""
    devs = tuple(canonical_device(d) for d in mesh.devices)
    home = canonical_device(device)
    if not devs or {d.type for d in devs} != {home.type}:
        raise ValueError(
            f"client mesh on {[str(d) for d in devs]} for {home}: a mesh "
            "of cards serves a server on a card, a mesh of CPU shards one "
            "on the CPU")
    if devs[0] != home:
        raise ValueError(f"client mesh starts at {devs[0]}, not at {home}: "
                         "outputs are gathered on the mesh's first device, "
                         "the server's")
    return devs


def group_by_device(devices, segments: list) -> list:
    """``segments[i]`` (an int64 numpy vector) on ``devices[i]``, each
    device's segments uploaded in one copy; returns the tensors in
    order."""
    slots: dict = {}
    for i, d in enumerate(devices):
        slots.setdefault(d, []).append(i)
    out = [None] * len(segments)
    for d, ids in slots.items():
        sizes = [len(segments[i]) for i in ids]
        flat = torch.as_tensor(np.concatenate([segments[i] for i in ids]),
                               device=d)
        for i, t in zip(ids, flat.split(sizes)):
            out[i] = t
    return out


class ClientCorpus(Mapping):
    """Stacked client arrays resident on ``device``; see the module
    docstring. A ``Mapping`` over its arrays.

    **Placement.** :meth:`shard` lays the client axis out over a client
    mesh (:class:`repro_torch.fl.runtime.sharding.ClientMesh`): the real N
    rows are padded with zero rows (:func:`pad_client_axis`) up to the
    next multiple of the mesh size and split into equal blocks, block j
    on the mesh's device j, so an uneven N (the paper's 100 on 3 or 8
    shards) is a first-class layout, never a replicated one. The padding
    is data-plane only — :attr:`num_clients`, :meth:`sizes`,
    :meth:`label_histograms`, :meth:`label_entropy` and :meth:`as_numpy`
    keep the real N, global client ids map through the padded layout
    unchanged (padding appends), and :meth:`signature` keys captured
    programs on the pad. The corpus's ``device`` is the mesh's first.
    """

    plane = "resident"

    def __init__(self, arrays: dict, *, transform: Normalize | None = None,
                 device="cuda"):
        if not arrays:
            raise ValueError("ClientCorpus needs at least one array")
        n = {k: np.shape(v)[0] for k, v in arrays.items()}
        if len(set(n.values())) != 1:
            raise ValueError(f"client axes disagree: {n}")
        self.device = resolve_device(device)
        self._blocks = [{k: torch.as_tensor(v, device=self.device)
                         for k, v in arrays.items()}]
        self._devices = (self.device,)
        self.transform = transform
        self._n = int(next(iter(n.values())))   # real N
        self._pad = 0                   # zero rows appended by shard()
        self._mesh = None
        self._sizes: np.ndarray | None = None
        self._hists: dict = {}          # num_classes (or None) -> (N, C)
        # bytes the cohort gathers copied from one shard block into
        # another (a row whose corpus block is not its cohort block)
        self.block_copy_nbytes = 0

    # ------------------------------------------------------- constructors
    @classmethod
    def from_stacked(cls, data, *, transform: Normalize | None = None,
                     device="cuda") -> "ClientCorpus":
        """Wrap a ``stack_clients``-style dict; identity on a corpus that
        already lives on ``device``."""
        if isinstance(data, ClientCorpus):
            if canonical_device(data.device) != canonical_device(device):
                raise ValueError(f"corpus lives on {data.device}, "
                                 f"not {device}")
            return data
        return cls(dict(data), transform=transform, device=device)

    @classmethod
    def from_parts(cls, x, y, parts, *, batch_multiple: int = 1,
                   transform: Normalize | None = None,
                   device="cuda") -> "ClientCorpus":
        """Partition assignment lists -> stacked, device-resident corpus
        (``x`` keeps its dtype)."""
        from .partition import stack_clients
        return cls(stack_clients(x, y, parts, batch_multiple),
                   transform=transform, device=device)

    # ---------------------------------------------------- Mapping protocol
    def __getitem__(self, key):
        """The (padded) array ``key``; on a sharded corpus its blocks
        concatenated on the corpus's device (a copy)."""
        if len(self._blocks) == 1:
            return self._blocks[0][key]
        return torch.cat([b[key].to(self.device) for b in self._blocks])

    def __iter__(self):
        return iter(self._blocks[0])

    def __len__(self):
        return len(self._blocks[0])

    # ----------------------------------------------------------- metadata
    @property
    def num_clients(self) -> int:
        """The *real* client count N — control-plane surfaces never see
        the padded rows :meth:`shard` may have appended."""
        return self._n

    @property
    def padded_num_clients(self) -> int:
        """Length of the resident client axis (N + shard pad)."""
        return self._n + self._pad

    @property
    def client_valid(self) -> np.ndarray:
        """(padded_N,) bool — True for real clients, False for pad rows."""
        valid = np.zeros(self.padded_num_clients, bool)
        valid[:self._n] = True
        return valid

    @property
    def mesh(self):
        """The client mesh the corpus is laid out over (None: one
        device)."""
        return self._mesh

    @property
    def samples_per_client(self) -> int:
        b = self._blocks[0]
        return int(b["y"].shape[1]) if "y" in b \
            else int(next(iter(b.values())).shape[1])

    def signature(self) -> tuple:
        """Hashable (key, shape, dtype) + transform + pad tuple: a
        padded-shard layout is never served a program captured for the
        unpadded (or differently padded) one."""
        shapes = tuple(
            (k, (self.padded_num_clients,) + tuple(v.shape[1:]), str(v.dtype))
            for k, v in sorted(self._blocks[0].items()))
        return (shapes, self.transform, self._pad)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the stored corpus (storage dtype), summed
        over every block (pad rows included)."""
        return sum(self.block_nbytes())

    def block_nbytes(self) -> list:
        """Bytes of each shard block, in mesh order (one entry unsharded)."""
        return [storage_nbytes(b) for b in self._blocks]

    def device_nbytes(self) -> int:
        """The most resident bytes of the corpus on any one device: the
        whole corpus unsharded, about ``nbytes / mesh`` on a mesh of
        distinct devices (blocks that share a device add up)."""
        per: dict = {}
        for d, nb in zip(self._devices, self.block_nbytes()):
            per[d] = per.get(d, 0) + nb
        return max(per.values())

    def cohort_nbytes(self, m: int) -> int:
        """Bytes a host-slice data plane would ship per round for a cohort
        of ``m`` clients (this plane ships only the ids)."""
        return cohort_nbytes(self._blocks[0], self.transform, m)

    def _host(self, key: str) -> np.ndarray:
        """Host copy of the real rows of ``key``."""
        return np.concatenate([b[key].cpu().numpy()
                               for b in self._blocks])[:self._n]

    def as_numpy(self) -> dict:
        """Host copy of the raw (untransformed) arrays, storage dtype,
        real N rows only (shard pad rows are a placement detail)."""
        return {k: self._host(k) for k in self._blocks[0]}

    def memory_report(self) -> dict:
        """The corpus on the device, no host mapping or staging buffers
        (:func:`memory_report`'s keys; ``device_resident_bytes`` is
        :meth:`device_nbytes`)."""
        return memory_report(self)

    # ------------------------------------------------------------ placement
    def shard(self, mesh, axis: str = CLIENT_AXIS) -> "ClientCorpus":
        """Lay the client axis over ``mesh`` once (idempotent; returns
        self).

        ``N % len(mesh) != 0`` is a first-class layout, not a fallback:
        the real rows are padded with zero rows up to the next multiple
        and split into equal blocks, block j on ``mesh.devices[j]``.
        Re-sharding onto a mesh of another size re-derives the pad from
        the real rows. The mesh's first device must be the corpus's, and
        of its kind (a card or the CPU); anything else raises.
        """
        if axis != getattr(mesh, "axis_name", CLIENT_AXIS):
            raise ValueError(f"mesh axis {mesh.axis_name!r}, not {axis!r}")
        if self._mesh is not None and self._mesh == mesh:
            return self
        devs = mesh_devices(mesh, self.device)
        real = {k: self._real(k) for k in self._blocks[0]}
        size = len(devs)
        pad = (-self._n) % size
        padded = pad_client_axis(real, pad)
        per = (self._n + pad) // size
        self._blocks = [{k: v[j * per:(j + 1) * per].to(d, copy=True)
                         for k, v in padded.items()}
                        for j, d in enumerate(devs)]
        self._devices = devs
        self._pad = pad
        self._mesh = mesh
        return self

    def laid_out(self, mesh) -> "ClientCorpus":
        """This corpus if it is laid out over ``mesh``, else a copy laid
        out over it (:meth:`shard`), this one untouched: a server that
        fans out owns its layout, so servers sharing a corpus never lay it
        out again under one another."""
        if self._mesh is not None and self._mesh == mesh:
            return self
        new = object.__new__(ClientCorpus)
        new.__dict__.update(self.__dict__)
        new._hists, new.block_copy_nbytes = dict(self._hists), 0
        return new.shard(mesh)

    def _real(self, key: str) -> torch.Tensor:
        """The real rows of ``key`` on the corpus's device."""
        if len(self._blocks) == 1:
            return self._blocks[0][key][:self._n]
        return torch.cat([b[key].to(self.device)
                          for b in self._blocks])[:self._n]

    def put_index(self, v) -> torch.Tensor:
        """Host index vector -> int64 tensor on the corpus's device (the
        mesh's first); :meth:`cohort` takes it as it takes a host one."""
        return torch.as_tensor(np.asarray(v, np.int64), device=self.device)

    # ------------------------------------------------- control-plane stats
    def sizes(self) -> np.ndarray:
        """Per-client real (unpadded) sample counts, from the w mask."""
        if self._sizes is None:
            if "w" in self._blocks[0]:
                self._sizes = torch.as_tensor(self._host("w")).sum(
                    dim=1).numpy().astype(np.int64)
            else:
                self._sizes = np.full(self.num_clients,
                                      self.samples_per_client, np.int64)
        return self._sizes

    def label_histograms(self, num_classes: int | None = None) -> np.ndarray:
        """(N, C) weighted label counts, the ``queue`` selector's ranking
        input: numpy over a host copy of ``y`` and ``w`` (real rows),
        computed once per ``num_classes`` and cached."""
        if num_classes not in self._hists:
            from ..core.pools import label_histograms
            w = self._host("w") if "w" in self._blocks[0] else None
            self._hists[num_classes] = label_histograms(
                self._host("y"), w, num_classes=num_classes)
        return self._hists[num_classes]

    def label_entropy(self) -> np.ndarray:
        """Per-client Shannon entropy (nats) of the label distribution."""
        from ..core.pools import hist_entropy
        hists = self.label_histograms()
        return np.asarray([hist_entropy(h) for h in hists], np.float64)

    # ------------------------------------------------------------ data plane
    def cohort(self, idx, active=None) -> dict:
        """On-device gather of clients ``idx`` along axis 0 (then the
        transform, if any).

        ``active`` (optional, per-selected-client sample counts from a
        :class:`DataQueue`) masks each cohort row's ``w`` down to its
        first ``active[i]`` samples, in the same gather. Only ``idx`` and
        ``active`` move host -> device, in one copy. ``idx`` holds global
        client ids in ``[0, N)``; on a sharded corpus each row is gathered
        on its block's device and the cohort is assembled on the corpus's
        device (:meth:`cohort_blocks` with one block).
        """
        idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor)
                         else idx, np.int64)
        if len(self._blocks) > 1:
            return self.cohort_blocks(idx, active, np.arange(len(idx))[None],
                                      (self.device,))[0]
        if active is None:
            return self.traced_cohort(torch.as_tensor(idx,
                                                      device=self.device))
        both = torch.as_tensor(np.stack([idx, np.asarray(active, np.int64)]),
                               device=self.device)
        return self.traced_cohort(both[0], both[1])

    def cohort_blocks(self, idx, active, layout, devices) -> list:
        """The cohort laid out in blocks for a client fan-out: block b
        holds the cohort rows at positions ``layout[b]`` (an int array,
        one row of positions in ``idx`` per block) and is filled on
        ``devices[b]``, each row gathered on its corpus block's device and
        copied over when the two differ (counted in
        :attr:`block_copy_nbytes`). Each block is finished
        (:func:`finish_cohort`) on its device; rows equal the host slice
        bit for bit. The ids and counts cross host -> device in one copy a
        device."""
        idx = np.asarray(idx, np.int64)
        layout = np.asarray(layout, np.int64)
        ids = idx[layout]
        if ids.size and (ids.min() < 0 or ids.max() >= self._n):
            raise IndexError(f"client ids {idx.tolist()} out of bounds for "
                             f"{self._n} clients")
        act = None if active is None \
            else np.asarray(active, np.int64)[layout]
        per = self.padded_num_clients // len(self._blocks)
        owner, local = ids // per, ids % per
        devices = tuple(canonical_device(d) for d in devices)
        # host plan: for block b, the corpus blocks its rows come from (in
        # ascending order), the local rows each gives, and the order that
        # puts the gathered rows back in the block's order
        plan, segs, where = [], [], []
        for b in range(len(layout)):
            order = np.argsort(owner[b], kind="stable")
            srcs = []
            for j in np.unique(owner[b]):
                rows = local[b][order][owner[b][order] == j]
                srcs.append((int(j), len(segs)))
                segs.append(rows)
                where.append(self._devices[int(j)])
            back = None
            if not np.array_equal(order, np.arange(len(order))):
                back = len(segs)
                segs.append(np.argsort(order, kind="stable"))
                where.append(devices[b])
            a = None
            if act is not None:
                a = len(segs)
                segs.append(act[b])
                where.append(devices[b])
            plan.append((srcs, back, a))
        ts = group_by_device(where, segs)
        row_bytes = {k: storage_nbytes({k: v}) // max(v.shape[0], 1)
                     for k, v in self._blocks[0].items()}
        out = []
        for b, (srcs, back, a) in enumerate(plan):
            dst = devices[b]
            block = {}
            for k in self._blocks[0]:
                pieces = [self._blocks[j][k].index_select(0, ts[s]).to(dst)
                          for j, s in srcs]
                v = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
                block[k] = v if back is None else v.index_select(0, ts[back])
            self.block_copy_nbytes += sum(
                len(segs[s]) * sum(row_bytes.values())
                for j, s in srcs if j != b)
            out.append(finish_cohort(block, self.transform,
                                     None if a is None else ts[a]))
        return out

    def traced_cohort(self, idx: torch.Tensor, active=None) -> dict:
        """:meth:`cohort`'s gather on ``idx`` (and ``active``) already on
        the corpus's device: no upload and no host read, so a CUDA graph
        can capture it (the scan engine's block gathers each round's
        cohort so). ``idx`` is int32 or int64. A sharded corpus has no
        such one-device gather and raises: its traced gather is
        :meth:`traced_blocks`."""
        if len(self._blocks) > 1:
            raise ValueError(
                "a corpus sharded over a client mesh gathers through "
                "cohort/cohort_blocks, or traced_blocks inside a captured "
                "graph; the one-device traced gather takes an unsharded "
                "corpus")
        out = {k: v.index_select(0, idx) for k, v in self._blocks[0].items()}
        return finish_cohort(out, self.transform, active)

    def traced_blocks(self, idx: torch.Tensor, layout: torch.Tensor,
                      active=None) -> list:
        """:meth:`cohort_blocks` with no host step, so a CUDA graph can
        capture it (the scan engine's sharded block gathers each round's
        cohort so).

        ``idx`` (m,) holds the cohort's global ids in ``[0, N)`` and
        ``layout`` (n, per) the cohort positions of each block, both int
        tensors on the corpus's device; ``layout`` is
        :func:`repro_torch.fl.runtime.sharding.device_layout`'s, one row a
        corpus block (n is the mesh's size). ``active`` (m,), if given,
        are the queue's counts on that device. Block b is filled on the
        corpus's device b and equals the host slice of its positions bit
        for bit, pad rows included. For each block, every corpus block j
        gathers the block's rows at their local ids (``id % per``) on its
        own device and sends them to block b's; a select chain on the
        owner (``id // per == j``) keeps each row's own. So it reads n
        times the cohort's bytes, fixed shapes whatever the ids, and never
        sums (a -0.0 or NaN row stays its bits). Each block is finished
        (:func:`finish_cohort`) on its device."""
        if len(layout) != len(self._blocks):
            raise ValueError(f"{len(layout)} layout rows for "
                             f"{len(self._blocks)} corpus blocks")
        per = self.padded_num_clients // len(self._blocks)
        out = []
        for b, dst in enumerate(self._devices):
            ids = idx.index_select(0, layout[b])
            owner, local = ids // per, ids % per
            block = {}
            for j, (blk, src) in enumerate(zip(self._blocks, self._devices)):
                at = local.to(src)
                mine = None if j == 0 else (owner == j).to(dst)
                for k, v in blk.items():
                    rows = v.index_select(0, at).to(dst)
                    block[k] = rows if mine is None else torch.where(
                        mine.reshape((-1,) + (1,) * (rows.dim() - 1)),
                        rows, block[k])
            act = None if active is None \
                else active.index_select(0, layout[b]).to(dst)
            out.append(finish_cohort(block, self.transform, act))
        return out

    def block(self, j: int = 0) -> dict:
        """Shard block ``j``'s arrays on its device, pad rows included (the
        whole corpus unsharded); no copy."""
        return self._blocks[j]

    def with_rows(self, clients, rows: dict) -> "ClientCorpus":
        """A new corpus on the same device, in the same layout (mesh and
        pad), in which clients ``clients`` hold ``rows`` (a ``{x, y, w}``
        subset of the same sample length) in place of their own; keys the
        corpus lacks are ignored. The copy and the replacement run on each
        block's device."""
        ids = np.asarray(clients, np.int64)
        per = self.padded_num_clients // len(self._blocks)
        new = object.__new__(ClientCorpus)
        new.__dict__.update(self.__dict__)
        new._sizes, new._hists, new.block_copy_nbytes = None, {}, 0
        new._blocks = []
        for j, (blk, d) in enumerate(zip(self._blocks, self._devices)):
            mine = np.nonzero(ids // per == j)[0]
            at = torch.as_tensor(ids[mine] % per, device=d)
            arrays = {}
            for k, v in blk.items():
                if k in rows and len(mine):
                    src = np.asarray(rows[k])[mine]
                    v = v.index_copy(0, at, torch.as_tensor(
                        src, device=d).to(v.dtype))
                arrays[k] = v
            new._blocks.append(arrays)
        return new
