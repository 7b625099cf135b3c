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

from ..device import resolve_device


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


def refuse_shard(corpus) -> None:
    """The client axis over several cards is not ported: both planes'
    ``shard`` raises."""
    raise NotImplementedError(
        f"{type(corpus).__name__}.shard (the client axis over several "
        "GPUs) is not ported: ROADMAP queue 1, \"Several cards\"")


class ClientCorpus(Mapping):
    """Stacked client arrays resident on ``device``; see the module
    docstring. A ``Mapping`` over its arrays."""

    plane = "resident"

    def __init__(self, arrays: dict, *, transform: Normalize | None = None,
                 device="cuda"):
        if not arrays:
            raise ValueError("ClientCorpus needs at least one array")
        n = {k: np.shape(v)[0] for k, v in arrays.items()}
        if len(set(n.values())) != 1:
            raise ValueError(f"client axes disagree: {n}")
        self.device = resolve_device(device)
        self._arrays = {k: torch.as_tensor(v, device=self.device)
                        for k, v in arrays.items()}
        self.transform = transform
        self._sizes: np.ndarray | None = None
        self._hists: dict = {}          # num_classes (or None) -> (N, C)

    # ------------------------------------------------------- constructors
    @classmethod
    def from_stacked(cls, data, *, transform: Normalize | None = None,
                     device="cuda") -> "ClientCorpus":
        """Wrap a ``stack_clients``-style dict; identity on a corpus that
        already lives on ``device``."""
        if isinstance(data, ClientCorpus):
            if data.device != resolve_device(device):
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
        return self._arrays[key]

    def __iter__(self):
        return iter(self._arrays)

    def __len__(self):
        return len(self._arrays)

    # ----------------------------------------------------------- metadata
    @property
    def num_clients(self) -> int:
        return int(next(iter(self._arrays.values())).shape[0])

    @property
    def samples_per_client(self) -> int:
        return int(self._arrays["y"].shape[1]) if "y" in self._arrays \
            else int(next(iter(self._arrays.values())).shape[1])

    def signature(self) -> tuple:
        """Hashable (key, shape, dtype) + transform tuple."""
        return (tuple((k, tuple(v.shape), str(v.dtype))
                      for k, v in sorted(self._arrays.items())),
                self.transform)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the stored corpus (storage dtype)."""
        return storage_nbytes(self._arrays)

    def device_nbytes(self) -> int:
        """Bytes the corpus holds on its device: all of it."""
        return self.nbytes

    def cohort_nbytes(self, m: int) -> int:
        """Bytes a host-slice data plane would ship per round for a cohort
        of ``m`` clients (this plane ships only the ids)."""
        return cohort_nbytes(self._arrays, self.transform, m)

    def as_numpy(self) -> dict:
        """Host copy of the raw (untransformed) arrays, storage dtype."""
        return {k: v.cpu().numpy() for k, v in self._arrays.items()}

    def memory_report(self) -> dict:
        """The whole corpus on the device, no host mapping or staging
        buffers (:func:`memory_report`'s keys)."""
        return memory_report(self)

    def shard(self, mesh, axis: str = "clients"):
        refuse_shard(self)

    # ------------------------------------------------- control-plane stats
    def sizes(self) -> np.ndarray:
        """Per-client real (unpadded) sample counts, from the w mask."""
        if self._sizes is None:
            if "w" in self._arrays:
                self._sizes = self._arrays["w"].sum(dim=1).cpu().numpy() \
                    .astype(np.int64)
            else:
                self._sizes = np.full(self.num_clients,
                                      self.samples_per_client, np.int64)
        return self._sizes

    def label_histograms(self, num_classes: int | None = None) -> np.ndarray:
        """(N, C) weighted label counts, the ``queue`` selector's ranking
        input: numpy over a host copy of ``y`` and ``w``, computed once
        per ``num_classes`` and cached."""
        if num_classes not in self._hists:
            from ..core.pools import label_histograms
            y = self._arrays["y"].cpu().numpy()
            w = (self._arrays["w"].cpu().numpy() if "w" in self._arrays
                 else None)
            self._hists[num_classes] = label_histograms(
                y, w, num_classes=num_classes)
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
        ``active`` move host -> device, in one copy.
        """
        idx = np.asarray(idx, np.int64)
        if active is None:
            return self.traced_cohort(torch.as_tensor(idx,
                                                      device=self.device))
        both = torch.as_tensor(np.stack([idx, np.asarray(active, np.int64)]),
                               device=self.device)
        return self.traced_cohort(both[0], both[1])

    def traced_cohort(self, idx: torch.Tensor, active=None) -> dict:
        """:meth:`cohort`'s gather on ``idx`` (and ``active``) already on
        the corpus's device: no upload and no host read, so a CUDA graph
        can capture it (the scan engine's block gathers each round's
        cohort so). ``idx`` is int32 or int64."""
        out = {k: v.index_select(0, idx) for k, v in self._arrays.items()}
        return finish_cohort(out, self.transform, active)

    def with_rows(self, clients, rows: dict) -> "ClientCorpus":
        """A new corpus on the same device in which clients ``clients``
        hold ``rows`` (a ``{x, y, w}`` subset of the same sample length)
        in place of their own; keys the corpus lacks are ignored. The copy
        and the replacement run on the device."""
        ids = torch.as_tensor(np.asarray(clients, np.int64),
                              device=self.device)
        arrays = {}
        for k, v in self._arrays.items():
            if k in rows:
                new = torch.as_tensor(np.asarray(rows[k]),
                                      device=self.device).to(v.dtype)
                v = v.index_copy(0, ids, new)
            arrays[k] = v
        return ClientCorpus(arrays, transform=self.transform,
                            device=self.device)
