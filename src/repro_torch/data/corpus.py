"""Device-resident client corpus: the FL data plane.

``ClientCorpus`` holds the stacked per-client arrays (``x:(N,S,...)``,
``y:(N,S)``, ``w:(N,S)``) on the device, once, in their storage dtype, and
answers the questions every layer above would otherwise re-derive per
round:

* **data plane** — :meth:`cohort` gathers the round's clients along the
  client axis on the device (optionally applying a :class:`Normalize`);
  per round only the ``idx`` vector crosses from host to device.
* **control plane** — :meth:`sizes` is the per-client sample count the
  selectors and the judgment weigh by, computed once and cached.

Images stay NHWC, as in the JAX package.
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
        mean = torch.tensor(self.mean, dtype=torch.float32, device=x.device)
        std = torch.tensor(self.std, dtype=torch.float32, device=x.device)
        return (x - mean) / std


class ClientCorpus(Mapping):
    """Stacked client arrays resident on ``device``; see the module
    docstring. A ``Mapping`` over its arrays."""

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
    def signature(self) -> tuple:
        """Hashable (key, shape, dtype) + transform tuple."""
        return (tuple((k, tuple(v.shape), str(v.dtype))
                      for k, v in sorted(self._arrays.items())),
                self.transform)

    @property
    def nbytes(self) -> int:
        """Resident bytes of the stored corpus (storage dtype)."""
        return int(sum(v.numel() * v.element_size()
                       for v in self._arrays.values()))

    # ------------------------------------------------- control-plane stats
    def sizes(self) -> np.ndarray:
        """Per-client real (unpadded) sample counts, from the w mask."""
        if self._sizes is None:
            self._sizes = self._arrays["w"].sum(dim=1).cpu().numpy().astype(
                np.int64)
        return self._sizes

    # ------------------------------------------------------------ data plane
    def cohort(self, idx) -> dict:
        """On-device gather of clients ``idx`` along axis 0 (then the
        transform, if any). Only ``idx`` moves host -> device."""
        idx = torch.as_tensor(np.asarray(idx, np.int64), device=self.device)
        out = {k: v.index_select(0, idx) for k, v in self._arrays.items()}
        if self.transform is not None:
            out["x"] = self.transform(out["x"])
        return out
