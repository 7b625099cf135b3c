"""Device meshes for the launchers (functions only — importing this
module touches no device state).

The counterpart of ``repro.launch.mesh``. Under an initialized
``torch.distributed`` process group (one process a rank: ``torchrun``,
or the dry-run's ``"fake"`` group) a mesh is a ``DeviceMesh`` of the
world's ranks with named dims, the gradient-level mesh step's
(``core/distributed.py`` under ``sharding.ctx.use_mesh``); in one process
without a group it is a :class:`DeviceGrid`, an ndarray of
``torch.device`` with one name per axis, the single controller's:

* ``make_host_mesh(model_axis=1)``: a ``("data", "model")`` mesh of the
  world's ranks (one card a rank, or the CPU under gloo), or without a
  group a grid of the visible devices (every card, or the CPU alone);
* ``fl_clients_for(mesh)``: one FL client group per ``("pod", "data")``
  row;
* ``make_production_mesh(multi_pod=...)``: the reference's (16, 16) and
  (2, 16, 16) production shapes over a group of 256 or 512 ranks.

The weights-level client fan-out
(:func:`repro_torch.fl.runtime.sharding.client_mesh_from`) takes the first
device of each row of a grid.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch.distributed as dist

from ..device import visible_devices
from ..sharding.specs import mesh_shape


@dataclass(frozen=True, eq=False)
class DeviceGrid:
    """``devices``: an ndarray of ``torch.device``, one axis per name in
    ``axis_names``; ``shape`` maps each name to its size, as a JAX
    ``Mesh``'s does."""
    devices: np.ndarray
    axis_names: tuple

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim} axes of devices for the "
                             f"names {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))


def _grid(devices: list, shape: tuple, axes: tuple) -> DeviceGrid:
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return DeviceGrid(arr.reshape(shape), tuple(axes))


def world_mesh(shape: tuple, axes: tuple):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the initialized
    process group's ranks: on the cards under ``nccl``, else on the CPU
    (gloo, and the ``"fake"`` group of the dry-run). Raises unless the
    group has exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise RuntimeError(f"a {shape} mesh needs {math.prod(shape)} "
                           f"ranks; the process group has {world}")
    kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's production mesh: (16, 16) ``("data", "model")``
    or (2, 16, 16) ``("pod", "data", "model")``, over an initialized
    process group of 256 or 512 ranks (the dry-run's ``"fake"`` group
    stands in for them). Raises otherwise: one host shows 1-8 cards."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    want = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != want:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs {want} "
            f"devices, one a rank of an initialized process group; "
            f"{have} ranks (the dry-run's --multi-pod runs them under "
            "the fake group)")
    return world_mesh(shape, axes)


def make_host_mesh(model_axis: int = 1):
    """A ``("data", "model")`` mesh of the process group's ranks where a
    group is initialized (``DeviceMesh``), else a grid of the visible
    devices (:class:`DeviceGrid`)."""
    if dist.is_initialized():
        world = dist.get_world_size()
        if model_axis < 1 or world % model_axis:
            raise ValueError(f"model_axis {model_axis} does not divide "
                             f"the {world} ranks")
        return world_mesh((world // model_axis, model_axis),
                          ("data", "model"))
    devs = visible_devices()
    if model_axis < 1 or len(devs) % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the "
                         f"{len(devs)} visible devices")
    return _grid(devs, (len(devs) // model_axis, model_axis),
                 ("data", "model"))


def fl_clients_for(mesh) -> int:
    """One FL client group per ("pod", "data") mesh row."""
    shape = mesh_shape(mesh)
    return max(shape.get("data", 1) * shape.get("pod", 1), 1)
