"""Device grids for the launchers (functions only — importing this module
touches no device state).

The counterpart of ``repro.launch.mesh``. A :class:`DeviceGrid` is an
ndarray of ``torch.device`` with one name per axis:

* ``make_host_mesh(model_axis=1)``: a ``("data", "model")`` grid of the
  visible devices (every card, or the CPU alone where there is none);
* ``fl_clients_for(grid)``: one FL client group per ``("pod", "data")``
  row;
* ``make_production_mesh(multi_pod=...)``: the reference's (16, 16) and
  (2, 16, 16) production shapes, which need 256 and 512 visible devices.

The weights-level client fan-out
(:func:`repro_torch.fl.runtime.sharding.client_mesh_from`) takes the first
device of each row. The gradient-level mesh step over these grids
(``core/distributed.py`` with sharded parameters) is not ported: ROADMAP
queue 1, "the gradient-level mesh step over several cards".
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..device import visible_devices

MESH_STEP = ("the gradient-level mesh step over several cards is not "
             "ported: ROADMAP queue 1, \"the gradient-level mesh step "
             "over several cards\"")


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


def make_production_mesh(*, multi_pod: bool = False) -> DeviceGrid:
    """The reference's production grid: (16, 16) ``("data", "model")``
    or (2, 16, 16) ``("pod", "data", "model")``. Raises unless that many
    devices are visible (one host shows 1-8 cards)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = visible_devices()
    want = int(np.prod(shape))
    if len(devs) != want:
        raise RuntimeError(
            f"make_production_mesh(multi_pod={multi_pod}) needs {want} "
            f"devices, {len(devs)} visible; {MESH_STEP}")
    return _grid(devs, shape, axes)


def make_host_mesh(model_axis: int = 1) -> DeviceGrid:
    """A ``("data", "model")`` grid over the visible devices."""
    devs = visible_devices()
    if model_axis < 1 or len(devs) % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide the "
                         f"{len(devs)} visible devices")
    return _grid(devs, (len(devs) // model_axis, model_axis),
                 ("data", "model"))


def fl_clients_for(mesh) -> int:
    """One FL client group per ("pod", "data") mesh row."""
    m = mesh.shape.get("data", 1) * mesh.shape.get("pod", 1)
    return max(m, 1)
