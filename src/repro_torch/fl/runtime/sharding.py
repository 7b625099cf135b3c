"""The client axis over several devices: the pipelined engine's fan-out.

``Server`` runs the vmapped ClientUpdate for the whole cohort on one
device. Here the cohort is split over a :class:`ClientMesh`, an ordered
tuple of devices under the axis name ``"clients"``: each shard position
runs the same client program on its own block of the cohort, on its own
device (a captured CUDA graph on a card, the eager function on the CPU),
and the outputs are gathered onto the mesh's first device, the server's,
where judgment, speculation, aggregation and the pools stay. Clients are
independent until aggregation, so no collective is needed, as in the
reference's ``shard_map`` fan-out (``repro.fl.runtime.sharding``); one
process drives every device, as the reference's single controller does.

The cohort is padded up to a multiple of the mesh size by repeating its
last row (:func:`pad_to_multiple`) — for a chain program its last whole
group — and the gathered outputs are cut back to |S_t| (or G groups)
before judgment, so verdicts and aggregation see exactly the real
cohort. That pad is not the corpus's: :meth:`repro_torch.data.corpus.
ClientCorpus.shard` pads the *resident* client axis with zero rows so an
uneven N splits into equal blocks, while this module pads the *gathered
cohort* so an uneven |S_t| does — two independent axes of the same
uneven-mesh contract. A corpus laid out over the same mesh fills each
cohort block on that block's device (``cohort_blocks``, from host ids;
``traced_blocks``, from ids on the device, inside the scan engine's
captured block), and the fan-out takes the blocks as they are
(:class:`ShardBlocks`).

A mesh may name one device more than once: that is how the CPU tests and
a one-card run form several shards (the counterpart of the reference's
forced host devices). The gather from a shard on another card is a
device-to-device copy ordered by stream events (``Tensor.to`` between
cards), with no host synchronisation.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ...core.strategies import ApplyFn
from ...data.corpus import CLIENT_AXIS
from ...device import canonical_device, visible_devices
from ..server import _make_client_fn

__all__ = [
    "CLIENT_AXIS", "ClientMesh", "ShardBlocks", "client_mesh_from",
    "device_layout", "make_client_mesh", "make_sharded_client_fn",
    "pad_to_multiple",
]


@dataclass(frozen=True)
class ClientMesh:
    """An ordered tuple of devices along the ``"clients"`` axis: shard
    position j runs block j of the cohort on ``devices[j]``; the first
    device is the server's. All cards or all CPU; a device may repeat."""
    devices: tuple
    axis_name: str = CLIENT_AXIS

    def __post_init__(self):
        devs = tuple(canonical_device(d) for d in self.devices)
        if not devs:
            raise ValueError("a client mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a client mesh is all cards or all CPU, got "
                             f"{[str(d) for d in devs]}")
        object.__setattr__(self, "devices", devs)

    @property
    def shape(self) -> dict:
        return {self.axis_name: len(self.devices)}

    @property
    def home(self) -> torch.device:
        """The server's device: outputs are gathered here."""
        return self.devices[0]

    def __len__(self) -> int:
        return len(self.devices)


def make_client_mesh(devices=None) -> ClientMesh:
    """A client mesh over ``devices`` (default: every visible card, once
    each; the CPU alone where there is no card)."""
    return ClientMesh(tuple(visible_devices() if devices is None
                            else devices))


def client_mesh_from(mesh) -> ClientMesh:
    """The client mesh over a device grid's client rows.

    :mod:`repro_torch.launch.mesh` maps one FL client group per
    ("pod", "data") row (``fl_clients_for``); this takes the first device
    of each row — the weights-level ClientUpdate fits one device, and the
    row's "model" axis stays free. A :class:`ClientMesh` passes through."""
    if isinstance(mesh, ClientMesh):
        return mesh
    from ...launch.mesh import fl_clients_for
    rows = fl_clients_for(mesh)
    return ClientMesh(tuple(mesh.devices.reshape(rows, -1)[:, 0]))


def _pad_leaf(x, multiple: int):
    if x is None:
        return None
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x
    if isinstance(x, np.ndarray):
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)
    return torch.cat([x, x[-1:].expand((rem,) + tuple(x.shape[1:]))])


def pad_to_multiple(tree, multiple: int):
    """Edge-repeat every leaf's leading axis up to a multiple; identity if
    already divisible. Tensors or numpy arrays. Padded rows are dropped by
    the caller afterwards, so repeating real rows keeps every op
    well-conditioned."""
    return pytree.tree_map(lambda x: _pad_leaf(x, multiple), tree)


def device_layout(m: int, n: int, device) -> torch.Tensor:
    """``pad_to_multiple(np.arange(m), n).reshape(n, -1)`` made on
    ``device`` by one fill and one clamp, with no upload, so a captured
    graph can build it: the cohort positions of each of n blocks, the
    last position repeated into the pad (int64)."""
    per = -(-m // n)
    return torch.arange(n * per, device=device).clamp(max=m - 1) \
        .reshape(n, per)


class ShardBlocks:
    """An axis-0 argument already laid out over a client mesh: ``parts[j]``
    (a tree) is block j, on shard j's device, pad rows included;
    ``length`` is the count of real leading rows (|S_t|, or G groups)."""

    def __init__(self, parts: list, length: int):
        self.parts = list(parts)
        self.length = int(length)


def _split(tree, n: int, devices) -> list:
    """Tree with a leading axis that ``n`` divides -> n blocks, block j on
    ``devices[j]``."""
    leaves, spec = pytree.tree_flatten(tree)
    per = [[None] * len(leaves) for _ in range(n)]
    for i, x in enumerate(leaves):
        if x is None:
            continue
        for j, chunk in enumerate(torch.chunk(x, n)):
            per[j][i] = chunk.to(devices[j])
    return [pytree.tree_unflatten(p, spec) for p in per]


def _on(tree, device):
    return pytree.tree_map(lambda x: None if x is None else x.to(device),
                           tree)


def _leading(tree) -> int:
    return next(x for x in pytree.tree_leaves(tree)
                if x is not None).shape[0]


def make_sharded_client_fn(apply_fn: ApplyFn, spec, in_axes,
                           mesh: ClientMesh, *, inner=None,
                           inner_axes: tuple = (0,), program=None):
    """The ClientUpdate fanned out over ``mesh``.

    Returns ``fn(global_params, data, prev_p, c_loc, c_glob, ...)`` with
    the signature and result of the vmapped client program, the leading
    length of the result included (the pad is internal). ``in_axes`` is
    the strategy's vmap spec: axis-0 arguments are padded to a multiple of
    the mesh (last row repeated) and split into blocks, block j copied to
    shard j's device; ``None`` arguments go whole to every shard's device;
    a :class:`ShardBlocks` argument is taken as laid out. Each shard's
    outputs come back to the mesh's first device, in shard order, cut to
    the real rows.

    ``inner`` swaps the vmapped default for a strategy-built program.
    ``inner_axes`` are the axes of any arguments the inner program takes
    *beyond* the standard five — the default ``(0,)`` is the FedCAT chain
    contract (one extra axis-0 chain-validity mask; the program's leading
    axis is then the GROUP axis: whole chains go to a shard, never single
    stages, and the pad repeats whole groups, whose dropped outputs
    cannot reach a real chain); a strategy whose client keeps the plain
    five-argument signature (the LM window rule) passes ``()``.

    ``program(j, args)`` gives the callable shard j runs on its arguments
    (the server's captured graph for that shard); by default every shard
    runs the eager program.
    """
    vm = inner if inner is not None else _make_client_fn(apply_fn, spec,
                                                         in_axes)
    axes = tuple(in_axes) + (tuple(inner_axes) if inner is not None
                             else ())
    devices = mesh.devices
    n = len(devices)
    if program is None:
        def program(j, args):
            return vm

    def call(global_params, data, *rest):
        args = (global_params, data) + rest
        if len(args) != len(axes):
            raise TypeError(f"the sharded client program takes {len(axes)} "
                            f"arguments, got {len(args)}")
        m = data.length if isinstance(data, ShardBlocks) else _leading(data)
        shards = [[] for _ in range(n)]
        for a, ax in zip(args, axes):
            if isinstance(a, ShardBlocks):
                if len(a.parts) != n:
                    raise ValueError(f"{len(a.parts)} blocks for a mesh of "
                                     f"{n}")
                parts = a.parts
            elif ax == 0 and a is not None:
                parts = _split(pad_to_multiple(a, n), n, devices)
            else:
                parts = [_on(a, d) for d in devices]
            for j in range(n):
                shards[j].append(parts[j])
        outs = [program(j, tuple(s))(*s) for j, s in enumerate(shards)]
        home = devices[0]
        return pytree.tree_map(
            lambda *xs: torch.cat([x.to(home) for x in xs])[:m], *outs)

    call.mesh = mesh
    return call
