"""Divisibility-aware logical -> mesh sharding rules, the port of
``repro.sharding.specs`` on DTensor placements.

Every tensor dimension carries a *logical axis name*; the rule table maps
names to (tuples of) mesh axes. A mesh axis is applied only if it divides
the dimension — otherwise the rule retries with a shorter prefix and
finally replicates, and no mesh axis shards two dims of one tensor. One
rule table so covers kv=2 (replicated on a 16-way "model" axis) and
kv=16 (sharded) without per-arch special cases.

:func:`logical_to_pspec` gives a :class:`PartitionSpec` (one entry a
tensor dim: a mesh axis name, a tuple of them, or None), the reference's
value; :func:`placements` turns it into one DTensor placement a mesh dim.
A tensor dim over two mesh dims, as ``("pod", "data")``, is
``Shard(d)`` on both, in mesh order: DTensor splits by the first mesh
dim, then within each part by the next, the reference's major-to-minor
layout. The mesh is a ``DeviceMesh`` with named dims or anything with a
``.shape`` dict of axis sizes (the reference's tests' ``FakeMesh``).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate, Shard

# logical axis -> preferred mesh axes (tried longest-prefix-first)
DEFAULT_RULES: dict = {
    "batch": ("pod", "data"),
    "fl_clients": ("pod", "data"),
    "seq": (),
    "embed": ("pod", "data"),        # FSDP axis for params
    "vocab": ("model",),
    "heads": ("model",),             # fused num_heads*head_dim dims
    "kv_heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "capacity": ("pod", "data"),
    "ssm_inner": ("model",),
    "ssm_state": (),
    "frames": (),
    "kv_time": (),
    None: (),
}


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh axis, a tuple of mesh axes (major
    first) or None (replicated); a tuple, as ``jax.sharding.
    PartitionSpec`` is."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_shape(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (its dim names) or of
    anything with a ``.shape`` dict."""
    shape = mesh.shape
    if isinstance(shape, dict):
        return dict(shape)
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh for the sharding rules needs "
                         "mesh_dim_names")
    return dict(zip(names, shape))


def _axes_for(dim: int, names: Sequence[str], shape: dict):
    """Longest prefix of mesh axes whose product divides ``dim``."""
    live = [n for n in names if n in shape]
    for end in range(len(live), 0, -1):
        pick = live[:end]
        prod = math.prod(shape[n] for n in pick)
        if prod > 1 and dim % prod == 0:
            return tuple(pick) if len(pick) > 1 else pick[0]
    return None


def logical_to_pspec(logical: Sequence[Optional[str]], shape: Sequence[int],
                     mesh, rules: dict | None = None) -> PartitionSpec:
    rules = rules or DEFAULT_RULES
    sizes = mesh_shape(mesh)
    parts, used = [], set()
    for dim, name in zip(shape, logical):
        cand = tuple(a for a in rules.get(name, ()) if a not in used)
        ax = _axes_for(dim, cand, sizes) if cand else None
        if ax is not None:
            used.update(ax if isinstance(ax, tuple) else (ax,))
        parts.append(ax)
    return P(*parts)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` where tensor dim d names the mesh dim, else
    ``Replicate()``. Raises where a dim's tuple of mesh axes is not in
    mesh order (a layout DTensor's ``Shard`` cannot express)."""
    names = list(mesh_shape(mesh))
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} over {axes}: not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def logical_placements(logical: Sequence[Optional[str]],
                       shape: Sequence[int], mesh,
                       rules: dict | None = None) -> tuple:
    """:func:`placements` of :func:`logical_to_pspec`."""
    return placements(logical_to_pspec(logical, shape, mesh, rules), mesh)


def tree_shardings(logical_tree, shape_tree, mesh, rules=None):
    """A tree of logical-axis tuples and the matching tree of tensors
    (or anything with ``.shape``) -> the same tree of DTensor placements.
    Trees are dicts and lists; a tuple is a leaf."""
    if isinstance(logical_tree, tuple):
        if not hasattr(shape_tree, "shape"):     # a cache's int index
            return None
        return logical_placements(logical_tree, tuple(shape_tree.shape),
                                  mesh, rules)
    if isinstance(logical_tree, dict):
        return {k: tree_shardings(v, shape_tree[k], mesh, rules)
                for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [tree_shardings(v, s, mesh, rules)
                for v, s in zip(logical_tree, shape_tree)]
    raise TypeError(f"logical axes {logical_tree!r}: expected a tuple, "
                    "a dict or a list")


def mesh_block(mesh, dims: Sequence[int]) -> tuple[int, int]:
    """(ranks, this rank's block) of a tensor dim split over mesh
    ``dims``, major first: how many blocks, and which one this rank
    holds (1, 0 over no dims, ``mesh`` then unused)."""
    ranks, block = 1, 0
    coord = mesh.get_coordinate() if dims else None
    for i in dims:
        ranks *= mesh.size(i)
        block = block * mesh.size(i) + coord[i]
    return ranks, block


def all_reduce_over(t: torch.Tensor, op: str, mesh,
                    dims: Sequence[int]) -> torch.Tensor:
    """``t`` reduced (``op``: "sum", "max") over the ranks of mesh
    ``dims``, one functional all-reduce a mesh dim; not differentiable."""
    for i in dims:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, i)))
    return t


def _local_block(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``t`` under ``placements``, mesh dim by mesh
    dim (a tensor dim over two mesh dims split by the first, then each
    part by the next)."""
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard():
            t = t.chunk(mesh.size(i), dim=pl.dim)[coord[i]]
    return t


def distribute_full(t: torch.Tensor, mesh, placements) -> DTensor:
    """A tensor that every rank holds whole and alike (the same seed,
    the same draw) as a DTensor in ``placements``: each rank keeps a
    copy of its block, with no collective (``distribute_tensor`` scatters
    from one rank), and so holds no more than its block once the whole
    is dropped (a block that is a view, a slice along dim 0, would keep
    the whole tensor's storage). A tensor no placement splits is kept as
    it is. Raises where a sharded dim does not split evenly."""
    for i, pl in enumerate(placements):
        if pl.is_shard() and t.shape[pl.dim] % mesh.size(i):
            raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not "
                             f"split over mesh dim {i} ({mesh.size(i)})")
    local = _local_block(t, mesh, placements)
    local = (local.clone(memory_format=torch.contiguous_format)
             if local.numel() < t.numel() else local.contiguous())
    return DTensor.from_local(local, mesh, placements,
                              run_check=False, shape=t.shape,
                              stride=torch.empty(t.shape,
                                                 device="meta").stride())
