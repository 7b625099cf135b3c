"""Cost of one eager call, counted op by op — the port's counterpart of
``repro.launch.hlo_analysis``.

The reference walks compiled HLO and multiplies each loop body by its
trip count. The port runs eagerly, so its loops are already unrolled:
:class:`CostCounter` is a ``TorchDispatchMode`` that sees every ATen op
of a call, on meta tensors for the dry-run (nothing is computed or
allocated), autograd's backward ops and a checkpoint's recomputation
among them, and records, per op and in total:

  * ``flops``       — the products' FLOPs, 2·M·N·K as the reference
                      counts a dot, from ``torch.utils.flop_counter``'s
                      formulas (mm, addmm, bmm, baddbmm, convolutions
                      and their backward, SDPA);
  * ``hbm_bytes``   — each op's input and output bytes, views and
                      allocations without a write left out: the
                      unfused eager traffic the port moves (a tensor
                      counts at most its storage's bytes, so a slice
                      counts its view and an expanded one its storage);
  * ``peak_bytes``  — the live bytes at their highest, the call's
                      arguments included: each storage an op makes
                      counts from that op until it is freed (a finaliser
                      on the storage);
  * ``collective_bytes`` — 0 on one card; the key keeps the reference's
                      record shape.

``track`` registers the call's arguments (weights, batch, cache) before
the call, so the peak holds them; ``memory_analysis`` gives the
reference's ``argument_size_in_bytes``, ``output_size_in_bytes`` and
``temp_size_in_bytes`` (the peak above the arguments).
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that move no bytes: an allocation without a write
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements', at most
    its storage's."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and live memory of the ops run under it
    (see the module's docstring). Use as a context manager around one
    call, after :meth:`track` of its arguments."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.hbm_bytes = 0
        self.by_op: dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "flops": 0, "hbm_bytes": 0})
        self.argument_bytes = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: dict[int, int] = {}     # id(storage) -> bytes

    def _add(self, st: torch.UntypedStorage) -> int:
        key = id(st)
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return n

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, tree) -> int:
        """Registers the tensors of ``tree`` as the call's arguments;
        returns their bytes (each storage once)."""
        n = sum(self._add(t.untyped_storage()) for t in _tensors(tree))
        self.argument_bytes += n
        return n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        if packet not in flop_registry:
            # a composite op (``matmul``, ``einsum``) reaches the mode
            # whole where autograd is off (``inference_mode``): run its
            # decomposition, as the eager kernel does, so its parts count
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for t in outs:
            self._add(t.untyped_storage())
        rec = self.by_op[str(packet.__name__)]
        rec["calls"] += 1
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            rec["flops"] += f
            self.flops += f
        if not func.is_view and func not in _NO_TRAFFIC:
            n = sum(_bytes(t) for t in _tensors((args, kwargs)) + outs)
            rec["hbm_bytes"] += n
            self.hbm_bytes += n
        return out

    def memory_analysis(self, outputs, arguments) -> dict:
        """The reference's record: argument, output and temp bytes (the
        peak above the arguments, outputs included where they were live
        at it), and the arguments that the outputs alias (donation)."""
        arg_ids = {id(t.untyped_storage()) for t in _tensors(arguments)}
        out_st = {id(t.untyped_storage()): t.untyped_storage().nbytes()
                  for t in _tensors(outputs)}
        alias = sum(n for k, n in out_st.items() if k in arg_ids)
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": sum(out_st.values()) - alias,
                "temp_size_in_bytes": self.peak_bytes - self.argument_bytes,
                "alias_size_in_bytes": alias}

    def summary(self) -> dict:
        return {"flops": float(self.flops),
                "hbm_bytes": float(self.hbm_bytes),
                "peak_bytes": self.peak_bytes,
                "collective_bytes": {},
                "collective_bytes_total": 0.0,
                "collective_counts": {},
                "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())}}
