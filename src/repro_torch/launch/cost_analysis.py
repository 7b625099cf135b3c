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
  * ``collective_bytes`` / ``collective_counts`` — per collective kind
                      (the reference's HLO names: all-reduce,
                      all-gather, reduce-scatter, all-to-all), the
                      operand bytes and the calls of the ``c10d`` ops
                      (functional or not) that DTensor's redistributions
                      and the expert-parallel block issue; none on one
                      card. A collective moves no HBM bytes here.

On DTensors the mode lets DTensor take each op and counts the local
ops and collectives it runs (not the shape inference of its sharding
propagation), so every count is per device (the dry-run's ranks under
the ``"fake"`` group all run the same program). ``track`` registers the call's arguments (weights, batch,
cache; a DTensor by its local block) before the call, so the peak holds
them; ``memory_analysis`` gives the
reference's ``argument_size_in_bytes``, ``output_size_in_bytes`` and
``temp_size_in_bytes`` (the peak above the arguments).

With ``log=True`` the counter also keeps one row a counted op, in call
order (:data:`LOG_COLUMNS`; :meth:`write_log` writes them as
tab-separated lines), what the port has in place of the reference's
compiled HLO text: the sums of its ``flops``, ``hbm_bytes`` and
``collective_bytes`` columns are the totals, and the largest
``live_bytes`` is ``peak_bytes`` (the first row, ``<arguments>``, holds
the arguments alone). The op at which ``live_bytes`` peaks is where a
call's memory goes.
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

# ops that move no bytes: an allocation without a write
_NO_TRAFFIC = {aten.empty.memory_format, aten.empty_strided.default,
               aten.empty_like.default, aten.new_empty.default,
               aten.new_empty_strided.default}


# collective kind of each c10d op (functional, autograd-functional or
# in place), by the op's name
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
}
_C10D = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


LOG_COLUMNS = ("op", "out_shapes", "dtype", "flops", "hbm_bytes",
               "live_bytes", "collective", "collective_bytes")


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of ``tree``, a DTensor as its local block."""
    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(t: torch.Tensor) -> int:
    """The bytes an op reads or writes of ``t``: its elements', at most
    its storage's."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, bytes and live memory of the ops run under it
    (see the module's docstring). Use as a context manager around one
    call, after :meth:`track` of its arguments."""

    def __init__(self, log: bool = False):
        super().__init__()
        self.log: list[tuple] | None = [] if log else None
        self.flops = 0
        self.hbm_bytes = 0
        self.by_op: dict[str, dict] = defaultdict(
            lambda: {"calls": 0, "flops": 0, "hbm_bytes": 0})
        self.collective_bytes: dict[str, int] = defaultdict(int)
        self.collective_counts: dict[str, int] = defaultdict(int)
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
        if self.log is not None:
            self.log.append(("<arguments>", "", "", 0, 0, self.live_bytes,
                             "", 0))
        return n

    def _row(self, packet, outs, flops=0, hbm=0, kind=None, coll=0):
        if self.log is None:
            return
        shapes = ";".join("x".join(map(str, t.shape)) for t in outs)
        dtype = ";".join(sorted({str(t.dtype).replace("torch.", "")
                                 for t in outs}))
        self.log.append((packet.__name__, shapes, dtype, flops, hbm,
                         self.live_bytes, kind or "", coll))

    def write_log(self, path: str) -> int:
        """Writes the op log (``log=True``) to ``path``, a header line of
        :data:`LOG_COLUMNS` and one tab-separated line a row; returns the
        rows written."""
        if self.log is None:
            raise ValueError("the counter was made without log=True")
        with open(path, "w") as f:
            f.write("\t".join(LOG_COLUMNS) + "\n")
            for row in self.log:
                f.write("\t".join(map(str, row)) + "\n")
        return len(self.log)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # DTensor runs the op as each rank's local ops and
            # collectives, which come back here to be counted
            return NotImplemented
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's sharding propagation infers shapes on fake
            # tensors of the global shapes: no rank runs these
            return func(*args, **kwargs)
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
        kind = (COLLECTIVE_KINDS.get(packet.__name__)
                if func.namespace in _C10D else None)
        if kind is not None:
            n = _bytes(_tensors((args, kwargs))[0])
            self.collective_counts[kind] += 1
            self.collective_bytes[kind] += n
            self._row(packet, outs, kind=kind, coll=n)
            return out
        f = n = 0
        if packet in flop_registry:
            f = int(flop_registry[packet](*args, **kwargs, out_val=out))
            rec["flops"] += f
            self.flops += f
        if not func.is_view and func not in _NO_TRAFFIC:
            n = sum(_bytes(t) for t in _tensors((args, kwargs)) + outs)
            rec["hbm_bytes"] += n
            self.hbm_bytes += n
        self._row(packet, outs, f, n)
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
                "collective_bytes": {k: float(v) for k, v in
                                     sorted(self.collective_bytes.items())},
                "collective_bytes_total": float(
                    sum(self.collective_bytes.values())),
                "collective_counts": dict(sorted(
                    self.collective_counts.items())),
                "by_op": {k: dict(v) for k, v in sorted(self.by_op.items())}}
