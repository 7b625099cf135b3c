"""Judge implementations: which selected devices' models aggregate.

``MaxEntropyJudge``  — the paper's Algorithm 1 (greedy removal maximising
                       size-weighted group entropy). ``backend=`` picks the
                       implementation: ``"numpy"`` (default) is the float64
                       host oracle ``judge_np``; ``"torch"`` and ``"cuda"``
                       run the float32 greedy loop ``core.judgment.judge``
                       where the soft labels live — ``"cuda"`` takes each
                       iteration's leave-one-out sweep from the
                       ``entropy_judge`` kernel.
``PassThroughJudge`` — admits everyone (plain FedAvg-of-selected).
``BudgetedJudge``    — beyond-paper forward-greedy selection of exactly
                       ``budget`` devices (``core.judgment.judge_budgeted``)
                       for deployments with a hard per-round uplink cap.

All return ``(accepted, rejected, entropy)`` with *relative* indices into
the round's selection; rejected indices are in greedy-removal order
(``BudgetedJudge``: in index order, as in the reference). Each also
exposes ``traced()``: a function ``(soft float32, sizes float32) ->
JudgmentResult`` that stays on the device of its inputs, which is how the
pipelined engine speculates a verdict on the card. ``on_host`` says
whether the judge computes from a host copy of its inputs (the pipelined
engine then hands it the round's host copy, and the card runs on).

The async buffered engine screens *arriving* updates instead of whole
rounds: ``MaxEntropyJudge.admit`` judges candidates against the
already-admitted (protected) buffer, and :func:`admit_candidates` adapts
any plain round judge to the same candidate-relative admission
signature. Both take host float64 rows, as the reference's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.judgment import (JudgmentResult, judge, judge_budgeted, judge_np,
                             judge_packed)
from .registry import register


def _result_to_lists(packed: torch.Tensor
                     ) -> tuple[list[int], list[int], float]:
    """Accepted and rejected indices and the entropy from a packed
    judgment (``kernels.ref.pack_judgment``'s layout), copied to the host
    in one piece and read there with numpy."""
    host = packed.cpu().numpy()
    m = (host.size - 3) // 2
    order = host[m:2 * m].view(np.int32)
    accepted = np.flatnonzero(host[:m] > 0).tolist()
    rejected = order[order >= 0].tolist()
    return accepted, rejected, float(host[2 * m + 1])


def _stack_buffer(buffer_soft, buffer_sizes, cand_soft, cand_sizes):
    """Concatenate (buffer, candidates) as float64; nb == 0 passes the
    candidate arrays through untouched, so admission over an empty buffer
    is the plain round judgment bit for bit (the async engine's reduction
    rides on this)."""
    cand_soft = np.asarray(cand_soft, np.float64)
    cand_sizes = np.asarray(cand_sizes, np.float64)
    nb = int(np.shape(buffer_sizes)[0])
    if nb == 0:
        return 0, cand_soft, cand_sizes
    soft = np.concatenate(
        [np.asarray(buffer_soft, np.float64), cand_soft], axis=0)
    sizes = np.concatenate(
        [np.asarray(buffer_sizes, np.float64), cand_sizes], axis=0)
    return nb, soft, sizes


def _relative(nb: int, accepted, rejected, ent):
    """Verdicts relative to the candidate block (rows from ``nb`` on)."""
    return ([i - nb for i in accepted if i >= nb],
            [i - nb for i in rejected if i >= nb], ent)


def _upload(device, *arrays) -> list[torch.Tensor]:
    """Host float64 arrays as float32 tensors on ``device`` in one
    host-to-device copy (each a contiguous view of one buffer)."""
    flat = np.concatenate([np.asarray(a, np.float64).reshape(-1)
                           for a in arrays]).astype(np.float32)
    buf = torch.from_numpy(flat).to(device)
    out, off = [], 0
    for a in arrays:
        n = int(np.prod(np.shape(a)))
        out.append(buf[off:off + n].view(np.shape(a)))
        off += n
    return out


def _judge_inputs(judge_obj, device, soft, sizes):
    """Host float64 (soft, sizes) as ``judge_obj`` reads them: float64
    host tensors for a judge ``on_host``, else float32 tensors on
    ``device`` in one copy."""
    if getattr(judge_obj, "on_host", False):
        return torch.from_numpy(soft), torch.from_numpy(sizes)
    return _upload(device, soft, sizes)


def admit_candidates(judge_obj, buffer_soft, buffer_sizes, cand_soft,
                     cand_sizes, device="cpu"
                     ) -> tuple[list[int], list[int], float]:
    """Admission for judges without an ``admit`` method.

    Runs the judge once over buffer ∪ candidates (float64 host tensors
    for a judge ``on_host``, else float32 tensors on ``device``) and reads
    the verdicts for the candidate rows only (*relative* to the candidate
    block; rejected in removal order). Buffered rows have already shipped
    their weights, so a verdict against one of them is ignored here.
    """
    nb, soft, sizes = _stack_buffer(buffer_soft, buffer_sizes,
                                    cand_soft, cand_sizes)
    return _relative(nb, *judge_obj(*_judge_inputs(judge_obj, device, soft,
                                                   sizes)))


@register("judge", "maxent")
class MaxEntropyJudge:
    """Paper Algorithm 1: drop devices whose removal raises group entropy.

    backend: "numpy" (float64 host oracle), "torch" (the plain float32
    loop) or "cuda" (Alg. 1 in one launch of the entropy_judge loop
    kernel).
    """

    def __init__(self, backend: str = "numpy"):
        if backend not in ("numpy", "torch", "cuda"):
            raise ValueError(f"unknown judge backend {backend!r}")
        self.backend = backend

    @property
    def on_host(self) -> bool:
        return self.backend == "numpy"

    def __call__(self, soft_labels: torch.Tensor, sizes: torch.Tensor
                 ) -> tuple[list[int], list[int], float]:
        if self.backend == "numpy":
            return judge_np(soft_labels.cpu().numpy().astype(np.float64),
                            sizes.cpu().numpy().astype(np.float64))
        return _result_to_lists(judge_packed(soft_labels, sizes,
                                             backend=self.backend))

    def traced(self, backend: str | None = None):
        """Alg. 1 in float32 where the soft labels live, on ``backend``
        ("torch": the plain loop; "cuda": one launch of K1's loop, which
        reads nothing back and whose fields view its packed buffer). The
        caller picks the backend (the pipelined engine passes its
        ``spec_backend``); by default the judge's own, the plain loop for
        the numpy judge."""
        if backend is None:
            backend = "torch" if self.backend == "numpy" else self.backend
        return lambda soft, sizes: judge(soft, sizes, backend=backend)

    def admit(self, buffer_soft, buffer_sizes, cand_soft, cand_sizes,
              device="cpu") -> tuple[list[int], list[int], float]:
        """Per-arrival admission for the async engine: Algorithm 1's
        greedy removal over buffer ∪ candidates (host float64 rows), with
        the buffered rows *protected*: they count toward the group entropy
        (their weights already shipped) but are never removal candidates.
        Returns ``(admitted, rejected, entropy)`` relative to the
        candidate block, rejected in removal order.

        ``"numpy"`` runs ``judge_np(..., protected=)`` on the host; the
        ``"torch"`` and ``"cuda"`` routes copy the rows to ``device`` in
        float32 in one piece and run the loop there (``"cuda"``: one launch
        of K1's loop). With an empty buffer this *is* the round judgment
        ``__call__`` runs on the same values, which is what makes the
        async engine's zero-clock reduction bit for bit.
        """
        nb, soft, sizes = _stack_buffer(buffer_soft, buffer_sizes,
                                        cand_soft, cand_sizes)
        if nb == 0:
            return self(*_judge_inputs(self, device, soft, sizes))
        prot = np.zeros(len(sizes))
        prot[:nb] = 1.0
        if self.backend == "numpy":
            return _relative(nb, *judge_np(soft, sizes, protected=prot))
        soft_t, sizes_t, prot_t = _upload(device, soft, sizes, prot)
        return _relative(nb, *_result_to_lists(judge_packed(
            soft_t, sizes_t, backend=self.backend, protected=prot_t)))


@register("judge", "none")
class PassThroughJudge:
    """Admit every selected device; entropy is not defined (NaN)."""

    on_host = True

    def __call__(self, soft_labels: torch.Tensor, sizes: torch.Tensor
                 ) -> tuple[list[int], list[int], float]:
        return list(range(len(sizes))), [], float("nan")

    def traced(self):
        def all_in(soft, sizes):
            m, dev = soft.shape[0], soft.device
            nan = torch.full((), float("nan"), device=dev)
            return JudgmentResult(
                mask=torch.ones(m, device=dev), entropy=nan,
                initial_entropy=nan,
                num_removed=torch.zeros((), dtype=torch.int32, device=dev),
                removal_order=torch.full((m,), -1, dtype=torch.int32,
                                         device=dev))
        return all_in


@register("judge", "budget")
class BudgetedJudge:
    """Keep exactly ``budget`` devices, forward-greedy on group entropy."""

    on_host = False

    def __init__(self, budget: int):
        self.budget = int(budget)

    @classmethod
    def from_config(cls, config, local):
        raise ValueError(
            "BudgetedJudge needs an explicit budget — pass an instance, "
            "e.g. build(..., judge=BudgetedJudge(budget=3))")

    def __call__(self, soft_labels: torch.Tensor, sizes: torch.Tensor
                 ) -> tuple[list[int], list[int], float]:
        res = judge_budgeted(soft_labels, sizes, self.budget)
        host = torch.cat([res.mask, res.entropy.reshape(1)]).cpu().numpy()
        mask = host[:-1]
        return (np.flatnonzero(mask > 0).tolist(),
                np.flatnonzero(mask == 0).tolist(), float(host[-1]))

    def traced(self):
        budget = self.budget
        return lambda soft, sizes: judge_budgeted(soft, sizes, budget)
