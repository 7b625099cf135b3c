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
