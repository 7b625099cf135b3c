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

Both return ``(accepted, rejected, entropy)`` with *relative* indices into
the round's selection; rejected indices are in greedy-removal order.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.judgment import JudgmentResult, judge, judge_np
from .registry import register


def _result_to_lists(res: JudgmentResult
                     ) -> tuple[list[int], list[int], float]:
    mask = res.mask.cpu().numpy()
    accepted = [i for i in range(len(mask)) if mask[i] > 0]
    rejected = [int(k) for k in res.removal_order.cpu().numpy() if k >= 0]
    return accepted, rejected, float(res.entropy)


@register("judge", "maxent")
class MaxEntropyJudge:
    """Paper Algorithm 1: drop devices whose removal raises group entropy.

    backend: "numpy" (float64 host oracle), "torch" (plain float32
    leave-one-out sweep) or "cuda" (the entropy_judge kernel).
    """

    def __init__(self, backend: str = "numpy"):
        if backend not in ("numpy", "torch", "cuda"):
            raise ValueError(f"unknown judge backend {backend!r}")
        self.backend = backend

    def __call__(self, soft_labels: torch.Tensor, sizes: torch.Tensor
                 ) -> tuple[list[int], list[int], float]:
        if self.backend == "numpy":
            return judge_np(soft_labels.cpu().numpy().astype(np.float64),
                            sizes.cpu().numpy().astype(np.float64))
        return _result_to_lists(judge(soft_labels, sizes,
                                      backend=self.backend))


@register("judge", "none")
class PassThroughJudge:
    """Admit every selected device; entropy is not defined (NaN)."""

    def __call__(self, soft_labels: torch.Tensor, sizes: torch.Tensor
                 ) -> tuple[list[int], list[int], float]:
        return list(range(len(sizes))), [], float("nan")
