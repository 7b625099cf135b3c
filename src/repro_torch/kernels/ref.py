"""Plain PyTorch versions of the port's kernels.

Each function here computes what its kernel computes, with ordinary
tensor ops on any device. The kernel wrappers take them for CPU tensors,
the CPU tests compare them with the JAX package, and ``chip_smoke.py``
holds every kernel against them on the card.
"""
from __future__ import annotations

import torch


def entropy_judge_sweep_reference(soft_labels: torch.Tensor,
                                  sizes: torch.Tensor,
                                  mask: torch.Tensor
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(group_entropy, leave-one-out entropies (M,)) — the plain version of
    the entropy_judge kernel; mirrors core.entropy."""
    from ..core.entropy import group_entropy, leave_one_out_entropies
    p = soft_labels.to(torch.float32)
    w = sizes.to(torch.float32)
    k = mask.to(torch.float32)
    return group_entropy(p, w, k), leave_one_out_entropies(p, w, k)


def masked_weighted_sum_reference(flat: torch.Tensor,
                                  weights: torch.Tensor) -> torch.Tensor:
    """(P,) = sum_i weights[i] * flat[i, :] — the plain version of the
    fused aggregation kernel. Rows are added in index order and each
    product is rounded before its add, the kernel's own arithmetic, so
    the kernel and this version agree bit for bit."""
    w = weights.to(torch.float32)
    x = flat.to(torch.float32)
    out = torch.zeros(x.shape[1], dtype=torch.float32, device=x.device)
    for i in range(x.shape[0]):
        out = out + w[i] * x[i]
    return out
