"""Soft-label statistics and entropy (paper Eq. 2-4).

A *soft label* for device k is the average softmax output over its local
samples (Eq. 2):  p_k = (1/l_k) sum_i softmax(model_k(x_k^i)).

The judgment operates on the dataset-size-weighted mean of the soft labels
of the currently-active device set (Eq. 4) and its Shannon entropy (Eq. 3).

The torch functions run on whatever device their inputs live on; the
``_np`` functions are the float64 host oracles used by ``judge_np`` and
the tests.
"""
from __future__ import annotations

import math

import numpy as np
import torch

_EPS = 1e-12


def entropy(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Shannon entropy H(p) = -sum_i p_i log p_i  (paper Eq. 3), nats.

    Zero probabilities contribute zero (lim p->0 of p log p).
    """
    plogp = torch.where(p > 0, p * torch.log(p.clamp(min=_EPS)),
                        torch.zeros((), dtype=p.dtype, device=p.device))
    return -plogp.sum(dim=dim)


def entropy_np(p: np.ndarray, axis: int = -1) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    plogp = np.where(p > 0, p * np.log(np.clip(p, _EPS, None)), 0.0)
    return -np.sum(plogp, axis=axis)


def masked_soft_label_mean(soft_labels: torch.Tensor, sizes: torch.Tensor,
                           mask: torch.Tensor) -> torch.Tensor:
    """Size-weighted mean soft label over the active device set (Eq. 4 inner).

    soft_labels: (M, C); sizes: (M,); mask: (M,) float/bool.
    Returns the (C,) distribution; an empty mask gives the uniform (max
    entropy) distribution, so an empty set is never preferred by the
    greedy judgment.
    """
    w = sizes * mask
    tot = w.sum()
    mean = (w @ soft_labels) / tot.clamp(min=_EPS)
    uniform = torch.full_like(mean, 1.0 / soft_labels.shape[-1])
    return torch.where(tot > 0, mean, uniform)


def group_entropy(soft_labels: torch.Tensor, sizes: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """getEntropy(P, L) of paper Eq. 4 for the active set given by ``mask``."""
    return entropy(masked_soft_label_mean(soft_labels, sizes, mask))


def leave_one_out_entropies(soft_labels: torch.Tensor, sizes: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Entropy of the active set with device k removed, for every k. (M,).

    Computed from the full weighted sum by subtracting each member's
    contribution, so the sweep is O(M*C). For k outside the active set the
    value is the current group entropy; a removal that would EMPTY the
    active set returns -1.0, so the greedy judgment never empties it.
    """
    w = sizes * mask
    tot = w.sum()
    s = w @ soft_labels                                 # (C,)
    num = s[None, :] - w[:, None] * soft_labels         # (M, C)
    den = (tot - w).clamp(min=_EPS)[:, None]
    ent = entropy(num / den, dim=-1)
    return torch.where(tot - w > _EPS, ent, torch.full_like(ent, -1.0))


# ---------------------------------------------------------------- numpy refs

def group_entropy_np(soft_labels: np.ndarray, sizes: np.ndarray,
                     mask: np.ndarray) -> float:
    w = np.asarray(sizes, np.float64) * np.asarray(mask, np.float64)
    tot = w.sum()
    if tot <= 0:
        return float(math.log(soft_labels.shape[-1]))
    mean = (w[:, None] * soft_labels).sum(axis=0) / tot
    return float(entropy_np(mean))
