"""Maximum-entropy judgment sweep: wrapper of ``csrc/entropy_judge.cu``.

One greedy iteration of Algorithm 1 in one call: the weighted group
entropy of the active set (Eq. 3/4) and all M leave-one-out entropies,
in a single pass over the class axis. Semantics follow
``core.entropy``: a removal that empties the set gives -1.0, an empty
active set gives ln C.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`.ref.entropy_judge_sweep_reference`.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import ref
from ._build import bind, launch

_EPS = 1e-12
_BLOCK_C = 1024         # classes per thread block (shared memory: 4 KB)
_KERNELS = {torch.float32: "entropy_judge_sweep_f32",
            torch.bfloat16: "entropy_judge_sweep_bf16"}

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def entropy_judge_sweep(soft_labels: torch.Tensor, sizes: torch.Tensor,
                        mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (group_entropy (), leave_one_out (M,)), float32.

    soft_labels: (M, C) float32 or bfloat16, contiguous; sizes and mask:
    (M,).
    """
    if soft_labels.device.type == "cpu":
        return ref.entropy_judge_sweep_reference(soft_labels, sizes, mask)
    if soft_labels.device.type != "cuda":
        raise ValueError(f"entropy_judge_sweep: unsupported device "
                         f"{soft_labels.device}")
    if soft_labels.dtype not in _KERNELS:
        raise TypeError(f"entropy_judge_sweep: soft labels must be float32 "
                        f"or bfloat16, got {soft_labels.dtype}")
    if soft_labels.dim() != 2 or min(soft_labels.shape) < 1:
        raise ValueError(f"entropy_judge_sweep: soft labels must be a "
                         f"non-empty (M, C), got {tuple(soft_labels.shape)}")
    if not soft_labels.is_contiguous():
        raise ValueError("entropy_judge_sweep: soft labels must be "
                         "contiguous")
    m, c = soft_labels.shape
    dev = soft_labels.device
    w = (sizes.to(dev, torch.float32) * mask.to(dev, torch.float32)
         ).contiguous()
    if w.shape != (m,):
        raise ValueError(f"entropy_judge_sweep: sizes and mask must be "
                         f"({m},), got {tuple(w.shape)}")
    tot = w.sum().reshape(1)
    den = (tot - w).clamp(min=_EPS)
    nblocks = -(-c // _BLOCK_C)
    partial = torch.empty((nblocks, m + 1), dtype=torch.float32, device=dev)
    out = torch.empty(m + 1, dtype=torch.float32, device=dev)
    launch(bind("entropy_judge", _KERNELS[soft_labels.dtype], _ARGTYPES),
           soft_labels.get_device(), soft_labels.data_ptr(), w.data_ptr(),
           tot.data_ptr(), den.data_ptr(), partial.data_ptr(),
           out.data_ptr(), m, c, _BLOCK_C)
    entropy_judge_sweep.launches += 1
    ent = torch.where(tot[0] > 0, out[0], math.log(c))
    loo = torch.where(tot - w > _EPS, out[1:], -1.0)
    return ent, loo


entropy_judge_sweep.launches = 0   # kernel launches, for the chip smoke
