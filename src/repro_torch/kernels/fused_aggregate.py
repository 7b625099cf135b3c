"""Fused masked weighted aggregation: wrapper of ``csrc/fused_aggregate.cu``.

``out[p] = sum_i weights[i] * flat[i, p]`` over a flattened (M, P) float32
client-parameter buffer, accumulated in float32 in one launch. The
weights already fold ``sizes * mask``; the caller divides by their total
(``core.aggregation.fused_aggregate``).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`.ref.masked_weighted_sum_reference`.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import bind, counted, launch

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_int, ctypes.c_void_p)
BLOCK = 128  # threads per block: at P = 62,006, 243 blocks on 132 SMs


def _fn():
    return bind("fused_aggregate", "masked_weighted_sum_f32", _ARGTYPES)


def _checked(flat: torch.Tensor, weights: torch.Tensor, block: int):
    """The wrapper's checks on a CUDA ``flat``: returns the weights as a
    float32 (M,) on flat's device (as given when they already are). Each
    check reads plain attributes, so a call costs little host time."""
    if not flat.is_cuda:
        raise ValueError(f"masked_weighted_sum: unsupported device "
                         f"{flat.device}")
    if flat.dtype != torch.float32 or flat.dim() != 2:
        raise TypeError(f"masked_weighted_sum: flat must be a float32 "
                        f"(M, P), got {flat.dtype} {tuple(flat.shape)}")
    if not flat.is_contiguous():
        raise ValueError("masked_weighted_sum: flat must be contiguous")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"masked_weighted_sum: block={block} must be a "
                         "multiple of 32 in [32, 1024]")
    w = weights
    if not (w.dtype == torch.float32 and w.is_contiguous()
            and w.get_device() == flat.get_device()):
        w = w.to(flat.device, torch.float32).contiguous()
    if w.dim() != 1 or w.numel() != flat.size(0):
        raise ValueError(f"masked_weighted_sum: weights must be "
                         f"({flat.size(0)},), got {tuple(w.shape)}")
    return w


@counted
def masked_weighted_sum(flat: torch.Tensor, weights: torch.Tensor, *,
                        block: int = BLOCK) -> torch.Tensor:
    """Returns (P,) float32 = sum_i weights[i] * flat[i, :].

    flat: (M, P) float32, contiguous; weights: (M,). ``block`` is the
    number of threads per block (a multiple of 32, at most 1024).
    """
    if not flat.is_cuda and flat.device.type == "cpu":
        return ref.masked_weighted_sum_reference(flat, weights)
    w = _checked(flat, weights, block)
    m, p = flat.shape
    out = flat.new_empty(p)
    if p == 0:
        return out
    launch(_fn(), flat.get_device(), flat.data_ptr(), w.data_ptr(),
           out.data_ptr(), m, p, block)
    masked_weighted_sum.launches += 1
    return out
