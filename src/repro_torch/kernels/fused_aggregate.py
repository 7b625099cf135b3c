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
import functools

import torch

from . import ref
from ._build import load


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load("fused_aggregate")
    fn = lib.masked_weighted_sum_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def masked_weighted_sum(flat: torch.Tensor, weights: torch.Tensor, *,
                        block: int = 256) -> torch.Tensor:
    """Returns (P,) float32 = sum_i weights[i] * flat[i, :].

    flat: (M, P) float32, contiguous; weights: (M,). ``block`` is the
    number of threads per block (a multiple of 32, at most 1024).
    """
    if flat.device.type == "cpu":
        return ref.masked_weighted_sum_reference(flat, weights)
    if flat.device.type != "cuda":
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
    m, p = flat.shape
    w = weights.to(flat.device, torch.float32).contiguous()
    if w.shape != (m,):
        raise ValueError(f"masked_weighted_sum: weights must be ({m},), "
                         f"got {tuple(w.shape)}")
    out = torch.empty(p, dtype=torch.float32, device=flat.device)
    if p == 0:
        return out
    with torch.cuda.device(flat.device):
        stream = torch.cuda.current_stream(flat.device).cuda_stream
        err = _lib().masked_weighted_sum_f32(
            flat.data_ptr(), w.data_ptr(), out.data_ptr(), m, p, block,
            stream)
    if err != 0:
        raise RuntimeError(f"fused_aggregate kernel launch failed: CUDA "
                           f"error {err}")
    masked_weighted_sum.launches += 1
    return out


masked_weighted_sum.launches = 0   # kernel launches, for the chip smoke
