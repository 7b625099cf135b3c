"""Blockwise (flash) attention: wrapper of ``csrc/flash_attention.cu`` (K3).

Online-softmax attention over q (B, S, H, D) and k, v (B, T, KH, D) with
causal and sliding-window masks and GQA (q head h reads kv head
h // (H / KH)), f32 or bf16 in, f32 accumulation; any D <= 256. Queries
sit at positions 0..S-1 and keys at 0..T-1 (S != T is allowed when not
causal), so ``q_offset`` and ``kv_positions`` have no place here: the
prefill path gives none.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`.ref.mha_reference`.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import bind, counted, launch, refuse_autograd

_KERNELS = {torch.float32: "flash_attention_f32",
            torch.bfloat16: "flash_attention_bf16"}
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 8 + (
    ctypes.c_float, ctypes.c_void_p)
MAX_HEAD_DIM = 256


@counted
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: float | None = None) -> torch.Tensor:
    """Returns (B, S, H, D) in q's dtype."""
    refuse_autograd("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, window=window,
                                 scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.dtype not in _KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, S, H, D) and k, v "
                         f"(B, T, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh < 1 or h % kh:
        raise ValueError(f"flash_attention: k, v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if min(b, s, t, d) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: needs non-empty shapes and "
                         f"D <= {MAX_HEAD_DIM}, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    launch(bind("flash_attention", _KERNELS[q.dtype], _ARGTYPES),
           q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), b, s, t, h, kh, d, int(causal), int(window),
           float(scale))
    flash_attention.launches += 1
    return out
