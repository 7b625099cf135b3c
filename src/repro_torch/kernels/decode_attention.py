"""Single-query (decode) attention: wrapper of ``csrc/decode_attention.cu``
(K4).

One new token per row, q (B, 1, H, D), against a position-tagged KV cache
k, v (B, T, KH, D) with tags (B, T) int32 (-1 = empty slot). A slot is
seen when 0 <= tag <= index[b] and, with a window, tag > index[b] -
window. ``index`` is the current position per row, (B,) or a scalar, as
the reference's ``q_offset``: the Pallas route's batch-wide
``max(kv_positions)`` agrees with it only when every row shares one index.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`.ref.mha_reference` with ``q_offset=index``.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import bind, counted, launch, refuse_autograd

_KERNELS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16"}
MAX_HEAD_DIM = 256
# query heads one block serves; a larger group H / KH is split over
# ceil(g / HEADS_PER_BLOCK) blocks, each reading its kv head's cache
HEADS_PER_BLOCK = 8

_ARGTYPES = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (
    ctypes.c_float, ctypes.c_void_p)


@counted
def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_positions: torch.Tensor,
                     index: torch.Tensor | int, *, window: int = 0,
                     scale: float | None = None) -> torch.Tensor:
    """Returns (B, 1, H, D) in q's dtype."""
    refuse_autograd("decode_attention", q, k, v)
    b = q.shape[0]
    if q.device.type == "cpu":
        off = torch.as_tensor(index).reshape(-1, 1)
        return ref.mha_reference(q, k, v, causal=True, window=window,
                                 q_offset=off, kv_positions=kv_positions,
                                 scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dtype not in _KERNELS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: q, k, v must all be float32 or "
                        f"all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: q must be (B, 1, H, D) and "
                         f"k, v (B, T, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    _, _, h, d = q.shape
    t, kh = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kh < 1 or h % kh:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if min(b, t, d) < 1 or d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: needs non-empty shapes and "
                         f"D <= {MAX_HEAD_DIM}, got q {tuple(q.shape)}, "
                         f"cache {tuple(k.shape)}")
    if kv_positions.shape != (b, t) or kv_positions.dtype != torch.int32:
        raise ValueError(f"decode_attention: kv_positions must be int32 "
                         f"({b}, {t}), got {kv_positions.dtype} "
                         f"{tuple(kv_positions.shape)}")
    idx = torch.as_tensor(index, device=q.device)
    if idx.dtype not in (torch.int32, torch.int64) or idx.numel() not in (
            1, b):
        raise ValueError(f"decode_attention: index must be an integer "
                         f"scalar or ({b},), got {idx.dtype} "
                         f"{tuple(idx.shape)}")
    idx = idx.to(torch.int32).reshape(-1).expand(b).contiguous()
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and kv_positions.is_contiguous()):
        raise ValueError("decode_attention: q, k, v and kv_positions must "
                         "be contiguous")
    if not (q.device == k.device == v.device == kv_positions.device):
        raise ValueError("decode_attention: inputs on different devices")
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    launch(bind("decode_attention", _KERNELS[q.dtype], _ARGTYPES),
           q.get_device(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
           kv_positions.data_ptr(), idx.data_ptr(), out.data_ptr(), b, t, h,
           kh, d, int(window), float(scale))
    decode_attention.launches += 1
    return out
