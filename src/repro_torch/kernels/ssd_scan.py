"""Mamba2 SSD chunk scan: wrapper of ``csrc/ssd_scan.cu`` (K5).

x (B, L, H, P), dt (B, L, H) post-softplus, a (H,) negative decay rates,
b_mat / c_mat (B, L, G, N) shared per head group; the recurrence runs
from a zero state in chunks of ``min(chunk, L)`` steps, a ragged tail with
dt = 0. Returns (y (B, L, H, P) in x's dtype, final state (B, H, P, N)
float32). x, b_mat, c_mat are float32 or bfloat16; dt and a are taken in
float32, as the TPU kernel does.

A CUDA tensor launches the kernels (or raises); a CPU tensor takes the
plain version, :func:`.ref.ssd_chunked_reference`. One call launches three
kernels in stream order (the chunk states, the state pass over the chunks,
the chunk outputs; :func:`.ref.ssd_chunk_passes_reference` is the same
decomposition in plain PyTorch), with three float32 scratch tensors: the
chunk states (B, H, nc, P, N), nc = ceil(L / chunk), their decays
(B, H, nc), and the scores C B^T of each chunk and head group
(B, nc, G, Qp, Qp), Qp = chunk rounded up to 64, which the group's heads
share.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import ref
from ._build import bind, counted, launch, load, refuse_autograd

_KERNELS = {torch.float32: "ssd_chunk_scan_f32",
            torch.bfloat16: "ssd_chunk_scan_bf16"}
MAX_SMEM_BYTES = 232448        # shared memory a block may use on an H100
_ARGTYPES = ((ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 7 +
             (ctypes.c_void_p,))
LAUNCHES_PER_CALL = 3          # kernels one call launches


@functools.cache
def _smem_bytes():
    fn = load("ssd_scan").ssd_chunk_scan_smem_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_longlong
    return fn


@counted
def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, *,
                chunk: int = 256, init_state=None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    assert init_state is None, "ssd_chunked kernel assumes zero init state"
    refuse_autograd("ssd_chunked", x, dt, a, b_mat, c_mat)
    if x.device.type == "cpu":
        return ref.ssd_chunked_reference(x, dt, a, b_mat, c_mat, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunked: unsupported device {x.device}")
    if x.dtype not in _KERNELS or b_mat.dtype != x.dtype or \
            c_mat.dtype != x.dtype:
        raise TypeError(f"ssd_chunked: x, b_mat, c_mat must all be float32 "
                        f"or all bfloat16, got {x.dtype}, {b_mat.dtype}, "
                        f"{c_mat.dtype}")
    if x.dim() != 4 or b_mat.dim() != 4 or b_mat.shape != c_mat.shape:
        raise ValueError(f"ssd_chunked: x must be (B, L, H, P) and b_mat, "
                         f"c_mat (B, L, G, N), got {tuple(x.shape)}, "
                         f"{tuple(b_mat.shape)}, {tuple(c_mat.shape)}")
    bsz, l, h, p = x.shape
    g, n = b_mat.shape[2], b_mat.shape[3]
    if b_mat.shape[:2] != (bsz, l) or g < 1 or h % g or \
            dt.shape != (bsz, l, h) or a.shape != (h,):
        raise ValueError(f"ssd_chunked: shapes do not fit: x "
                         f"{tuple(x.shape)}, dt {tuple(dt.shape)}, a "
                         f"{tuple(a.shape)}, b_mat {tuple(b_mat.shape)}")
    if min(bsz, l, p, n, chunk) < 1:
        raise ValueError("ssd_chunked: needs non-empty shapes and chunk > 0")
    if not all(t.device == x.device for t in (dt, a, b_mat, c_mat)):
        raise ValueError("ssd_chunked: inputs on different devices")
    dt = dt.to(torch.float32).contiguous()
    a = a.to(torch.float32).contiguous()
    if not (x.is_contiguous() and b_mat.is_contiguous() and
            c_mat.is_contiguous()):
        raise ValueError("ssd_chunked: x, b_mat, c_mat must be contiguous")
    q = min(chunk, l)
    smem = _smem_bytes()(p, n, q)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"ssd_chunked: P={p}, N={n}, chunk={q} need "
                         f"{smem} bytes of shared memory, more than a "
                         f"block has ({MAX_SMEM_BYTES})")
    nc, qp = -(-l // q), -(-q // 64) * 64
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    state = torch.empty((bsz, h, p, n), **f32)
    states = torch.empty((bsz, h, nc, p, n), **f32)
    decay = torch.empty((bsz, h, nc), **f32)
    scores = torch.empty((bsz, nc, g, qp, qp), **f32)
    launch(bind("ssd_scan", _KERNELS[x.dtype], _ARGTYPES), x.get_device(),
           x.data_ptr(), dt.data_ptr(), a.data_ptr(), b_mat.data_ptr(),
           c_mat.data_ptr(), y.data_ptr(), state.data_ptr(),
           states.data_ptr(), decay.data_ptr(), scores.data_ptr(), bsz, l, h,
           p, g, n, q)
    ssd_chunked.launches += LAUNCHES_PER_CALL
    return y, state
