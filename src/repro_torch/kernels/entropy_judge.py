"""Maximum-entropy judgment: wrappers of ``csrc/entropy_judge.cu``.

:func:`entropy_judge_loop` is the whole greedy loop of Algorithm 1 in one
launch, as ``repro.core.judgment.judge`` runs it inside one jitted
``while_loop``: one CTA of four warps at the paper's shape, else one
cooperative launch whose CTAs split the class axis and meet at one grid
barrier an iteration (:func:`plan`). It returns one packed float32
buffer (:func:`.ref.unpack_judgment` splits it).

:func:`entropy_judge_sweep` is one greedy iteration of Algorithm 1: the
weighted group entropy of the active set (Eq. 3/4) and all M
leave-one-out entropies, in a single pass over the class axis, as one
launch of the same grid kernel. A removal that empties the set gives
-1.0, an empty active set gives ln C; the kernel applies both
conventions itself.

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`.ref.entropy_judge_sweep_reference` or
:func:`.ref.entropy_judge_loop_reference`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import ref
from ._build import bind, counted, launch

WARP_LIMIT = 32         # C and M up to this: the loop's warp route
MAX_CTAS = 132          # the grid's CTAs at most: one an SM of an H100 SXM
SLICE = 1152            # classes a CTA owns until MAX_CTAS are in use
THREADS = 1024          # threads a CTA of the grid kernel (csrc kThreads)
TILE = 2048             # classes a streamed CTA holds s_c for (csrc kTile)
SMEM_LIMIT = 232_448    # bytes of shared memory a block may have on an H100
_SWEEP_DTYPES = (torch.float32, torch.bfloat16)
_GRID_ARGTYPES = ((ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 9
                  + (ctypes.c_void_p,))
_WARP_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
                  + (ctypes.c_void_p,))


class Plan(NamedTuple):
    """How the loop or a sweep runs at (M, C). ``kernel``: "warp" or
    "grid"; ``ctas``: the grid's CTAs, each owning ``slice`` classes (a
    multiple of 4; the last CTA the rest); ``resident``: each CTA loads
    its (M, slice) block of P into shared memory once, else it streams
    the block from device memory every iteration; ``smem``: a CTA's
    dynamic shared memory in bytes."""
    kernel: str
    ctas: int
    slice: int
    resident: bool
    smem: int


def _smem(m: int, slc: int, resident: bool) -> int:
    """Bytes of shared memory a grid CTA takes: the sum of the csrc's
    ``carve`` (48 bytes of barrier and scalars, P's block when resident,
    s over a tile, the warps' partials, acc, the rows' totals and their
    list, five four-byte vectors and two byte vectors of M)."""
    tile = slc if resident else min(TILE, slc)
    words = ((m * slc if resident else 0) + tile
             + (THREADS // 32 + 3) * (m + 1) + 5 * m)
    return 48 + 4 * words + 2 * m


def _slices(c: int, ctas: int) -> tuple[int, int]:
    """(CTAs, slice) that cover C classes with ``ctas`` equal slices, each
    rounded up to a multiple of 4 classes (16 bytes of float32)."""
    slc = -(-c // ctas)
    slc += -slc % 4
    return -(-c // slc), slc


@functools.cache
def plan(m: int, c: int, ctas: int | None = None, *, sweep: bool = False
         ) -> Plan:
    """The launch at (M, C), a function of its arguments alone (never of
    the card it runs on), so a call's bits do not depend on the card.

    The loop takes the warp route (one CTA of four warps) when C and M
    are at most 32 and no CTA count is forced. Otherwise (and for every sweep) the grid kernel runs on
    ceil(C / 1152) CTAs up to 132 (152,064 classes: 132 slices of 1,152;
    151,936: 131 of 1,152 and one of 1,024), the slices widening past
    152,064 classes. ``ctas`` forces a count (the card tests); it must be
    one the slicing gives exactly, 1 to 132, else ValueError. A loop's
    CTA holds its block of P resident when it fits in shared memory; a
    sweep reads P once and streams."""
    if ctas is None and not sweep and m <= WARP_LIMIT and c <= WARP_LIMIT:
        return Plan("warp", 1, c, True, 0)
    if ctas is None:
        n, slc = _slices(c, min(MAX_CTAS, -(-c // SLICE)))
    else:
        n, slc = _slices(c, max(1, ctas))
        if not 1 <= ctas <= MAX_CTAS or n != ctas:
            raise ValueError(f"entropy_judge: {ctas} CTAs at {c} classes; "
                             f"the plan takes 1 to {MAX_CTAS} CTAs of equal "
                             f"slices (a multiple of 4 classes each)")
    resident = not sweep and _smem(m, slc, True) <= SMEM_LIMIT
    smem = _smem(m, slc, resident)
    if smem > SMEM_LIMIT:
        raise ValueError(f"entropy_judge: {m} rows need {smem} bytes of "
                         f"shared memory a CTA; {SMEM_LIMIT} fit")
    return Plan("grid", n, slc, resident, smem)


def _grid_fn():
    return bind("entropy_judge", "entropy_judge_grid", _GRID_ARGTYPES)


def _warp_fn():
    return bind("entropy_judge", "entropy_judge_loop_warp_f32",
                _WARP_ARGTYPES)


def empty_fn():
    """An empty kernel of the same library, launched through the same
    path (``launch(empty_fn(), index)``): the launch floor."""
    return bind("entropy_judge", "entropy_judge_empty", (ctypes.c_void_p,))


def _vector(v: torch.Tensor | None, like: torch.Tensor, m: int, what: str
            ) -> torch.Tensor | None:
    """``v`` as a contiguous float32 (M,) on ``like``'s device (as given
    when it already is one)."""
    if v is None:
        return None
    if not (v.dtype == torch.float32 and v.is_contiguous()
            and v.get_device() == like.get_device()):
        v = v.to(like.device, torch.float32).contiguous()
    if v.shape != (m,):
        raise ValueError(f"entropy_judge: {what} must be ({m},), got "
                         f"{tuple(v.shape)}")
    return v


def _check_labels(soft_labels: torch.Tensor, dtypes) -> None:
    if not soft_labels.is_cuda:
        raise ValueError(f"entropy_judge: unsupported device "
                         f"{soft_labels.device}")
    if soft_labels.dtype not in dtypes:
        raise TypeError(f"entropy_judge: soft labels must be "
                        f"{' or '.join(map(str, dtypes))}, got "
                        f"{soft_labels.dtype}")
    if soft_labels.dim() != 2 or min(soft_labels.shape) < 1:
        raise ValueError(f"entropy_judge: soft labels must be a non-empty "
                         f"(M, C), got {tuple(soft_labels.shape)}")
    if not soft_labels.is_contiguous():
        raise ValueError("entropy_judge: soft labels must be contiguous")


def _grid_args(pl: Plan, sweep: bool, dtype: torch.dtype) -> tuple:
    return (pl.ctas, pl.slice, pl.smem, int(pl.resident), int(sweep),
            int(dtype == torch.bfloat16))


@counted
def entropy_judge_sweep(soft_labels: torch.Tensor, sizes: torch.Tensor,
                        mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (group_entropy (), leave_one_out (M,)), float32 views of
    one buffer.

    soft_labels: (M, C) float32 or bfloat16, contiguous; sizes and mask:
    (M,). One launch of the grid kernel at every C (:func:`plan`).
    """
    if soft_labels.device.type == "cpu":
        return ref.entropy_judge_sweep_reference(soft_labels, sizes, mask)
    _check_labels(soft_labels, _SWEEP_DTYPES)
    m, c = soft_labels.shape
    sizes = _vector(sizes, soft_labels, m, "sizes")
    mask = _vector(mask, soft_labels, m, "mask")
    pl = plan(m, c, sweep=True)
    buf = torch.empty((2 * pl.ctas + 1) * (m + 1), dtype=torch.float32,
                      device=soft_labels.device)
    out = buf.data_ptr()
    launch(_grid_fn(), soft_labels.get_device(), soft_labels.data_ptr(),
           sizes.data_ptr(), mask.data_ptr(), None, out, out + 4 * (m + 1),
           m, c, 0, *_grid_args(pl, True, soft_labels.dtype))
    entropy_judge_sweep.launches += 1
    return buf[0], buf[1:m + 1]


@counted
def entropy_judge_loop(soft_labels: torch.Tensor, sizes: torch.Tensor,
                       active: torch.Tensor | None = None,
                       protected: torch.Tensor | None = None,
                       cap: int | None = None, *,
                       _ctas: int | None = None) -> torch.Tensor:
    """Algorithm 1's greedy loop in one launch; returns the packed
    (2M + 3,) float32 buffer of :func:`.ref.unpack_judgment`.

    soft_labels: (M, C) float32, contiguous; sizes: (M,); active and
    protected: optional (M,) 0/1 masks (all active, none protected when
    None); cap: at most this many removals (default M - 1). The host reads
    nothing: the result stays on the card. Four warps run the loop at the
    paper's shape, the grid kernel above it (:func:`plan`); a grid the
    card cannot hold resident raises (CUDA error 720), never falling back
    to fewer CTAs. ``_ctas`` is for the card tests only: it forces the
    grid kernel on that many CTAs, a count :func:`plan` admits (else
    ValueError, on every device).
    """
    if _ctas is not None:
        pl = plan(*soft_labels.shape, _ctas)
    if soft_labels.device.type == "cpu":
        return ref.entropy_judge_loop_reference(soft_labels, sizes, active,
                                                protected, cap)
    _check_labels(soft_labels, (torch.float32,))
    m, c = soft_labels.shape
    sizes = _vector(sizes, soft_labels, m, "sizes")
    active = _vector(active, soft_labels, m, "active")
    protected = _vector(protected, soft_labels, m, "protected")
    if _ctas is None:
        pl = plan(m, c)
    args = (soft_labels.data_ptr(), sizes.data_ptr(),
            None if active is None else active.data_ptr(),
            None if protected is None else protected.data_ptr())
    cap = m - 1 if cap is None else min(max(int(cap), 0), m)
    n = 2 * m + 3
    if pl.kernel == "warp":
        out = torch.empty(n, dtype=torch.float32, device=soft_labels.device)
        launch(_warp_fn(), soft_labels.get_device(), *args, out.data_ptr(),
               m, c, cap)
    else:
        buf = torch.empty(n + 2 * pl.ctas * (m + 1), dtype=torch.float32,
                          device=soft_labels.device)
        out = buf[:n]
        launch(_grid_fn(), soft_labels.get_device(), *args, buf.data_ptr(),
               buf.data_ptr() + 4 * n, m, c, cap,
               *_grid_args(pl, False, torch.float32))
    entropy_judge_loop.launches += 1
    return out
