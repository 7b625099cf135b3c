"""Maximum-entropy judgment: wrappers of ``csrc/entropy_judge.cu``.

:func:`entropy_judge_sweep` is one greedy iteration of Algorithm 1 in one
call: the weighted group entropy of the active set (Eq. 3/4) and all M
leave-one-out entropies, in a single pass over the class axis. A removal
that empties the set gives -1.0, an empty active set gives ln C; the
kernel applies both conventions itself.

:func:`entropy_judge_loop` is the whole greedy loop of Algorithm 1 in one
launch, as ``repro.core.judgment.judge`` runs it inside one jitted
``while_loop``: one warp at the paper's shape, else one thread-block
cluster whose CTAs split the class axis and meet at ``cluster.sync()``
once per iteration (:func:`loop_kernel`). It returns one packed float32
buffer (:func:`.ref.unpack_judgment` splits it).

A CUDA tensor launches the kernel (or raises); a CPU tensor takes the
plain version, :func:`.ref.entropy_judge_sweep_reference` or
:func:`.ref.entropy_judge_loop_reference`.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from ._build import bind, counted, launch

_BLOCK_C = 1024         # classes per block of the sweep: one launch up to it
_CLASSES_PER_CTA = 1024  # the loop's cluster grows by powers of two above it
MAX_CLUSTER = 16        # H100's non-portable cluster size limit
_SWEEP = {torch.float32: "entropy_judge_sweep_f32",
          torch.bfloat16: "entropy_judge_sweep_bf16"}
_SWEEP_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
                   + (ctypes.c_void_p,))
_LOOP_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4
                  + (ctypes.c_void_p,))
_WARP_ARGTYPES = ((ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 3
                  + (ctypes.c_void_p,))
WARP_LIMIT = 32         # C and M up to this: the loop runs in one warp


def _sweep_fn(dtype: torch.dtype):
    return bind("entropy_judge", _SWEEP[dtype], _SWEEP_ARGTYPES)


def _loop_fn(warp: bool):
    if warp:
        return bind("entropy_judge", "entropy_judge_loop_warp_f32",
                    _WARP_ARGTYPES)
    return bind("entropy_judge", "entropy_judge_loop_f32", _LOOP_ARGTYPES)


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


def _checked(soft_labels, sizes, mask):
    """The sweep's checks on a CUDA tensor: returns sizes and mask as
    float32 (M,) on its device."""
    _check_labels(soft_labels, _SWEEP)
    m = soft_labels.shape[0]
    return (_vector(sizes, soft_labels, m, "sizes"),
            _vector(mask, soft_labels, m, "mask"))


@counted
def entropy_judge_sweep(soft_labels: torch.Tensor, sizes: torch.Tensor,
                        mask: torch.Tensor
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (group_entropy (), leave_one_out (M,)), float32 views of
    one buffer.

    soft_labels: (M, C) float32 or bfloat16, contiguous; sizes and mask:
    (M,). One launch when C <= 1024 (the paper's shape), else a partial
    pass and a one-block finalize.
    """
    if soft_labels.device.type == "cpu":
        return ref.entropy_judge_sweep_reference(soft_labels, sizes, mask)
    sizes, mask = _checked(soft_labels, sizes, mask)
    m, c = soft_labels.shape
    nblocks = -(-c // _BLOCK_C)
    scratch = nblocks * (m + 1) if nblocks > 1 else 0
    buf = torch.empty(m + 1 + scratch, dtype=torch.float32,
                      device=soft_labels.device)
    out = buf.data_ptr()
    launch(_sweep_fn(soft_labels.dtype), soft_labels.get_device(),
           soft_labels.data_ptr(), sizes.data_ptr(), mask.data_ptr(),
           out + 4 * (m + 1) if scratch else None, out, m, c, _BLOCK_C)
    entropy_judge_sweep.launches += 1
    return buf[0], buf[1:m + 1]


def cluster_size(c: int) -> int:
    """CTAs in the loop's cluster for C classes: one up to 1024 classes,
    then the power of two that gives each CTA at most 1024, up to 16
    (C = 151,936 takes 16)."""
    g = 1
    while g < MAX_CLUSTER and g * _CLASSES_PER_CTA < c:
        g *= 2
    return g


def loop_kernel(m: int, c: int, cluster: int | None = None
                ) -> tuple[str, int]:
    """(kernel, CTAs) of the loop at (M, C): ("warp", 1) at the paper's
    shape (C and M at most 32, no cluster size forced), else ("cluster",
    the forced size or :func:`cluster_size`)."""
    if cluster is None and m <= WARP_LIMIT and c <= WARP_LIMIT:
        return "warp", 1
    return "cluster", cluster_size(c) if cluster is None else int(cluster)


@counted
def entropy_judge_loop(soft_labels: torch.Tensor, sizes: torch.Tensor,
                       active: torch.Tensor | None = None,
                       protected: torch.Tensor | None = None,
                       cap: int | None = None, *,
                       _cluster: int | None = None) -> torch.Tensor:
    """Algorithm 1's greedy loop in one launch; returns the packed
    (2M + 3,) float32 buffer of :func:`.ref.unpack_judgment`.

    soft_labels: (M, C) float32, contiguous; sizes: (M,); active and
    protected: optional (M,) 0/1 masks (all active, none protected when
    None); cap: at most this many removals (default M - 1). The host reads
    nothing: the result stays on the card. One warp runs the loop at the
    paper's shape, one thread-block cluster above it (:func:`loop_kernel`).
    ``_cluster`` forces the cluster kernel with that many CTAs (1-16, for
    the card tests); a cluster the card cannot place raises.
    """
    if soft_labels.device.type == "cpu":
        return ref.entropy_judge_loop_reference(soft_labels, sizes, active,
                                                protected, cap)
    _check_labels(soft_labels, (torch.float32,))
    m, c = soft_labels.shape
    sizes = _vector(sizes, soft_labels, m, "sizes")
    active = _vector(active, soft_labels, m, "active")
    protected = _vector(protected, soft_labels, m, "protected")
    kernel, cluster = loop_kernel(m, c, _cluster)
    if not 1 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"entropy_judge_loop: cluster of {cluster} CTAs; "
                         f"1 to {MAX_CLUSTER} can launch")
    out = torch.empty(2 * m + 3, dtype=torch.float32,
                      device=soft_labels.device)
    args = (soft_labels.data_ptr(), sizes.data_ptr(),
            None if active is None else active.data_ptr(),
            None if protected is None else protected.data_ptr(),
            out.data_ptr(), m, c,
            m - 1 if cap is None else min(max(int(cap), 0), m))
    if kernel == "warp":
        launch(_loop_fn(True), soft_labels.get_device(), *args)
    else:
        launch(_loop_fn(False), soft_labels.get_device(), *args, cluster)
    entropy_judge_loop.launches += 1
    return out
