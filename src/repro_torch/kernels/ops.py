"""Kernel entry points with backend dispatch.

backend="torch"     — the plain PyTorch versions in :mod:`.ref` (any
                      device).
backend="blockwise" — the "torch" route, but attention over more than
                      512 keys goes to :func:`.ref.mha_blockwise`
                      (key blocks with an online softmax, each
                      recomputed in the backward: the reference's
                      memory-bounded route for training); plain PyTorch
                      too, as the reference's is plain XLA.
backend="cuda"      — the hand-written CUDA kernels; on a CUDA tensor the
                      kernel launches or raises, and only a CPU tensor
                      takes the plain version.

The route is an argument of every call: the LM modules receive it from
``build_model(..., kernels=...)``, the FL judge and aggregator from their
own ``backend``. There is no global default: ``build_model(...,
kernels="blockwise")`` stands for the reference's
``set_default_backend("blockwise")``.

The ``"cuda"`` routes of attention (K3, K4) and the SSD scan (K5) have no
backward: the wrappers fill an output buffer through a C call, which
autograd cannot see, and the JAX package's Pallas kernels define no VJP
either (``jax.grad`` through them fails). So their wrappers, and with
them ``attention`` and ``ssd`` on the ``"cuda"`` route, raise whenever
autograd would record through them (grad mode on and an input that
requires grad), on any device (``_build.refuse_autograd``), rather than
hand back an output that silently cuts the gradient. Training runs
on the ``"torch"`` or ``"blockwise"`` route; serving (under
``inference_mode``) and the FL kernels (detached inputs) are
unaffected.
"""
from __future__ import annotations

from . import ref

BACKENDS = ("torch", "blockwise", "cuda")


def _check(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown kernel backend {backend!r}; "
                         f"expected one of {BACKENDS}")


def attention(q, k, v, *, causal=True, window=0, q_offset=0,
              kv_positions=None, scale=None, backend="torch"):
    """Grouped-query attention, (B, S, H, D) queries against (B, T, KH, D)
    keys and values.

    On the ``"cuda"`` route a query of one token against a tagged cache
    (``kv_positions`` given) goes to the decode kernel (K4) with
    ``q_offset`` as the current position of each row; anything else goes
    to the flash kernel (K3), which places queries at 0..S-1 and keys at
    0..T-1 and so refuses a ``q_offset`` or ``kv_positions`` it cannot
    honour. The ``"blockwise"`` route takes :func:`.ref.mha_blockwise`
    when there are more than ``ref.BLOCK_K`` keys, the reference's rule.
    """
    _check(backend)
    if backend == "cuda":
        if kv_positions is not None:
            if q.shape[1] != 1:
                raise ValueError("attention: the cuda route takes "
                                 "kv_positions only for one query token "
                                 f"(decode), got S={q.shape[1]}")
            from .decode_attention import decode_attention
            return decode_attention(q, k, v, kv_positions, q_offset,
                                    window=window, scale=scale)
        if not (isinstance(q_offset, int) and q_offset == 0):
            raise ValueError("attention: the cuda route's flash kernel "
                             "places queries at 0..S-1 and cannot honour "
                             f"q_offset={q_offset!r}")
        from .flash_attention import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    if backend == "blockwise" and k.shape[1] > ref.BLOCK_K:
        return ref.mha_blockwise(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset,
                                 kv_positions=kv_positions, scale=scale)
    return ref.mha_reference(q, k, v, causal=causal, window=window,
                             q_offset=q_offset, kv_positions=kv_positions,
                             scale=scale)


def ssd(x, dt, a, b_mat, c_mat, *, chunk=256, init_state=None,
        backend="torch"):
    """Mamba2 SSD over (B, L, H, P) inputs; returns (y, final state).

    The ``"cuda"`` route is the chunk-scan kernel (K5), which starts from
    a zero state only. The ``"torch"`` route takes the exact sequential
    step for one token and the chunked plain version otherwise.
    """
    _check(backend)
    if backend == "cuda":
        from .ssd_scan import ssd_chunked
        return ssd_chunked(x, dt, a, b_mat, c_mat, chunk=chunk,
                           init_state=init_state)
    if x.shape[1] == 1:
        return ref.ssd_reference(x, dt, a, b_mat, c_mat,
                                 init_state=init_state)
    return ref.ssd_chunked_reference(x, dt, a, b_mat, c_mat, chunk=chunk,
                                     init_state=init_state)


def entropy_judge_sweep(soft_labels, sizes, mask, *, backend="torch"):
    _check(backend)
    if backend == "cuda":
        from .entropy_judge import entropy_judge_sweep
        return entropy_judge_sweep(soft_labels, sizes, mask)
    return ref.entropy_judge_sweep_reference(soft_labels, sizes, mask)


def entropy_judge_loop(soft_labels, sizes, active=None, protected=None,
                       cap=None, *, backend="torch"):
    """Alg. 1's greedy loop; returns the packed buffer of
    :func:`.ref.unpack_judgment`. The ``"cuda"`` route is one launch of
    the loop kernel (K1)."""
    _check(backend)
    if backend == "cuda":
        from .entropy_judge import entropy_judge_loop
        return entropy_judge_loop(soft_labels, sizes, active, protected, cap)
    return ref.entropy_judge_loop_reference(soft_labels, sizes, active,
                                            protected, cap)


def masked_weighted_sum(flat, weights, *, backend="torch"):
    _check(backend)
    if backend == "cuda":
        from .fused_aggregate import masked_weighted_sum
        return masked_weighted_sum(flat, weights)
    return ref.masked_weighted_sum_reference(flat, weights)
