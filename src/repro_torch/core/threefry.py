"""Threefry-2x32, the counter-based generator behind ``jax.random``, on
tensors.

The traced eps-greedy pools (:func:`repro_torch.core.pools.pools_draw`)
and the scan engine's device selection draw on this stream, so a seed
selects the same cohorts in both packages. The functions mirror the
stream of JAX's default, partitionable threefry
(``jax_threefry_partitionable`` True, the default from jax 0.5.0 on):

* :func:`prng_key` is ``jax.random.PRNGKey(seed)``: ``[0, seed]``;
* :func:`split` is ``jax.random.split``: threefry of the key over the
  counters ``(hi = 0, lo = arange(n))``, one new key per counter;
* :func:`random_bits` is ``jax.random.bits(key, (n,), uint32)``: the XOR
  of threefry's two output words over the same counters;
* :func:`uniform` is ``jax.random.uniform(key)`` in float32: the top 23
  bits as the mantissa of a float in [1, 2), minus 1;
* :func:`permutation` is ``jax.random.permutation(key, n)``: ``_shuffle``'s
  rounds of sorting by fresh 32-bit keys.

A key is a (2,) int64 tensor that holds two uint32 words. Every add,
rotate and XOR is masked to 32 bits in int64 arithmetic (``torch.uint32``
lacks CUDA kernels for several of these ops), so the same code runs on
the CPU, on the card and inside a CUDA graph, and reads nothing back to
the host. One difference from ``jax.random.permutation``: it sorts with
``lax.sort_key_val``, which is not stable, where this sort is; the two
part only where two of the n 32-bit sort keys tie (about n² / 2³³ likely
per round).
"""
from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: ``[0, seed]`` for a seed in the int32
    range (as JAX without x64 holds it), ``[seed >> 32, seed & MASK]``
    beyond it."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & MASK
    return torch.tensor([hi, seed & MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0, k1, x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (JAX's ``threefry2x32_p``) of the key
    words ``k0``, ``k1`` (0-d int64 tensors) over the counter words ``x0``,
    ``x1`` (int64 tensors of one shape, each value below 2³²). Returns the
    two output words as int64 tensors of that shape."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _counters(key: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    return threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)


def split(key: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(key, n)``: (n, 2) int64, one key per row."""
    return torch.stack(_counters(key, n), dim=1)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), jnp.uint32)``: (n,) int64 holding
    uint32 values."""
    b0, b1 = _counters(key, n)
    return b0 ^ b1


def uniform(key: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)``: a 0-d float32 tensor in [0, 1)."""
    bits = random_bits(key, 1)[0]
    one = (bits >> 9) | 0x3F800000
    # below 2**31, so the int32 cast keeps the bits for the float view
    return one.to(torch.int32).view(torch.float32) - 1.0


def shuffle_rounds(n: int) -> int:
    """``_shuffle``'s number of sort rounds for n items:
    ``ceil(3 ln n / ln(2³² - 1))``; 1 below about 1,600 items."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(MASK)))


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: (n,) int64, each round splitting
    the key and sorting by fresh 32-bit keys (stably, see the module
    note)."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    for _ in range(shuffle_rounds(n)):
        key, sub = split(key)
        order = torch.argsort(random_bits(sub, n), stable=True)
        x = x[order]
    return x
