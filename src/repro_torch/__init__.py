"""PyTorch / CUDA port of the FedEntropy reproduction (``repro``).

Mirrors the JAX package's module layout; runs on an NVIDIA H100 with
hand-written CUDA kernels (``repro_torch.kernels``) for the judgment
sweep and the fused aggregation. Imports neither ``jax`` nor ``repro``.
"""
