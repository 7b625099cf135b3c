"""Weights carried between the JAX package's CNN and the port's.

``repro.models.cnn`` keeps convolutions in HWIO and dense layers as
(in, out); the port keeps convolutions in OIHW and dense layers as
(in, out). Both flatten the last feature map in (h, w, c) order before
fc1 (the port permutes its channels-last map back before the flatten),
so fc1's rows need no permutation. Arrays cross as numpy, so neither
package imports the other.
"""
from __future__ import annotations

import numpy as np
import torch

_CONVS = ("conv1", "conv2")


def cnn_params_from_numpy(tree: dict) -> dict:
    """``repro.models.cnn`` params as numpy arrays -> the port's params
    (float32 CPU tensors)."""
    out = {}
    for layer, p in tree.items():
        w = np.array(p["w"], np.float32)
        if layer in _CONVS:
            w = w.transpose(3, 2, 0, 1)                  # HWIO -> OIHW
        out[layer] = {"w": torch.from_numpy(np.ascontiguousarray(w)),
                      "b": torch.from_numpy(np.array(p["b"], np.float32))}
    return out


def cnn_params_to_numpy(params: dict) -> dict:
    """The port's params -> ``repro.models.cnn`` layout as numpy arrays."""
    out = {}
    for layer, p in params.items():
        w = p["w"].detach().cpu().numpy()
        if layer in _CONVS:
            w = w.transpose(2, 3, 1, 0)                  # OIHW -> HWIO
        out[layer] = {"w": np.ascontiguousarray(w),
                      "b": p["b"].detach().cpu().numpy()}
    return out
