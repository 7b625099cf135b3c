"""Weights carried between the JAX package's models and the port's.

The LM: the JAX package stacks the layers of a model on a leading axis
(``layers``: (L, ...); the hybrid ``ssm_layers``: (groups, per, ...));
the port keeps one module per layer under the same names, so
:func:`lm_params_from_numpy` unstacks each leaf into ``layers.<i>.<path>``
or ``ssm_layers.<g>.<j>.<path>``, a state dict for the port's
``Transformer``.

The CNN: ``repro.models.cnn`` keeps convolutions in HWIO and dense layers as
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


def lm_params_from_numpy(cfg, tree: dict) -> dict[str, torch.Tensor]:
    """``repro.models.transformer`` params of ``cfg`` as numpy arrays -> a
    state dict of the port's ``Transformer`` (float32 CPU tensors; loading
    casts them to the model's parameter dtype and device). Raises if a
    stacked subtree's leading axes are not ``cfg``'s layer counts."""
    stacked = {"layers": (cfg.num_layers,)}
    if cfg.attn_every:
        stacked["ssm_layers"] = (cfg.num_layers // cfg.attn_every,
                                 cfg.attn_every - 1)
    out: dict[str, torch.Tensor] = {}

    def put(prefix: str, node, index: tuple) -> None:
        if isinstance(node, dict):
            for key, child in node.items():
                put(f"{prefix}.{key}", child, index)
            return
        arr = np.asarray(node, np.float32)[index]
        out[prefix] = torch.tensor(arr)

    for name, sub in tree.items():
        if name not in stacked:
            put(name, sub, ())
            continue
        shape = np.shape(_first_leaf(sub))[:len(stacked[name])]
        if shape != stacked[name]:
            raise ValueError(f"{name}: stacked axes {shape}, but {cfg.name} "
                             f"has {stacked[name]}")
        for index in np.ndindex(*shape):
            put(".".join([name, *map(str, index)]), sub, index)
    return out


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node
