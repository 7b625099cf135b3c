"""Weights carried between the JAX package's models and the port's.

The LM: the JAX package stacks the layers of a model on a leading axis
(``layers``: (L, ...); the hybrid ``ssm_layers``: (groups, per, ...); the
encdec family's ``enc_layers`` and ``dec_layers``); the port keeps one
module per layer under the same names, so :func:`lm_params_from_numpy`
unstacks each leaf into ``layers.<i>.<path>`` (the moe family's
``layers.<i>.moe.{router.w, w_in, w_gate, w_out}`` among them),
``ssm_layers.<g>.<j>.<path>`` or ``enc_layers.<i>.<path>`` and
``dec_layers.<i>.<path>``, a state dict for the port's ``Transformer`` or
``EncDec``; every other subtree (``tok``, the norms, the vlm family's
``patch_proj``) is a plain leaf. :func:`lm_params_to_numpy` restacks the
port's weights into the reference's tree.

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
    """``repro.models.transformer`` (or ``encdec``) params of ``cfg`` as
    numpy arrays -> a state dict of the port's model (float32 CPU tensors;
    loading casts them to the model's parameter dtype and device). Raises
    if a stacked subtree's leading axes are not ``cfg``'s layer counts."""
    stacked = _stacked_axes(cfg)
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


def lm_params_to_numpy(cfg, state: dict) -> dict:
    """The inverse of :func:`lm_params_from_numpy`: a state dict (or
    ``Model.params()``) of the port's model -> the JAX package's tree of
    numpy float32 arrays, each ``layers.<i>`` (``ssm_layers.<g>.<j>``,
    ``enc_layers.<i>``, ``dec_layers.<i>``) leaf restacked on the leading
    layer axes. Raises unless every stacked leaf has all of ``cfg``'s
    layers. A round trip through both functions gives the same bits."""
    stacked = _stacked_axes(cfg)
    out: dict = {}
    layers: dict = {}        # name -> subpath -> {index: array}
    for key, t in state.items():
        arr = t.detach().to(torch.float32).cpu().numpy()
        name, *rest = key.split(".")
        if name not in stacked:
            _put_path(out, [name, *rest], arr)
            continue
        n = len(stacked[name])
        index = tuple(int(i) for i in rest[:n])
        layers.setdefault(name, {}).setdefault(tuple(rest[n:]), {})[
            index] = arr
    for name, paths in layers.items():
        want = list(np.ndindex(*stacked[name]))
        for path, by_index in paths.items():
            if sorted(by_index) != want:
                raise ValueError(
                    f"{name}.{'.'.join(path)}: layers "
                    f"{sorted(by_index)}, but {cfg.name} has "
                    f"{stacked[name]}")
            leaf = np.stack([by_index[i] for i in want])
            _put_path(out, [name, *path], leaf.reshape(
                stacked[name] + leaf.shape[1:]))
    return out


def _stacked_axes(cfg) -> dict[str, tuple]:
    """The reference tree's stacked subtrees and their leading axes (the
    encdec family's ``enc_layers`` and ``dec_layers``; no ``layers``)."""
    if cfg.family == "encdec":
        return {"enc_layers": (cfg.num_encoder_layers,),
                "dec_layers": (cfg.num_layers,)}
    stacked = {"layers": (cfg.num_layers,)}
    if cfg.attn_every:
        stacked["ssm_layers"] = (cfg.num_layers // cfg.attn_every,
                                 cfg.attn_every - 1)
    return stacked


def _put_path(tree: dict, path: list, leaf) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = leaf


def _first_leaf(node):
    while isinstance(node, dict):
        node = next(iter(node.values()))
    return node
