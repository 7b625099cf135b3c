"""Model aggregation (paper Alg. 2 line 21) over param trees.

``aggregate``         — size-weighted FedAvg of stacked client params,
                        restricted to the positive mask (w_g = sum_i L_i w_i
                        / sum_i L_i over i in A).
``masked_mean_tree``  — masked weighted mean over the leading client axis
                        of every leaf, one reduction per leaf.
``fused_aggregate``   — the same mean as one flat reduction: every leaf
                        flattened into a single (M, P) float32 buffer and
                        summed over the client axis in one call
                        (``kernels.ops.masked_weighted_sum``: the plain
                        version or the CUDA kernel).
``comm_bytes``        — uplink bytes actually transferred for a round
                        (positives upload models; every selected device
                        uploads its soft label first — stage 1).
"""
from __future__ import annotations

import torch
from torch.utils import _pytree as pytree

_EPS = 1e-12


def _weights(sizes, mask, device):
    return (sizes.to(device, torch.float32)
            * mask.to(device, torch.float32))


def masked_mean_tree(stacked_tree, sizes: torch.Tensor, mask: torch.Tensor):
    """Weighted mean over leading axis M of every leaf, weights sizes*mask.

    Low-precision leaves (bf16/f16) accumulate in float32 and cast back on
    return; float32 leaves accumulate in float32.
    """
    leaves = pytree.tree_leaves(stacked_tree)
    w = _weights(sizes, mask, leaves[0].device)
    tot = w.sum().clamp(min=_EPS)

    def leaf(x):
        acc = torch.promote_types(x.dtype, torch.float32)
        wl = w.reshape((-1,) + (1,) * (x.dim() - 1)).to(acc)
        out = (x.to(acc) * wl).sum(dim=0) / tot.to(acc)
        return out.to(x.dtype)

    return pytree.tree_map(leaf, stacked_tree)


def fused_aggregate(stacked_tree, sizes: torch.Tensor, mask: torch.Tensor,
                    *, backend: str = "torch"):
    """:func:`masked_mean_tree` as ONE flat reduction.

    Flattens every leaf of the stacked client tree into a single (M, P)
    float32 buffer (P = total param count), reduces it over the client
    axis in one call (``backend="cuda"``: the fused_aggregate kernel;
    ``"torch"``: its plain version), divides by the total weight and
    unflattens to the leaf shapes and dtypes. The pre-flatten float32 cast
    means low-precision leaves accumulate in float32, as in
    ``masked_mean_tree``. Equal to ``masked_mean_tree`` to float32
    tolerance, not bitwise: the order of the sums differs.
    """
    from ..kernels import ops as kops

    leaves, spec = pytree.tree_flatten(stacked_tree)
    m = leaves[0].shape[0]
    w = _weights(sizes, mask, leaves[0].device)
    tot = w.sum().clamp(min=_EPS)
    flat = torch.cat([x.reshape(m, -1).to(torch.float32) for x in leaves],
                     dim=1)
    red = kops.masked_weighted_sum(flat, w, backend=backend) / tot
    outs, off = [], 0
    for x in leaves:
        n = x[0].numel()
        outs.append(red[off:off + n].reshape(x.shape[1:]).to(x.dtype))
        off += n
    return pytree.tree_unflatten(outs, spec)


def aggregate(stacked_params, sizes: torch.Tensor, mask: torch.Tensor):
    """Paper Alg. 2 line 21: w_g = sum_{i in A} L_i W_i / sum_{i in A} L_i."""
    return masked_mean_tree(stacked_params, sizes, mask)


def tree_bytes(tree) -> int:
    return int(sum(x.numel() * x.element_size()
                   for x in pytree.tree_leaves(tree)))


def comm_bytes(model_template, num_selected: int, num_positive: int,
               num_classes: int, soft_label_bytes_per_class: int = 4,
               control_variate: bool = False) -> dict:
    """Uplink communication accounting for one round.

    Stage 1: every selected device uploads a soft label (C floats).
    Stage 2: only positive devices upload models (paper's saving).
    SCAFFOLD-style optimizers double the model payload (control variates).
    """
    model_b = tree_bytes(model_template) * (2 if control_variate else 1)
    soft = num_selected * num_classes * soft_label_bytes_per_class
    models = num_positive * model_b
    return {
        "soft_label_bytes": soft,
        "model_bytes": models,
        "total_bytes": soft + models,
        "fedavg_equivalent_bytes": num_selected * model_b,
        "savings_fraction": 1.0 - (soft + models) / max(
            num_selected * model_b, 1),
    }
