"""The paper's CNN (Appendix Table 5) — LeNet-style, functional PyTorch.

conv5x5(6) -> maxpool2 -> conv5x5(16) -> maxpool2 -> FC(120) -> FC(84)
-> FC(num_classes). ``apply`` returns (logits, features) where features is
the penultimate (84-d) representation.

Layouts: ``apply`` takes NHWC images, as the JAX package does. Convolution
weights are OIHW (PyTorch's), dense weights (in, out). The NHWC input is
permuted to NCHW as a view (channels-last strides), and the last feature
map is flattened in (h, w, c) order before fc1, the order of the JAX
package's ``reshape`` — fc1's rows carry over unpermuted (see
``repro_torch.convert``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _conv_init(gen, kh, kw, cin, cout):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=gen) * math.sqrt(
        2.0 / fan_in)
    return {"w": w, "b": torch.zeros(cout)}


def _dense_init(gen, din, dout):
    w = torch.randn((din, dout), generator=gen) * math.sqrt(2.0 / din)
    return {"w": w, "b": torch.zeros(dout)}


def init(gen: torch.Generator, image_hw: int = 32, channels: int = 3,
         num_classes: int = 10) -> dict:
    """Random He-normal params from ``gen`` (a CPU generator), on the CPU."""
    h = (image_hw - 4) // 2        # after conv1 + pool
    h = (h - 4) // 2               # after conv2 + pool
    flat = h * h * 16
    return {
        "conv1": _conv_init(gen, 5, 5, channels, 6),
        "conv2": _conv_init(gen, 5, 5, 6, 16),
        "fc1": _dense_init(gen, flat, 120),
        "fc2": _dense_init(gen, 120, 84),
        "fc3": _dense_init(gen, 84, num_classes),
    }


def _conv_pool(p, h):
    return F.max_pool2d(F.relu(F.conv2d(h, p["w"], p["b"])), 2)


def apply(params: dict, x: torch.Tensor
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, H, W, C) float -> (logits (B, classes), features (B, 84))."""
    h = x.permute(0, 3, 1, 2)                       # NCHW, channels-last
    h = _conv_pool(params["conv1"], h)
    h = _conv_pool(params["conv2"], h)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)   # (h, w, c) order
    h = F.relu(h @ params["fc1"]["w"] + params["fc1"]["b"])
    feats = F.relu(h @ params["fc2"]["w"] + params["fc2"]["b"])
    logits = feats @ params["fc3"]["w"] + params["fc3"]["b"]
    return logits, feats
