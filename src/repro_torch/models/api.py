"""Uniform model API of the port: ``build_model(cfg)`` -> ``Model`` with
forward / hidden / prefill / decode_step / init_cache, the port of
``repro.models.api``. The encdec family runs on :mod:`.encdec`, every
other LM family on :mod:`.transformer`. ``input_specs(cfg, shape)``
returns meta tensors in place of every input of an (arch, shape) pair,
allocating nothing, for the dry-run (:mod:`..launch.dryrun`);
``supported``, ``decode_window`` and ``attn_cache_len`` say which pairs
are in scope, the decode window and the cache length.

``build_model`` draws random weights on the card unless the caller asks
for the CPU; on the meta device it builds the same modules and draws
nothing. It fixes the kernel route: ``kernels="cuda"`` sends prefill
attention to K3, decode attention to K4 and the SSD scan to K5;
``kernels="torch"`` runs their plain versions; ``kernels="blockwise"``
too, but attention over more than 512 keys in key blocks recomputed in
the backward (``kernels.ref.mha_blockwise``; the reference's
``set_default_backend("blockwise")``).

The functional forward, for training: ``Model.params()`` is the weights
by name, and ``apply`` / ``apply_hidden`` / ``loss`` take such a dict
(``torch.func.functional_call``), so ``torch.func.grad`` and ``vmap`` or
``torch.autograd`` differentiate with respect to it, as the reference
differentiates ``model.forward(params, batch)``. The ``"cuda"`` route's
attention and SSD kernels have no backward and refuse autograd
(``kernels.ops``): a model that trains is built with ``kernels="torch"``
or ``"blockwise"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.func import functional_call

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from ..kernels import ops
from . import encdec, transformer
from .layers import NoDraws, dtype_of

# dense archs use this ring-buffer window for the long_500k decode shape
# (the explicitly-implemented sub-quadratic sliding-window variant).
LONG_CONTEXT_WINDOW = 8192


def _module(cfg: ModelConfig):
    """The module of ``cfg``'s family: :mod:`.encdec` or
    :mod:`.transformer`."""
    if cfg.family == "cnn":
        raise ValueError("use repro_torch.models.cnn directly for the "
                         "paper CNN")
    return encdec if cfg.family == "encdec" else transformer


@dataclass
class Model:
    cfg: ModelConfig
    net: transformer.Transformer | encdec.EncDec
    device: torch.device
    kernels: str

    @property
    def mod(self):
        return _module(self.cfg)

    def _batch(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v).to(self.device)
                for k, v in batch.items()}

    def forward(self, batch: dict, *, window: int | None = None):
        """(logits (B, S, V), aux) of a full sequence."""
        return self.mod.forward(self.net, self._batch(batch),
                                window=window)

    def hidden(self, batch: dict, *, window: int | None = None):
        return self.mod.hidden(self.net, self._batch(batch),
                               window=window)

    def params(self) -> dict[str, torch.Tensor]:
        """The weights by name (``named_parameters``): the tree
        ``apply`` takes, ``convert.lm_params_to_numpy`` restacks and the
        checkpoints hold."""
        return dict(self.net.named_parameters())

    def apply(self, params: dict, batch: dict, *,
              window: int | None = None):
        """(logits (B, S, V), aux) of ``batch`` (tensors on the model's
        device) under the weights ``params``."""
        return functional_call(self.net, params, (batch,),
                               {"window": window})

    def apply_hidden(self, params: dict, batch: dict, *,
                     window: int | None = None):
        """(final-norm hidden states (B, S, D), aux) under ``params``."""
        return functional_call(self.net, params, (batch,),
                               {"window": window, "head": False})

    def loss(self, params: dict, batch: dict, *,
             window: int | None = None):
        """(next-token loss + router_aux_weight * aux, logits) of
        ``batch`` (``tokens``, optional ``loss_weights``, and the
        family's ``patches`` or ``frames``) under
        ``params``."""
        logits, aux = self.apply(params, batch, window=window)
        loss = transformer.lm_loss(self.cfg, logits, batch["tokens"],
                                   batch.get("loss_weights"))
        return loss + self.cfg.router_aux_weight * aux, logits

    @torch.inference_mode()
    def prefill(self, batch: dict, *, window: int | None = None,
                cache_len: int | None = None):
        """(logits (B, S, V), cache) after a full-sequence prefill."""
        return self.mod.prefill(self.net, self._batch(batch),
                                window=window, cache_len=cache_len)

    @torch.inference_mode()
    def decode_step(self, cache: dict, tokens: torch.Tensor, *,
                    window: int | None = None):
        """(logits (B, 1, V), cache); the cache is updated in place."""
        return self.mod.decode_step(self.net, cache,
                                    tokens.to(self.device), window=window)

    def init_cache(self, batch: int, cache_len: int,
                   dtype: torch.dtype | None = None) -> dict:
        return self.mod.init_cache(self.cfg, batch, cache_len, dtype,
                                   device=self.device)

    def num_params(self) -> int:
        return sum(p.numel() for p in self.net.parameters())


def build_model(cfg: ModelConfig, *, device="cuda", kernels: str = "cuda",
                seed: int = 0) -> Model:
    """A model of ``cfg`` with random weights from a generator seeded with
    ``seed`` on ``device``; raises if ``device`` is the card and none is
    present. On ``"meta"`` the weights are shapes only: nothing is drawn
    or allocated."""
    ops._check(kernels)
    device = resolve_device(device)
    gen = (NoDraws() if device.type == "meta" else
           torch.Generator(device=device).manual_seed(seed))
    net = _module(cfg).init(cfg, gen, kernels)
    return Model(cfg=cfg, net=net, device=device, kernels=kernels)


def decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sliding window used for a decode shape (0 = full attention)."""
    if shape.name == "long_500k" and cfg.family != "ssm":
        return LONG_CONTEXT_WINDOW
    return cfg.sliding_window


def attn_cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV-cache length for decode: ring buffer when windowed."""
    w = decode_window(cfg, shape)
    return min(shape.seq_len, w) if w else shape.seq_len


def supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Is (arch x shape) in scope? (the one documented skip)."""
    if cfg.family == "encdec" and shape.name == "long_500k":
        return False, ("whisper context is bounded by construction "
                       "(1500 frames / 448-token decoder); 500k-token "
                       "decode has no analogue — documented skip")
    if cfg.family == "cnn":
        return False, ("paper CNN is exercised by the FL simulator, "
                       "not LM shapes")
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta tensors for every input of (arch, shape): ``tokens`` int32
    and the family's ``patches`` or ``frames`` for train and prefill; for
    decode one token and the cache of ``init_cache(b, attn_cache_len)``,
    built on meta. Nothing is allocated."""
    b, s = shape.global_batch, shape.seq_len
    act = dtype_of(cfg)

    def spec(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        text = s
        specs: dict[str, Any] = {}
        if cfg.family == "vlm":
            text = s - cfg.num_patches
            specs["patches"] = spec((b, cfg.num_patches, cfg.d_model), act)
        if cfg.family == "encdec":
            specs["frames"] = spec((b, cfg.encoder_seq, cfg.d_model), act)
        specs["tokens"] = spec((b, text), torch.int32)
        return specs

    # decode: one new token + a full cache of seq_len context
    cache = _module(cfg).init_cache(cfg, b, attn_cache_len(cfg, shape),
                                    None, device="meta")
    return {"tokens": spec((b, 1), torch.int32), "cache": cache}
