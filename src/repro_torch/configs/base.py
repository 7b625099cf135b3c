"""Config system: architecture and input-shape dataclasses.

The port's own copy of ``repro.configs.base`` (which imports no JAX), so
the port stands without the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    vocab_size: int
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // num_heads
    d_ff: int = 0
    activation: str = "silu"         # silu | geglu | gelu
    attn_bias: bool = False
    qk_norm: bool = False
    rope_style: str = "full"         # full | half (chatglm 2d) | none
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: embeddings * sqrt(d_model)
    # --- MoE ---------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (Mamba2 / SSD) -------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    # --- hybrid (zamba2) ------------------------------------------------
    attn_every: int = 0              # every k-th layer is an attention block
    shared_attention: bool = False   # the attention block weights are shared
    # --- enc-dec (whisper) ----------------------------------------------
    num_encoder_layers: int = 0
    encoder_seq: int = 0             # precomputed frontend frames
    # --- VLM --------------------------------------------------------------
    num_patches: int = 0             # precomputed patch embeddings
    # --- attention variants ------------------------------------------------
    sliding_window: int = 0          # 0 = full attention
    # --- numerics / memory ---------------------------------------------
    param_dtype: str = "bfloat16"
    dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    # --- provenance ------------------------------------------------------
    source: str = ""

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim",
                               self.d_model // self.num_heads)
        if self.num_heads and not self.num_kv_heads:
            object.__setattr__(self, "num_kv_heads", self.num_heads)

    # rounded-up vocab so TP over 16/256 lanes always divides
    @property
    def padded_vocab(self) -> int:
        mult = 256
        return ((self.vocab_size + mult - 1) // mult) * mult

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_headdim if self.ssm_state else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: <=2 layers, d_model<=256, <=4 experts."""
        kw = dict(
            name=self.name + "-reduced",
            num_layers=2 if not self.attn_every else 2 * max(
                self.attn_every, 1),
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 512),
            d_ff=min(self.d_ff, 384) if self.d_ff else 0,
            param_dtype="float32", dtype="float32", remat="none",
        )
        if self.num_heads:
            kw["num_heads"] = min(self.num_heads, 4)
            kw["num_kv_heads"] = min(self.num_kv_heads, 2)
            kw["head_dim"] = 32
        if self.num_experts:
            kw["num_experts"] = 4
            kw["experts_per_token"] = 2
        if self.ssm_state:
            kw["ssm_state"] = min(self.ssm_state, 32)
            kw["ssm_headdim"] = 32
            kw["ssm_chunk"] = 16
        if self.num_encoder_layers:
            kw["num_encoder_layers"] = 2
            kw["encoder_seq"] = 32
        if self.num_patches:
            kw["num_patches"] = 8
        if self.attn_every:
            kw["attn_every"] = 2          # pattern [ssm, attn] x 2
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                         # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
