"""Architecture configuration, the port's own copy of
``repro/configs/base.py``: the same dataclasses, field names and defaults
(dtypes stay strings), so that a config carries across by field name.
``pdtype``/``cdtype`` give torch dtypes.  The port builds models of every
family (``repro_torch.models.get_model``)."""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Family = Literal["dense", "moe", "encdec", "vlm", "ssm", "hybrid"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    num_shared: int = 0  # shared experts (DeepSeek/Qwen style)
    d_ff_shared: int = 0  # total shared-expert hidden width
    every_k_layers: int = 1  # MoE on layers where (layer % k == k-1)
    first_dense: int = 0  # leading dense layers (DeepSeek-V2 style)
    router_aux_weight: float = 0.001
    capacity_factor: float = 1.25  # used by the dense-dispatch fallback


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256  # SSD block length


@dataclasses.dataclass(frozen=True)
class CrossAttnConfig:
    """VLM (llama-3.2-vision style): cross-attn layers every k-th layer."""

    every_k_layers: int = 5
    n_context_tokens: int = 1601  # stub image-patch embeddings


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper style: encoder depth + stub audio-frame context."""

    n_encoder_layers: int = 12
    n_context_tokens: int = 1500  # stub conv-frontend output frames


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0  # 0 => d_model // n_heads
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    cross: CrossAttnConfig | None = None
    encdec: EncDecConfig | None = None
    # hybrid (jamba): one attention layer per `attn_period` layers
    attn_period: int = 0  # 0 => pure attention (or pure ssm if family==ssm)
    tie_embeddings: bool = False
    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    q_chunk: int = 512  # chunked-attention query block
    ce_chunk: int = 512  # chunked cross-entropy sequence block
    remat: str = "full"  # "full" | "dots" | "none"
    # The reference's multi-device and backward-pass options, kept so that
    # configs carry across.  Training reads ``bf16_norm_grad``; ``moe_ep``
    # and ``seq_parallel`` wait for the model-parallel meshes that use them
    # (ROADMAP.md): on one rank the experts keep the non-EP layout.
    moe_ep: bool = False
    bf16_norm_grad: bool = False
    seq_parallel: bool = False
    # Attention of prefill and serving through the hand-written flash kernel
    # (kernels/flash_attention.py); off, the plain chunked attention.
    flash_attention: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One benchmark cell: an input-shape regime for an architecture."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def supports_shape(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Assignment rules: long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k":
        if cfg.family in ("ssm", "hybrid"):
            return True, ""
        return False, (
            "pure full-attention arch: 500k dense decode skipped per "
            "assignment (see DESIGN.md Sec. 5)"
        )
    return True, ""
