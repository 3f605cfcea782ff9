"""Decoder-only LM for the uniform-stack families, as ``repro/models/lm.py``:

  dense (deepseek-67b / yi-6b / llama3-8b / tinyllama),
  moe   (qwen2-moe; deepseek-v2's MLA mixer waits: ROADMAP.md),
  ssm   (mamba2, attention-free).

The stack is described by ``stack_plan`` segments, as in the reference;
the port flattens them into one (mixer, ffn) pair a layer
(:func:`layer_plan`) and loops over a flat list of layers in Python.  The
hybrid family (``models/hybrid.py``) runs the same loops over its own
plan: :func:`plan_specs`, :func:`plan_cache_specs`, :func:`plan_loss`,
:func:`plan_prefill` and :func:`plan_decode_step` take the plan.

Parameters: ``embed`` (``table`` and ``unembed``), ``layers`` (one
:class:`~repro_torch.models.params.Params` a layer) and ``ln_f``.  Caches:
one a layer, preallocated: ``(k, v)`` for attention, each (B, S_max, KV,
hd) in the compute type, and ``SSMState(conv, ssm)`` for SSD.  Prefill
writes the prompt's K/V into ``[:, :S]`` and copies the SSM state in;
decode updates every cache in place (a captured decode graph replays on
the same buffers, so a rebound name would freeze the state).  ``plan_loss``
is the training objective: the chunked cross-entropy of the final hidden
states plus the routers' aux loss summed over layers, each layer
recomputed in backward by ``cfg.remat``.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (
    chunked_cross_entropy, embed, embed_specs, rmsnorm, rmsnorm_spec,
    unembed_matrix,
)
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import SSMState, _dims

Tensor = torch.Tensor
Cache = Union[tuple[Tensor, Tensor], SSMState]
Caches = list[Cache]
Plan = list[tuple[str, str]]  # (mixer, ffn) a layer


class Segment(NamedTuple):
    mixer: str
    ffn: str
    count: int


def stack_plan(cfg: ModelConfig) -> list[Segment]:
    if cfg.family == "dense":
        return [Segment("attn", "mlp", cfg.n_layers)]
    if cfg.family == "ssm":
        return [Segment("ssm", "none", cfg.n_layers)]
    if cfg.family == "moe":
        if cfg.mla is not None:
            raise blocks.not_ported(f"{cfg.name}'s MLA mixer")
        first = cfg.moe.first_dense
        segs = [Segment("attn", "mlp", first)] if first else []
        return segs + [Segment("attn", "moe", cfg.n_layers - first)]
    raise blocks.not_ported(f"the {cfg.family!r} family")


def layer_plan(cfg: ModelConfig) -> Plan:
    """The segments' layers in order, one (mixer, ffn) pair each."""
    return [(seg.mixer, seg.ffn) for seg in stack_plan(cfg)
            for _ in range(seg.count)]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------
def plan_specs(cfg: ModelConfig, plan: Plan) -> dict:
    return {"embed": embed_specs(cfg),
            "layers": [blocks.layer_specs(cfg, mixer=m, ffn=f)
                       for m, f in plan],
            "ln_f": rmsnorm_spec(cfg.d_model)}


def _mixer_cache_spec(cfg: ModelConfig, mixer: str, batch: int,
                      s_max: int) -> tuple[ParamSpec, ...]:
    cd = cfg.cdtype
    if mixer == "attn":
        kv = ParamSpec((batch, s_max, cfg.n_kv_heads, cfg.hd), cd,
                       init="zeros")
        return (kv, kv)
    if mixer == "ssm":
        s = cfg.ssm
        _, heads, conv_dim = _dims(cfg)
        return SSMState(
            conv=ParamSpec((batch, s.d_conv - 1, conv_dim), cd,
                           init="zeros"),
            ssm=ParamSpec((batch, heads, s.d_state, s.head_dim),
                          torch.float32, init="zeros"))
    raise blocks.not_ported(f"the {mixer!r} mixer's cache")


def plan_cache_specs(cfg: ModelConfig, plan: Plan, batch: int,
                     s_max: int) -> list[tuple[ParamSpec, ...]]:
    return [_mixer_cache_spec(cfg, m, batch, s_max) for m, _ in plan]


def init_caches(specs: list[tuple[ParamSpec, ...]],
                device: torch.device | str) -> Caches:
    """Zeroed caches on ``device``, each of its spec's kind (a K/V pair
    or an ``SSMState``)."""
    def one(spec):
        leaves = [s.initializer(None, device) for s in spec]
        return SSMState(*leaves) if isinstance(spec, SSMState) \
            else tuple(leaves)
    return [one(spec) for spec in specs]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _train_layer(layer, x: Tensor, positions: Tensor, cfg: ModelConfig,
                 mixer: str, ffn: str) -> tuple[Tensor, Tensor]:
    x, aux, _ = blocks.layer_apply(layer, x, cfg=cfg, mode="train",
                                   mixer=mixer, ffn=ffn,
                                   positions=positions)
    return x, aux


def plan_loss(params, batch: dict, cfg: ModelConfig, plan: Plan
              ) -> tuple[Tensor, dict[str, Tensor]]:
    """``(ce + aux, {"ce", "aux"})`` over a batch of ``tokens`` and
    ``labels`` (B, S) (label -1: no target); ``aux`` is the routers' load
    loss summed over the layers (0 without MoE)."""
    tokens, labels = batch["tokens"], batch["labels"]
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed(params.embed, tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, (mixer, ffn) in zip(params.layers, plan, strict=True):
        x, a = blocks.remat(cfg, _train_layer, layer, x, positions, cfg,
                            mixer, ffn)
        aux = aux + a
    x = rmsnorm(params.ln_f, x, cfg.norm_eps, cfg.bf16_norm_grad)
    ce = chunked_cross_entropy(x, unembed_matrix(params.embed), labels, cfg)
    return ce + aux, {"ce": ce, "aux": aux}


def plan_prefill(params, tokens: Tensor, cfg: ModelConfig, caches: Caches,
                 plan: Plan) -> tuple[Tensor, Caches]:
    """Forward over the prompt (B, S); writes each layer's cache into its
    buffers and returns the last position's logits (B, V_pad) in the
    compute type, and the caches."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed(params.embed, tokens, cfg)
    for layer, (mixer, ffn), cache in zip(params.layers, plan, caches,
                                          strict=True):
        x, _, new = blocks.layer_apply(layer, x, cfg=cfg, mode="prefill",
                                       mixer=mixer, ffn=ffn,
                                       positions=positions)
        # K/V (B, S, KV, hd) into [:, :S] of the (B, S_max, ...) buffers;
        # an SSM state's conv tail and state fill theirs.
        for buf, val in zip(cache, new, strict=True):
            buf[:, :val.shape[1]] = val
    x = rmsnorm(params.ln_f, x[:, -1:], cfg.norm_eps)
    logits = x @ unembed_matrix(params.embed).to(x.dtype)
    return logits[:, 0], caches


def plan_decode_step(params, tokens: Tensor, caches: Caches, pos: Tensor,
                     cfg: ModelConfig, plan: Plan) -> tuple[Tensor, Caches]:
    """One decode step: tokens (B, 1) at position ``pos`` (a 0-d integer
    tensor on the tokens' device); every cache is updated in place."""
    x = embed(params.embed, tokens, cfg)
    for layer, (mixer, ffn), cache in zip(params.layers, plan, caches,
                                          strict=True):
        x, _, _ = blocks.layer_apply(layer, x, cfg=cfg, mode="decode",
                                     mixer=mixer, ffn=ffn, pos=pos,
                                     cache=cache)
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = x @ unembed_matrix(params.embed).to(x.dtype)
    return logits[:, 0], caches


# ---------------------------------------------------------------------------
# The uniform-stack families
# ---------------------------------------------------------------------------
def lm_specs(cfg: ModelConfig) -> dict:
    return plan_specs(cfg, layer_plan(cfg))


def lm_cache_specs(cfg: ModelConfig, batch: int, s_max: int
                   ) -> list[tuple[ParamSpec, ...]]:
    return plan_cache_specs(cfg, layer_plan(cfg), batch, s_max)


def lm_loss(params, batch: dict, cfg: ModelConfig
            ) -> tuple[Tensor, dict[str, Tensor]]:
    return plan_loss(params, batch, cfg, layer_plan(cfg))


def lm_prefill(params, tokens: Tensor, cfg: ModelConfig, caches: Caches
               ) -> tuple[Tensor, Caches]:
    return plan_prefill(params, tokens, cfg, caches, layer_plan(cfg))


def lm_decode_step(params, tokens: Tensor, caches: Caches, pos: Tensor,
                   cfg: ModelConfig) -> tuple[Tensor, Caches]:
    return plan_decode_step(params, tokens, caches, pos, cfg,
                            layer_plan(cfg))
