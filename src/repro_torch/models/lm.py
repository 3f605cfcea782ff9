"""Decoder-only LM for the dense family, as ``repro/models/lm.py``.

Parameters: ``embed`` (``table`` and ``unembed``), ``layers`` (one
:class:`~repro_torch.models.params.Params` per layer, looped over in Python)
and ``ln_f``.  Caches: one ``(k, v)`` pair per layer, each
(B, S_max, KV, hd) in the compute type.  ``lm_loss`` (training) waits.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.layers import (
    embed, embed_specs, rmsnorm, rmsnorm_spec, unembed_matrix,
)
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor
Caches = list[tuple[Tensor, Tensor]]


class Segment(NamedTuple):
    mixer: str
    ffn: str
    count: int


def stack_plan(cfg: ModelConfig) -> list[Segment]:
    if cfg.family == "dense":
        return [Segment("attn", "mlp", cfg.n_layers)]
    raise blocks.not_ported(f"the {cfg.family!r} family")


def lm_specs(cfg: ModelConfig) -> dict:
    layers = [blocks.layer_specs(cfg, mixer=seg.mixer, ffn=seg.ffn)
              for seg in stack_plan(cfg) for _ in range(seg.count)]
    return {"embed": embed_specs(cfg), "layers": layers,
            "ln_f": rmsnorm_spec(cfg.d_model)}


def lm_cache_specs(cfg: ModelConfig, batch: int, s_max: int
                   ) -> list[tuple[ParamSpec, ParamSpec]]:
    kv = ParamSpec((batch, s_max, cfg.n_kv_heads, cfg.hd), cfg.cdtype,
                   init="zeros")
    return [(kv, kv) for seg in stack_plan(cfg) for _ in range(seg.count)]


def lm_prefill(params, tokens: Tensor, cfg: ModelConfig, caches: Caches
               ) -> tuple[Tensor, Caches]:
    """Forward over the prompt (B, S); writes each layer's K/V into
    ``caches[i][:, :S]`` and returns the last position's logits (B, V_pad)
    in the compute type, and the caches."""
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    x = embed(params.embed, tokens, cfg)
    for layer, (cache_k, cache_v) in zip(params.layers, caches, strict=True):
        x, (k, v) = blocks.layer_apply(layer, x, cfg=cfg, mode="prefill",
                                       positions=positions)
        cache_k[:, :s] = k
        cache_v[:, :s] = v
    x = rmsnorm(params.ln_f, x[:, -1:], cfg.norm_eps)
    logits = x @ unembed_matrix(params.embed).to(x.dtype)
    return logits[:, 0], caches


def lm_decode_step(params, tokens: Tensor, caches: Caches, pos: Tensor,
                   cfg: ModelConfig) -> tuple[Tensor, Caches]:
    """One decode step: tokens (B, 1) at position ``pos`` (a 0-d integer
    tensor on the tokens' device); the caches are updated in place."""
    x = embed(params.embed, tokens, cfg)
    for layer, cache in zip(params.layers, caches, strict=True):
        x, _ = blocks.layer_apply(layer, x, cfg=cfg, mode="decode", pos=pos,
                                  cache=cache)
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    logits = x @ unembed_matrix(params.embed).to(x.dtype)
    return logits[:, 0], caches
