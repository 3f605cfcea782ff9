"""Whisper-style encoder-decoder backbone, as ``repro/models/encdec.py``.

The conv audio frontend is a stub, as in the reference: the prefill (and a
training batch's ``ctx``) carries precomputed frame embeddings (B,
n_context_tokens, d_model).  Encoder: a bidirectional self-attention stack
run in training mode (so the plain attention, never the flash kernel),
then ``ln_enc``; it runs once, inside the prefill, never inside a decode
step.  Decoder: ``models/lm.py``'s loops with ``add_cross``: causal
self-attention, cross-attention over the encoder's output, and an MLP per
layer; each layer's cache is a ``blocks.SelfCrossCache`` (its self K/V at
``s_max`` and the context K/V at the context's length, which decode only
reads).  RoPE stands in for Whisper's learned absolute positions, as in
the reference.

Parameters: ``embed``, ``encoder`` (one layer each), ``ln_enc``,
``layers`` (the decoder; the reference's ``decoder``) and ``ln_f``.

Over a model axis (``tp``) the encoder's layers and the decoder's run on
the rank's heads and MLP columns; each rank gets the whole encoder output
(every layer ends in an all-reduce), and a decoder layer's cache holds the
rank's KV heads of its self and context K/V.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks, lm
from repro_torch.models.layers import embed_specs, rmsnorm, rmsnorm_spec

Tensor = torch.Tensor


def layer_plan(cfg: ModelConfig) -> lm.Plan:
    """The decoder's layers (each also cross-attends)."""
    return [("attn", "mlp")] * cfg.n_layers


def encdec_specs(cfg: ModelConfig) -> dict:
    return {
        "embed": embed_specs(cfg),
        "encoder": [blocks.layer_specs(cfg)
                    for _ in range(cfg.encdec.n_encoder_layers)],
        "ln_enc": rmsnorm_spec(cfg.d_model),
        "layers": [blocks.layer_specs(cfg, add_cross=True)
                   for _ in range(cfg.n_layers)],
        "ln_f": rmsnorm_spec(cfg.d_model),
    }


def encdec_cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                       tp=None) -> list:
    self_kv = lm._mixer_cache_spec(cfg, "attn", batch, s_max, tp)
    cross_kv = lm._mixer_cache_spec(cfg, "cross", batch, s_max, tp)
    return [blocks.SelfCrossCache(*self_kv, *cross_kv)] * cfg.n_layers


def encode(params, ctx: Tensor, cfg: ModelConfig, tp=None) -> Tensor:
    """The bidirectional encoder over frame embeddings (B, T, d), each
    layer recomputed in backward by ``cfg.remat`` while autograd records
    (over a model axis ``tp``, the rank's heads and columns, inside a
    prefill)."""
    b, t, _ = ctx.shape
    positions = torch.arange(t, device=ctx.device).expand(b, t)
    plan = [("attn", "mlp")] * cfg.encdec.n_encoder_layers
    x, _ = lm.run_train_layers(params.encoder, ctx.to(cfg.cdtype), positions,
                               cfg, plan, causal=False, tp=tp)
    return rmsnorm(params.ln_enc, x, cfg.norm_eps, cfg.bf16_norm_grad)


def encdec_loss(params, batch: dict, cfg: ModelConfig):
    return lm.plan_loss(params, batch, cfg, layer_plan(cfg),
                        ctx=encode(params, batch["ctx"], cfg),
                        add_cross=True)


def encdec_prefill(params, tokens, cfg: ModelConfig, caches: lm.Caches,
                   ctx, tp=None):
    return lm.plan_prefill(params, tokens, cfg, caches, layer_plan(cfg),
                           ctx=encode(params, ctx, cfg, tp), add_cross=True,
                           tp=tp)


def encdec_decode_step(params, tokens, caches: lm.Caches, pos,
                       cfg: ModelConfig, tp=None):
    return lm.plan_decode_step(params, tokens, caches, pos, cfg,
                               layer_plan(cfg), add_cross=True, tp=tp)
