"""Llama-3.2-Vision-style VLM backbone, as ``repro/models/vision.py``: a
decoder LM with a gated cross-attention layer every
``cross.every_k_layers``-th layer.

The vision tower is a stub, as in the reference: the prefill (and a
training batch's ``ctx``) carries precomputed patch embeddings (B,
n_context_tokens, d_model), cast to the compute type.  The reference scans
its layers by group (``groups``: ``k - 1`` self layers stacked under
``self``, then one ``cross`` layer).  The port keeps a flat list and runs
``models/lm.py``'s loops over the VLM's plan: layer ``L`` is group
``L // k``, position ``L % k``, the group's cross layer at ``k - 1``
(``convert.py`` maps it onto ``groups[...]["self"]`` or ``["cross"]``).
Decode passes no context: the cross layers read the context K/V that the
prefill wrote into their caches.  Over a model axis (``tp``) self- and
cross-attention run on the rank's heads (a cross layer's cache holds its
KV heads of the context) and the MLP on its columns.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def _group_shape(cfg: ModelConfig) -> tuple[int, int]:
    """(n_groups, self layers a group)."""
    k = cfg.cross.every_k_layers
    if cfg.n_layers % k:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} does not "
                         f"divide into cross groups of {k}")
    return cfg.n_layers // k, k - 1


def layer_plan(cfg: ModelConfig) -> lm.Plan:
    """The groups' layers in order: ``k - 1`` self-attention layers, then
    the cross layer, each with a dense MLP."""
    n_groups, n_self = _group_shape(cfg)
    return ([("attn", "mlp")] * n_self + [("cross", "mlp")]) * n_groups


def vlm_specs(cfg: ModelConfig) -> dict:
    return lm.plan_specs(cfg, layer_plan(cfg))


def vlm_cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                    tp=None) -> list:
    return lm.plan_cache_specs(cfg, layer_plan(cfg), batch, s_max, tp)


def vlm_loss(params, batch: dict, cfg: ModelConfig):
    return lm.plan_loss(params, batch, cfg, layer_plan(cfg),
                        ctx=batch["ctx"].to(cfg.cdtype))


def vlm_prefill(params, tokens, cfg: ModelConfig, caches: lm.Caches, ctx,
                tp=None):
    return lm.plan_prefill(params, tokens, cfg, caches, layer_plan(cfg),
                           ctx=ctx.to(cfg.cdtype), tp=tp)


def vlm_decode_step(params, tokens, caches: lm.Caches, pos,
                    cfg: ModelConfig, tp=None):
    return lm.plan_decode_step(params, tokens, caches, pos, cfg,
                               layer_plan(cfg), tp=tp)
