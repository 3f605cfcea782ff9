"""Jamba-style hybrid stack, as ``repro/models/hybrid.py``: one attention
layer per ``attn_period`` layers (the rest Mamba-2 SSD mixers), the FFN
alternating dense MLP / MoE.

The reference scans its layers by period group (``groups``, stacked over
the groups, one ``layer{i}`` subtree per position in the period).  The
port keeps a flat list of layers and runs ``models/lm.py``'s loops over
the hybrid's plan: layer ``L`` is group ``L // period``, position
``L % period`` (``convert.py`` maps it onto ``groups[...]["layer{i}"]``).
Over a model axis (``tp``) the SSD, attention, MLP and MoE layers run on
the rank's heads, columns and experts (``blocks.layer_apply``).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm


def _pattern(cfg: ModelConfig) -> list[tuple[str, str]]:
    """(mixer, ffn) for each layer inside one period group: attention at
    offset ``period // 2`` (Jamba's placement), MoE where ``i % k == k -
    1`` for ``k = moe.every_k_layers``, dense MLP elsewhere."""
    period = cfg.attn_period
    attn_at = period // 2
    out = []
    for i in range(period):
        mixer = "attn" if i == attn_at else "ssm"
        ffn = "moe" if (cfg.moe and i % cfg.moe.every_k_layers
                        == cfg.moe.every_k_layers - 1) else "mlp"
        out.append((mixer, ffn))
    return out


def _n_groups(cfg: ModelConfig) -> int:
    if cfg.attn_period <= 0 or cfg.n_layers % cfg.attn_period:
        raise ValueError(f"{cfg.name}: n_layers {cfg.n_layers} is not a "
                         f"multiple of attn_period {cfg.attn_period}")
    return cfg.n_layers // cfg.attn_period


def layer_plan(cfg: ModelConfig) -> lm.Plan:
    """The groups' layers in order, one (mixer, ffn) pair each."""
    return _pattern(cfg) * _n_groups(cfg)


def hybrid_specs(cfg: ModelConfig) -> dict:
    return lm.plan_specs(cfg, layer_plan(cfg))


def hybrid_cache_specs(cfg: ModelConfig, batch: int, s_max: int,
                       tp=None) -> list:
    return lm.plan_cache_specs(cfg, layer_plan(cfg), batch, s_max, tp)


def hybrid_loss(params, batch: dict, cfg: ModelConfig):
    return lm.plan_loss(params, batch, cfg, layer_plan(cfg))


def hybrid_prefill(params, tokens, cfg: ModelConfig, caches: lm.Caches,
                   tp=None):
    return lm.plan_prefill(params, tokens, cfg, caches, layer_plan(cfg),
                           tp=tp)


def hybrid_decode_step(params, tokens, caches: lm.Caches, pos,
                       cfg: ModelConfig, tp=None):
    return lm.plan_decode_step(params, tokens, caches, pos, cfg,
                               layer_plan(cfg), tp=tp)
