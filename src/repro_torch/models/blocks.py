"""One pre-norm transformer layer, as ``repro/models/blocks.py``.

A layer is RMSNorm -> self-attention -> residual, RMSNorm -> SwiGLU MLP ->
residual.  The reference stacks layer parameters on a leading axis under
``lax.scan``; the port keeps a list of per-layer modules and loops over it
in Python (``models/lm.py``).  Modes ``prefill`` and ``decode``; ``train``
and the other mixers and FFNs (MLA, SSD, cross-attention, MoE) raise
``NotImplementedError`` when the model is built (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.mlp import mlp, mlp_specs

MODES = ("prefill", "decode")


#: ROADMAP.md's Queue 1 items that port what is refused here.
FAMILIES_ITEM, TRAINING_ITEM = 8, 7


def not_ported(what: str, item: int = FAMILIES_ITEM) -> NotImplementedError:
    """The refusal of an unported LM feature: ``item`` is ROADMAP.md's
    Queue 1 item that ports it (the other families, their mixers and FFNs:
    :data:`FAMILIES_ITEM`; training: :data:`TRAINING_ITEM`)."""
    return NotImplementedError(
        f"{what} waits for a later slice of the port (ROADMAP.md, Queue 1 "
        f"item {item}); the port serves the dense family")


def layer_specs(cfg: ModelConfig, *, mixer: str = "attn",
                ffn: str = "mlp") -> dict:
    if mixer != "attn":
        raise not_ported(f"the {mixer!r} mixer")
    if ffn != "mlp":
        raise not_ported(f"the {ffn!r} FFN")
    d = cfg.d_model
    return {"ln1": rmsnorm_spec(d), "mixer": attn_mod.attn_specs(cfg),
            "ln2": rmsnorm_spec(d), "ffn": mlp_specs(cfg)}


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig, mode: str,
                positions: torch.Tensor | None = None,
                pos: torch.Tensor | None = None,
                cache: tuple[torch.Tensor, torch.Tensor] | None = None):
    """Returns ``(x, (k, v))``: in ``prefill`` this layer's prompt K/V, in
    ``decode`` the caches it updated in place at ``pos`` (a 0-d device
    tensor)."""
    if mode not in MODES:
        raise not_ported(f"mode {mode!r}",
                         TRAINING_ITEM if mode == "train" else FAMILIES_ITEM)
    h = rmsnorm(params.ln1, x, cfg.norm_eps)
    if mode == "decode":
        y = attn_mod.attention_decode(params.mixer, h, cache[0], cache[1],
                                      pos, cfg)
        kv = cache
    else:
        y, kv = attn_mod.attention(params.mixer, h, positions, cfg)
    x = x + y
    h = rmsnorm(params.ln2, x, cfg.norm_eps)
    return x + mlp(params.ffn, h, cfg), kv
