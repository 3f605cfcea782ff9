"""One pre-norm transformer layer, as ``repro/models/blocks.py``.

A layer is RMSNorm -> self-attention -> residual, RMSNorm -> SwiGLU MLP ->
residual.  The reference stacks layer parameters on a leading axis under
``lax.scan``; the port keeps a list of per-layer modules and loops over it
in Python (``models/lm.py``).  Modes ``train``, ``prefill`` and
``decode``; training recomputes each layer in backward by ``cfg.remat``
(:func:`remat`, the reference's ``_remat``).  The other mixers and FFNs
(MLA, SSD, cross-attention, MoE) raise ``NotImplementedError`` when the
model is built (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.mlp import mlp, mlp_specs

MODES = ("train", "prefill", "decode")


#: ROADMAP.md's Queue 1 item that ports what is refused here.
FAMILIES_ITEM = 8


def not_ported(what: str) -> NotImplementedError:
    """The refusal of an unported LM feature (the other families, their
    mixers and FFNs), naming ROADMAP.md's item :data:`FAMILIES_ITEM`."""
    return NotImplementedError(
        f"{what} waits for a later slice of the port (ROADMAP.md, Queue 1 "
        f"item {FAMILIES_ITEM}); the port serves the dense family")


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
    """Returns ``(x, kv)``: in ``prefill`` this layer's prompt K/V, in
    ``decode`` the caches it updated in place at ``pos`` (a 0-d device
    tensor), in ``train`` None.  Both norms take ``cfg.bf16_norm_grad``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    h = rmsnorm(params.ln1, x, cfg.norm_eps, cfg.bf16_norm_grad)
    if mode == "decode":
        y = attn_mod.attention_decode(params.mixer, h, cache[0], cache[1],
                                      pos, cfg)
        kv = cache
    else:
        y, kv = attn_mod.attention(params.mixer, h, positions, cfg,
                                   train=mode == "train")
        if mode == "train":
            kv = None
    x = x + y
    h = rmsnorm(params.ln2, x, cfg.norm_eps, cfg.bf16_norm_grad)
    return x + mlp(params.ffn, h, cfg), kv


def _dots_saveable(ctx, op, *args, **kwargs):
    """The counterpart of ``dots_with_no_batch_dims_saveable``: keep the
    outputs of matrix products without batch dimensions (``aten.mm``: the
    projections and the MLP), recompute the rest (norms, RoPE, attention's
    batched products, activations)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_dots_saveable)


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)`` (one layer) under the reference's ``_remat`` policy
    ``cfg.remat`` while autograd records: ``"none"`` keeps every
    intermediate, ``"full"`` recomputes the layer in backward (a
    non-reentrant ``torch.utils.checkpoint``), ``"dots"`` keeps only the
    outputs of ``aten.mm`` and recomputes the rest."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    if cfg.remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_dots_context)
    raise ValueError(f"unknown remat policy {cfg.remat!r}")
