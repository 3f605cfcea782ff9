"""One pre-norm layer, as ``repro/models/blocks.py``.

A layer is RMSNorm -> mixer -> residual, then (unless ``ffn="none"``)
RMSNorm -> FFN -> residual.  Mixers: ``"attn"`` (causal GQA self-attention)
and ``"ssm"`` (the Mamba-2 SSD mixer); FFNs: ``"mlp"`` (SwiGLU), ``"moe"``
(routed experts, which add the router's aux loss) and ``"none"``.  The
reference stacks layer parameters on a leading axis under ``lax.scan``;
the port keeps a list of per-layer modules and loops over it in Python
(``models/lm.py``).  Modes ``train``, ``prefill`` and ``decode``; training
recomputes each layer in backward by ``cfg.remat`` (:func:`remat`, the
reference's ``_remat``), the SSD mixer as the attention one.  MLA and
cross-attention (``mixer="mla"``/``"cross"``, the reference's
``add_cross``) raise ``NotImplementedError`` (ROADMAP.md).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import rmsnorm, rmsnorm_spec
from repro_torch.models.mlp import mlp, mlp_specs

MODES = ("train", "prefill", "decode")
MIXERS = ("attn", "ssm")
FFNS = ("mlp", "moe", "none")


#: ROADMAP.md's Queue 1 item that ports what is refused here.
FAMILIES_ITEM = 8


def not_ported(what: str) -> NotImplementedError:
    """The refusal of an unported LM feature (MLA, cross-attention and the
    families built on them), naming ROADMAP.md's item
    :data:`FAMILIES_ITEM`."""
    return NotImplementedError(
        f"{what} waits for a later slice of the port (ROADMAP.md, Queue 1 "
        f"item {FAMILIES_ITEM}); the port serves the dense, ssm, moe "
        f"(without MLA) and hybrid families")


def layer_specs(cfg: ModelConfig, *, mixer: str = "attn",
                ffn: str = "mlp") -> dict:
    if mixer not in MIXERS:
        raise not_ported(f"the {mixer!r} mixer")
    if ffn not in FFNS:
        raise ValueError(f"unknown ffn {ffn!r}")
    d = cfg.d_model
    spec = {"ln1": rmsnorm_spec(d),
            "mixer": (attn_mod.attn_specs(cfg) if mixer == "attn"
                      else ssm_mod.ssm_specs(cfg))}
    if ffn != "none":
        spec["ln2"] = rmsnorm_spec(d)
        spec["ffn"] = (mlp_specs(cfg) if ffn == "mlp"
                       else moe_mod.moe_specs(cfg))
    return spec


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig, mode: str,
                mixer: str = "attn", ffn: str = "mlp",
                positions: torch.Tensor | None = None,
                pos: torch.Tensor | None = None, cache=None):
    """Returns ``(x, aux, cache)``, the reference's order: ``aux`` the
    router's load loss (a 0-d fp32 tensor, 0 without MoE); ``cache`` in
    ``prefill`` this layer's prompt cache (the un-repeated K/V pair, or an
    :class:`~repro_torch.models.ssm.SSMState`), in ``decode`` the cache it
    updated in place (at ``pos``, a 0-d device tensor, for attention), in
    ``train`` None.  Both norms take ``cfg.bf16_norm_grad``."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    h = rmsnorm(params.ln1, x, cfg.norm_eps, cfg.bf16_norm_grad)
    if mixer == "attn":
        if mode == "decode":
            y = attn_mod.attention_decode(params.mixer, h, cache[0],
                                          cache[1], pos, cfg)
        else:
            y, cache = attn_mod.attention(params.mixer, h, positions, cfg,
                                          train=mode == "train")
    elif mixer == "ssm":
        if mode == "decode":
            y, cache = ssm_mod.ssd_decode(params.mixer, h, cache, cfg)
        elif mode == "prefill":
            y, cache = ssm_mod.ssd_prefill(params.mixer, h, cfg)
        else:
            y = ssm_mod.ssd(params.mixer, h, cfg)
    else:
        raise not_ported(f"the {mixer!r} mixer")
    x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = rmsnorm(params.ln2, x, cfg.norm_eps, cfg.bf16_norm_grad)
        if ffn == "moe":
            y, aux = moe_mod.moe_ffn(params.ffn, h, cfg)
        else:
            y = mlp(params.ffn, h, cfg)
        x = x + y
    return x, aux, (None if mode == "train" else cache)


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
