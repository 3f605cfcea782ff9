"""One pre-norm layer, as ``repro/models/blocks.py``.

A layer is RMSNorm -> mixer -> residual, then (with ``add_cross``, the
whisper decoder's) RMSNorm -> cross-attention over the context ->
residual, then (unless ``ffn="none"``) RMSNorm -> FFN -> residual.
Mixers: ``"attn"`` (GQA self-attention, causal unless ``causal=False``),
``"mla"`` (DeepSeek-V2's latent attention), ``"ssm"`` (the Mamba-2 SSD
mixer) and ``"cross"`` (llama-3.2-vision's cross-attention in place of
self-attention, its output scaled by ``tanh`` of a learned 0-d fp32
``gate``, zero at initialisation); FFNs: ``"mlp"`` (SwiGLU), ``"moe"``
(routed experts, which add the router's aux loss) and ``"none"``.  The
reference stacks layer parameters on a leading axis under ``lax.scan``;
the port keeps a list of per-layer modules and loops over it in Python
(``models/lm.py``).  Modes ``train``, ``prefill`` and ``decode``; training
recomputes each layer in backward by ``cfg.remat`` (:func:`remat`, the
reference's ``_remat``).  Only self-attention outside training may take
the flash kernel (the reference's ``allow_flash``).

A cross layer's cache is the context's K/V, (B, T, KV, hd) each: the
prefill writes it, decode only reads it.  An ``add_cross`` layer's cache is
a :class:`SelfCrossCache` of its self-attention K/V and that context K/V.

Over a model axis (``tp``, a ``models.parallel.TensorParallel``) every
layer runs tensor-parallel:
self- and cross-attention and MLA on the rank's heads, the SSD mixer on
its heads (``models.ssm``), the MLP on its columns and the MoE on its
share of the experts (``models.moe``), each followed by one all-reduce
(the SSD mixer's norm adds one).  A cross layer's ``tanh(gate)`` scales
the reduced output, as one device's.
"""
from __future__ import annotations

from typing import NamedTuple

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
from repro_torch.models.params import ParamSpec

MODES = ("train", "prefill", "decode")
MIXERS = ("attn", "mla", "ssm", "cross")
FFNS = ("mlp", "moe", "none")


class SelfCrossCache(NamedTuple):
    """An ``add_cross`` layer's cache: the self-attention K/V (B, S_max,
    KV, hd) and the context K/V (B, T, KV, hd)."""
    k: torch.Tensor
    v: torch.Tensor
    cross_k: torch.Tensor
    cross_v: torch.Tensor


def layer_specs(cfg: ModelConfig, *, mixer: str = "attn",
                ffn: str = "mlp", add_cross: bool = False) -> dict:
    if mixer not in MIXERS:
        raise ValueError(f"unknown mixer {mixer!r}")
    if ffn not in FFNS:
        raise ValueError(f"unknown ffn {ffn!r}")
    d = cfg.d_model
    spec = {"ln1": rmsnorm_spec(d),
            "mixer": {"attn": attn_mod.attn_specs,
                      "cross": attn_mod.attn_specs,
                      "mla": attn_mod.mla_specs,
                      "ssm": ssm_mod.ssm_specs}[mixer](cfg)}
    if mixer == "cross":
        spec["gate"] = ParamSpec((), torch.float32, init="zeros", axes=())
    if add_cross:
        spec["ln_cross"] = rmsnorm_spec(d)
        spec["cross"] = attn_mod.attn_specs(cfg)
    if ffn != "none":
        spec["ln2"] = rmsnorm_spec(d)
        spec["ffn"] = (mlp_specs(cfg) if ffn == "mlp"
                       else moe_mod.moe_specs(cfg))
    return spec


def _mixer(params, h: torch.Tensor, cfg: ModelConfig, mode: str, mixer: str,
           positions, pos, cache, ctx, causal: bool, tp=None):
    """The mixer's output and its cache (None in training)."""
    if mixer == "attn":
        if mode == "decode":
            return attn_mod.attention_decode(params, h, cache[0], cache[1],
                                             pos, cfg, tp), cache
        return attn_mod.attention(params, h, positions, cfg, causal=causal,
                                  allow_flash=mode != "train", tp=tp)
    if mixer == "mla":
        if mode == "decode":
            return attn_mod.mla_attention_decode(params, h, cache[0],
                                                 cache[1], pos, cfg,
                                                 tp), cache
        return attn_mod.mla_attention(params, h, positions, cfg, tp)
    if mixer == "ssm":
        if mode == "decode":
            return ssm_mod.ssd_decode(params, h, cache, cfg, tp)
        if mode == "prefill":
            return ssm_mod.ssd_prefill(params, h, cfg, tp)
        return ssm_mod.ssd(params, h, cfg, tp=tp), None
    if mixer == "cross":
        if mode == "decode":
            return attn_mod.cross_decode(params, h, cache[0], cache[1],
                                         cfg, tp), cache
        return attn_mod.attention(params, h, positions, cfg, ctx=ctx, tp=tp)
    raise ValueError(f"unknown mixer {mixer!r}")


def layer_apply(params, x: torch.Tensor, *, cfg: ModelConfig, mode: str,
                mixer: str = "attn", ffn: str = "mlp",
                positions: torch.Tensor | None = None,
                pos: torch.Tensor | None = None, cache=None,
                ctx: torch.Tensor | None = None, causal: bool = True,
                add_cross: bool = False, tp=None):
    """Returns ``(x, aux, cache)``, the reference's order: ``aux`` the
    router's load loss (a 0-d fp32 tensor, 0 without MoE); ``cache`` in
    ``prefill`` this layer's prompt cache (the un-repeated K/V pair, MLA's
    latent pair, the context's K/V for a cross layer, an
    :class:`~repro_torch.models.ssm.SSMState`, or a
    :class:`SelfCrossCache` with ``add_cross``), in ``decode`` the cache it
    updated in place (at ``pos``, a 0-d device tensor; context K/V are
    only read), in ``train`` None.  ``ctx`` (B, T, d) is the context of
    cross-attention (prefill and training); ``causal`` applies to
    self-attention.  Every norm takes ``cfg.bf16_norm_grad``.  ``tp``
    is a model axis (any mixer and FFN)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    h = rmsnorm(params.ln1, x, cfg.norm_eps, cfg.bf16_norm_grad)
    self_cache = cache[:2] if add_cross and mode == "decode" else cache
    y, new = _mixer(params.mixer, h, cfg, mode, mixer, positions, pos,
                    self_cache, ctx, causal, tp)
    if mixer == "cross":
        y = torch.tanh(params.gate).to(y.dtype) * y
    x = x + y
    if add_cross:
        h = rmsnorm(params.ln_cross, x, cfg.norm_eps, cfg.bf16_norm_grad)
        if mode == "decode":
            y = attn_mod.cross_decode(params.cross, h, cache.cross_k,
                                      cache.cross_v, cfg, tp)
            new = cache
        else:
            y, kv = attn_mod.attention(params.cross, h, positions, cfg,
                                       ctx=ctx, tp=tp)
            new = SelfCrossCache(*new, *kv)
        x = x + y
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn != "none":
        h = rmsnorm(params.ln2, x, cfg.norm_eps, cfg.bf16_norm_grad)
        if ffn == "moe":
            y, aux = moe_mod.moe_ffn(params.ffn, h, cfg, tp=tp)
        else:
            y = mlp(params.ffn, h, cfg, tp)
        x = x + y
    return x, aux, (None if mode == "train" else new)


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
