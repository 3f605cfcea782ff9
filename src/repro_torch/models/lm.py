"""Decoder-only LM for the uniform-stack families, as ``repro/models/lm.py``:

  dense (deepseek-67b / yi-6b / llama3-8b / tinyllama),
  moe   (qwen2-moe; deepseek-v2 = MLA mixer + leading dense layers),
  ssm   (mamba2, attention-free).

The stack is described by ``stack_plan`` segments, as in the reference;
the port flattens them into one (mixer, ffn) pair a layer
(:func:`layer_plan`) and loops over a flat list of layers in Python.  The
hybrid, vlm and encdec families (``models/hybrid.py``, ``vision.py``,
``encdec.py``) run the same loops over their own plans:
:func:`plan_specs`, :func:`plan_cache_specs`, :func:`plan_loss`,
:func:`plan_prefill` and :func:`plan_decode_step` take the plan, and the
loops take the cross context ``ctx`` and ``add_cross`` (every layer a
whisper decoder layer).

Parameters: ``embed`` (``table`` and ``unembed``), ``layers`` (one
:class:`~repro_torch.models.params.Params` a layer) and ``ln_f``.  Caches:
one a layer, preallocated: ``(k, v)`` for attention, each (B, S_max, KV,
hd) in the compute type; MLA's latent pair, (B, S_max, kv_lora) and (B,
S_max, rope_dim); a cross layer's context K/V, (B, T, KV, hd) at the
context's length T; a ``SelfCrossCache`` of both for an ``add_cross``
layer; and ``SSMState(conv, ssm)`` for SSD.  Prefill writes the prompt's
K/V into ``[:, :S]``, the context's whole, and copies the SSM state in;
decode updates every sequence cache in place and only reads context K/V
(a captured decode graph replays on the same buffers, so a rebound name
would freeze the state).  ``plan_loss``
is the training objective: the chunked cross-entropy of the final hidden
states plus the routers' aux loss summed over layers, each layer
recomputed in backward by ``cfg.remat``.

Over a model axis (``tp``, a ``models.parallel.TensorParallel``; every
family) the same loops run on a rank's slices: the embedding and the
logits are vocab-parallel (``layers.embed``, ``layers.logits``), each
layer tensor-parallel (``blocks.layer_apply``), and a rank's cache is its
part: an attention or cross layer's K/V its KV heads
(``attention.head_layout``: (B, S_max or T, KV_rank, hd)), an SSD state
its heads (``ssm.head_split``: conv (B, d_conv - 1, d_in / t + 2 G N),
ssm (B, H / t, N, P)); MLA's latent cache is whole on every rank.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.attention import head_layout
from repro_torch.models.layers import (
    chunked_cross_entropy, embed, embed_specs, logits, rmsnorm,
    rmsnorm_spec, unembed_matrix,
)
from repro_torch.models.params import ParamSpec
from repro_torch.models.ssm import SSMState, local_dims, rank_split

Tensor = torch.Tensor
Cache = Union[tuple[Tensor, Tensor], SSMState, blocks.SelfCrossCache]
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
        mixer = "mla" if cfg.mla is not None else "attn"
        first = cfg.moe.first_dense
        segs = [Segment(mixer, "mlp", first)] if first else []
        return segs + [Segment(mixer, "moe", cfg.n_layers - first)]
    raise ValueError(f"stack_plan: unsupported family {cfg.family}")


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
                      s_max: int, tp=None) -> tuple[ParamSpec, ...]:
    cd = cfg.cdtype
    if mixer in ("attn", "cross"):
        t = s_max if mixer == "attn" else ctx_len(cfg)
        heads = (cfg.n_kv_heads if tp is None
                 else head_layout(cfg, tp.size, tp.index).kv_heads)
        kv = ParamSpec((batch, t, heads, cfg.hd), cd, init="zeros")
        return (kv, kv)
    if mixer == "mla":
        return (ParamSpec((batch, s_max, cfg.mla.kv_lora_rank), cd,
                          init="zeros"),
                ParamSpec((batch, s_max, cfg.mla.qk_rope_dim), cd,
                          init="zeros"))
    if mixer == "ssm":
        s = cfg.ssm
        _, heads, conv_dim = local_dims(cfg, rank_split(cfg, tp))
        return SSMState(
            conv=ParamSpec((batch, s.d_conv - 1, conv_dim), cd,
                           init="zeros"),
            ssm=ParamSpec((batch, heads, s.d_state, s.head_dim),
                          torch.float32, init="zeros"))
    raise ValueError(f"unknown mixer {mixer!r}")


def ctx_len(cfg: ModelConfig) -> int:
    """The cross context's length T (image patches or audio frames)."""
    if cfg.cross is not None:
        return cfg.cross.n_context_tokens
    if cfg.encdec is not None:
        return cfg.encdec.n_context_tokens
    raise ValueError("no context config")


def plan_cache_specs(cfg: ModelConfig, plan: Plan, batch: int,
                     s_max: int, tp=None) -> list[tuple[ParamSpec, ...]]:
    """Each layer's cache specs; a rank's KV heads over a model axis."""
    return [_mixer_cache_spec(cfg, m, batch, s_max, tp) for m, _ in plan]


def init_caches(specs: list[tuple[ParamSpec, ...]],
                device: torch.device | str) -> Caches:
    """Zeroed caches on ``device``, each of its spec's kind (a pair, an
    ``SSMState`` or a ``SelfCrossCache``)."""
    def one(spec):
        leaves = [s.initializer(None, device) for s in spec]
        return tuple(leaves) if type(spec) is tuple else type(spec)(*leaves)
    return [one(spec) for spec in specs]


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def _train_layer(layer, x: Tensor, positions: Tensor, cfg: ModelConfig,
                 mixer: str, ffn: str, ctx: Tensor | None = None,
                 causal: bool = True, add_cross: bool = False, tp=None
                 ) -> tuple[Tensor, Tensor]:
    x, aux, _ = blocks.layer_apply(layer, x, cfg=cfg, mode="train",
                                   mixer=mixer, ffn=ffn,
                                   positions=positions, ctx=ctx,
                                   causal=causal, add_cross=add_cross,
                                   tp=tp)
    return x, aux


def run_train_layers(layers, x: Tensor, positions: Tensor,
                     cfg: ModelConfig, plan: Plan, *,
                     ctx: Tensor | None = None, causal: bool = True,
                     add_cross: bool = False, tp=None
                     ) -> tuple[Tensor, Tensor]:
    """``layers`` in training mode, each recomputed in backward by
    ``cfg.remat``; ``ctx``, ``causal`` and ``add_cross`` go to every
    layer.  Returns ``x`` and the summed aux loss.  ``tp`` (a model axis)
    serves the whisper encoder inside a prefill, under ``no_grad``; a
    train step over a model axis is refused at build."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer, (mixer, ffn) in zip(layers, plan, strict=True):
        x, a = blocks.remat(cfg, _train_layer, layer, x, positions, cfg,
                            mixer, ffn, ctx, causal, add_cross, tp)
        aux = aux + a
    return x, aux


def _positions(tokens: Tensor) -> Tensor:
    b, s = tokens.shape[:2]
    return torch.arange(s, device=tokens.device).expand(b, s)


def plan_loss(params, batch: dict, cfg: ModelConfig, plan: Plan, *,
              ctx: Tensor | None = None, add_cross: bool = False
              ) -> tuple[Tensor, dict[str, Tensor]]:
    """``(ce + aux, {"ce", "aux"})`` over a batch of ``tokens`` and
    ``labels`` (B, S) (label -1: no target); ``aux`` is the routers' load
    loss summed over the layers (0 without MoE).  ``ctx`` is the cross
    context every layer sees."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = embed(params.embed, tokens, cfg)
    x, aux = run_train_layers(params.layers, x, _positions(tokens), cfg,
                              plan, ctx=ctx, add_cross=add_cross)
    x = rmsnorm(params.ln_f, x, cfg.norm_eps, cfg.bf16_norm_grad)
    ce = chunked_cross_entropy(x, unembed_matrix(params.embed), labels, cfg)
    return ce + aux, {"ce": ce, "aux": aux}


def plan_prefill(params, tokens: Tensor, cfg: ModelConfig, caches: Caches,
                 plan: Plan, *, ctx: Tensor | None = None,
                 add_cross: bool = False, tp=None) -> tuple[Tensor, Caches]:
    """Forward over the prompt (B, S); writes each layer's cache into its
    buffers and returns the last position's logits (B, V_pad) in the
    compute type (whole on every rank over a model axis ``tp``), and the
    caches.  ``ctx`` (B, T, d) is the cross context."""
    positions = _positions(tokens)
    x = embed(params.embed, tokens, cfg, tp)
    for layer, (mixer, ffn), cache in zip(params.layers, plan, caches,
                                          strict=True):
        x, _, new = blocks.layer_apply(layer, x, cfg=cfg, mode="prefill",
                                       mixer=mixer, ffn=ffn,
                                       positions=positions, ctx=ctx,
                                       add_cross=add_cross, tp=tp)
        # K/V (B, S, KV, hd) into [:, :S] of the (B, S_max, ...) buffers;
        # context K/V (B, T, ...) fill theirs, as an SSM state's conv tail
        # and state do.
        for buf, val in zip(cache, new, strict=True):
            buf[:, :val.shape[1]] = val
    x = rmsnorm(params.ln_f, x[:, -1:], cfg.norm_eps)
    return logits(params.embed, x, tp)[:, 0], caches


def plan_decode_step(params, tokens: Tensor, caches: Caches, pos: Tensor,
                     cfg: ModelConfig, plan: Plan, *,
                     add_cross: bool = False, tp=None
                     ) -> tuple[Tensor, Caches]:
    """One decode step: tokens (B, 1) at position ``pos`` (a 0-d integer
    tensor on the tokens' device); every sequence cache is updated in
    place, context K/V only read."""
    x = embed(params.embed, tokens, cfg, tp)
    for layer, (mixer, ffn), cache in zip(params.layers, plan, caches,
                                          strict=True):
        x, _, _ = blocks.layer_apply(layer, x, cfg=cfg, mode="decode",
                                     mixer=mixer, ffn=ffn, pos=pos,
                                     cache=cache, add_cross=add_cross,
                                     tp=tp)
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    return logits(params.embed, x, tp)[:, 0], caches


# ---------------------------------------------------------------------------
# The uniform-stack families
# ---------------------------------------------------------------------------
def lm_specs(cfg: ModelConfig) -> dict:
    return plan_specs(cfg, layer_plan(cfg))


def lm_cache_specs(cfg: ModelConfig, batch: int, s_max: int, tp=None
                   ) -> list[tuple[ParamSpec, ...]]:
    return plan_cache_specs(cfg, layer_plan(cfg), batch, s_max, tp)


def lm_loss(params, batch: dict, cfg: ModelConfig
            ) -> tuple[Tensor, dict[str, Tensor]]:
    return plan_loss(params, batch, cfg, layer_plan(cfg))


def lm_prefill(params, tokens: Tensor, cfg: ModelConfig, caches: Caches,
               tp=None) -> tuple[Tensor, Caches]:
    return plan_prefill(params, tokens, cfg, caches, layer_plan(cfg), tp=tp)


def lm_decode_step(params, tokens: Tensor, caches: Caches, pos: Tensor,
                   cfg: ModelConfig, tp=None) -> tuple[Tensor, Caches]:
    return plan_decode_step(params, tokens, caches, pos, cfg,
                            layer_plan(cfg), tp=tp)
