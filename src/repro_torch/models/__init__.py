"""Model facade, as ``repro/models/__init__.py``, for every family
(dense, moe with or without MLA, ssm, hybrid, vlm and encdec):

    model = get_model(cfg)
    params = model.init_params(seed=0, device=None)  # the card by default
    caches = model.init_cache(batch, s_max, device)
    logits, caches = model.prefill(params, tokens, caches, ctx=None)
    logits, caches = model.decode_step(params, tokens, caches, pos)
    loss, metrics = model.loss(params, batch)  # training

A per-family table (the reference's ``_FAMILY``) names each family's
functions.  ``init_cache`` builds each layer's cache kind: a K/V pair for
attention, MLA's latent pair, a cross layer's context K/V (at the
context's length), an ``SSMState`` for SSD, a ``SelfCrossCache`` for a
whisper decoder layer.  The ``vlm`` and ``encdec`` prefills take the
context ``ctx`` (B, T, d_model) that the reference's batch dict carries
(image patches or audio frames; the towers are stubs); decode takes none.
``prefill`` and ``decode_step`` run under ``torch.no_grad()``,
so parameters that a train step made require gradients bring no autograd
state into serving (or into a captured decode graph).

``empty_params``, ``init_params``, ``init_cache``, ``prefill`` and
``decode_step`` take the reference's ``rules`` (its
``models/__init__.py:38-42``), default None: one device, or data ranks
that each hold the whole model.  Rules from
``distributed.sharding.rules_for_mesh(mesh)`` over a mesh whose ``model``
axis has t > 1 ranks serve every family tensor-parallel
(``models.parallel``): each rank holds its slices of the split weights
(drawn, by ``init_params``, as the whole tensors one rank would draw) and
its part of the cache (its KV heads, its SSD heads, MLA's whole latent),
and every rank gets the whole logits.  Every rank of the mesh makes the
same calls in the same order.  What the port cannot place over such an
axis (``ShardingRules.check``) raises ``NotImplementedError`` naming
ROADMAP.md when its parameters are built.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, hybrid, lm, vision
from repro_torch.models.params import Params, materialize, shard_specs
from repro_torch.models.parallel import TensorParallel, tensor_parallel


class _Family(NamedTuple):
    specs: Callable
    loss: Callable
    prefill: Callable
    decode: Callable
    cache_specs: Callable
    layer_plan: Callable


_LM = _Family(lm.lm_specs, lm.lm_loss, lm.lm_prefill, lm.lm_decode_step,
              lm.lm_cache_specs, lm.layer_plan)
_FAMILY = {
    "dense": _LM,
    "moe": _LM,
    "ssm": _LM,
    "hybrid": _Family(hybrid.hybrid_specs, hybrid.hybrid_loss,
                      hybrid.hybrid_prefill, hybrid.hybrid_decode_step,
                      hybrid.hybrid_cache_specs, hybrid.layer_plan),
    "vlm": _Family(vision.vlm_specs, vision.vlm_loss, vision.vlm_prefill,
                   vision.vlm_decode_step, vision.vlm_cache_specs,
                   vision.layer_plan),
    "encdec": _Family(encdec.encdec_specs, encdec.encdec_loss,
                      encdec.encdec_prefill, encdec.encdec_decode_step,
                      encdec.encdec_cache_specs, encdec.layer_plan),
}
#: The families whose prefill (and training batch) carries a ``ctx``.
CONTEXT_FAMILIES = ("vlm", "encdec")


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    @property
    def _fns(self) -> _Family:
        return _FAMILY[self.cfg.family]

    def specs(self) -> dict:
        """The whole model's spec tree (whole shapes, logical axes)."""
        return self._fns.specs(self.cfg)

    def layer_plan(self) -> lm.Plan:
        """The (mixer, ffn) of each decoder layer in order (the encoder's
        layers are not in it): ``attn`` a self-attention layer, the one
        mixer that runs the flash kernel where the config asks for it."""
        return self._fns.layer_plan(self.cfg)

    def tensor_parallel(self, rules=None) -> TensorParallel | None:
        """This rank's context over the rules' model axis, or None where it
        has one rank (``models.parallel.tensor_parallel``)."""
        return tensor_parallel(self.cfg, rules)

    def empty_params(self, device: torch.device | str | None = None,
                     rules=None) -> Params:
        """The parameter modules, allocated on ``device`` and not filled:
        this rank's slices over a model axis."""
        specs = self.specs()
        tp = self.tensor_parallel(rules)
        if tp is not None:
            specs = shard_specs(specs, rules, tp.coords)
        return Params(specs, resolve_device(device))

    def init_params(self, seed: int = 0,
                    device: torch.device | str | None = None,
                    rules=None) -> Params:
        """Random parameters, made on ``device`` by a generator there seeded
        with ``seed``; over a model axis each rank draws every whole tensor
        and keeps its slice, so the ranks hold one rank's weights."""
        device = resolve_device(device)
        return materialize(self.empty_params(device, rules),
                           torch.Generator(device=device).manual_seed(seed))

    def init_cache(self, batch: int, s_max: int,
                   device: torch.device | str | None = None,
                   rules=None) -> lm.Caches:
        tp = self.tensor_parallel(rules)
        specs = self._fns.cache_specs(self.cfg, batch, s_max, tp)
        return lm.init_caches(specs, resolve_device(device))

    @torch.no_grad()
    def prefill(self, params, tokens, caches=None, ctx=None, rules=None):
        """Last-position logits and caches; caches sized to the prompt when
        none are given.  ``ctx`` (B, T, d_model) is the context of the
        ``vlm`` and ``encdec`` families, which need one; the others
        ignore it."""
        context = self.cfg.family in CONTEXT_FAMILIES
        if context and ctx is None:
            raise ValueError(f"the {self.cfg.family!r} family's prefill "
                             f"needs a ctx (B, T, d_model)")
        if caches is None:
            caches = self.init_cache(*tokens.shape, tokens.device, rules)
        return self._fns.prefill(params, tokens, self.cfg, caches,
                                 *((ctx,) if context else ()),
                                 tp=self.tensor_parallel(rules))

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos, rules=None):
        """Logits of ``tokens`` (B, 1) at position ``pos``: a 0-d integer
        tensor on their device (as the reference's traced ``pos``), or a
        Python int, filled in on the device."""
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int32, device=tokens.device)
        return self._fns.decode(params, tokens, caches, pos, self.cfg,
                                tp=self.tensor_parallel(rules))

    def loss(self, params, batch):
        """``(loss, {"ce", "aux"})`` of a batch of ``tokens`` and
        ``labels`` (and ``ctx`` for ``vlm`` and ``encdec``);
        differentiable in the parameters."""
        return self._fns.loss(params, batch, self.cfg)


def get_model(cfg: ModelConfig) -> Model:
    if cfg.family not in _FAMILY:
        raise ValueError(f"unknown family {cfg.family!r}")
    return Model(cfg)
