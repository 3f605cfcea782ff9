"""Model facade, as ``repro/models/__init__.py``, for the dense family:

    model = get_model(cfg)
    params = model.init_params(seed=0, device=None)  # the card by default
    caches = model.init_cache(batch, s_max, device)
    logits, caches = model.prefill(params, tokens, caches)
    logits, caches = model.decode_step(params, tokens, caches, pos)
    loss, metrics = model.loss(params, batch)  # training

Every other family raises ``NotImplementedError`` in :func:`get_model`
(ROADMAP.md).  ``prefill`` and ``decode_step`` run under
``torch.no_grad()``, so parameters that a train step made require
gradients bring no autograd state into serving (or into a captured
decode graph).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.params import Params, materialize


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def empty_params(self, device: torch.device | str | None = None
                     ) -> Params:
        """The parameter modules, allocated on ``device`` and not filled."""
        return Params(lm.lm_specs(self.cfg), resolve_device(device))

    def init_params(self, seed: int = 0,
                    device: torch.device | str | None = None) -> Params:
        """Random parameters, made on ``device`` by a generator there seeded
        with ``seed``."""
        device = resolve_device(device)
        return materialize(self.empty_params(device),
                           torch.Generator(device=device).manual_seed(seed))

    def init_cache(self, batch: int, s_max: int,
                   device: torch.device | str | None = None) -> lm.Caches:
        device = resolve_device(device)
        return [(k.initializer(None, device), v.initializer(None, device))
                for k, v in lm.lm_cache_specs(self.cfg, batch, s_max)]

    @torch.no_grad()
    def prefill(self, params, tokens, caches=None):
        """Last-position logits and caches; caches sized to the prompt when
        none are given."""
        if caches is None:
            caches = self.init_cache(*tokens.shape, tokens.device)
        return lm.lm_prefill(params, tokens, self.cfg, caches)

    @torch.no_grad()
    def decode_step(self, params, tokens, caches, pos):
        """Logits of ``tokens`` (B, 1) at position ``pos``: a 0-d integer
        tensor on their device (as the reference's traced ``pos``), or a
        Python int, filled in on the device."""
        if not isinstance(pos, torch.Tensor):
            pos = torch.full((), pos, dtype=torch.int32, device=tokens.device)
        return lm.lm_decode_step(params, tokens, caches, pos, self.cfg)

    def loss(self, params, batch):
        """``(loss, {"ce", "aux"})`` of a batch of ``tokens`` and
        ``labels`` (``lm.lm_loss``); differentiable in the parameters."""
        return lm.lm_loss(params, batch, self.cfg)


def get_model(cfg: ModelConfig) -> Model:
    lm.stack_plan(cfg)  # raises for the families the port does not build
    return Model(cfg)
