"""AdamW with fp32 moments (parameters may be bf16), as
``repro/training/optimizer.py``.

The port's parameter tree is a ``models.params.Params`` module; gradients
and the moments are dicts keyed by its parameter names
(``named_parameters()``).  :func:`update` writes the new parameters and
moments in place (one fp32 temporary a leaf at a time) and returns them
with the advanced step.  Every scalar stays a 0-d device tensor: nothing
is read on the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
from torch import nn

Tensor = torch.Tensor


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: Tensor  # int32, 0-d
    m: dict[str, Tensor]  # fp32, by parameter name
    v: dict[str, Tensor]


def lr_at(cfg: AdamWConfig, step: Tensor) -> Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; fp32."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp_max(warm, 1.0) * cos


def init(params: nn.Module) -> AdamWState:
    """Zero moments, fp32, beside each parameter; step 0."""
    named = list(params.named_parameters())
    device = named[0][1].device
    zeros = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for n, p in named}
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device), m=zeros,
        v={n: torch.zeros_like(z) for n, z in zeros.items()})


def decays(name: str, p: Tensor) -> bool:
    """Whether AdamW's weight decay applies to parameter ``name``: the
    reference's rule, ndim >= 2, on the reference's layout, which stacks
    each layer's leaves on a leading layer axis (L, ...).  So the layers'
    norm scales, (L, d) there, decay too; in the port's layout that is every
    leaf of ndim >= 2 and every leaf under ``layers.<i>``."""
    return p.ndim >= 2 or name.startswith("layers.")


def global_norm(tree) -> Tensor:
    """The fp32 L2 norm over every leaf (a dict's values or a sequence)."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    sums = [torch.sum(torch.square(g.to(torch.float32))) for g in leaves]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: dict[str, Tensor], state: AdamWState,
           params: nn.Module) -> tuple[nn.Module, AdamWState, dict]:
    """One AdamW step, the reference's algebra: the global norm clipped to
    ``grad_clip`` (``min(1, clip / (norm + 1e-9))``), bias corrections at
    ``step + 1``, decoupled weight decay where :func:`decays` (the
    reference's ndim >= 2 leaves), the result cast back to each
    parameter's dtype.  ``params``, ``state.m``
    and ``state.v`` are written in place; returns ``(params, new state,
    {"grad_norm", "lr"})``, the metrics 0-d device tensors."""
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-9), 1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for name, p in params.named_parameters():
        g = grads[name].to(torch.float32) * scale
        m = cfg.b1 * state.m[name] + (1 - cfg.b1) * g
        v = cfg.b2 * state.v[name] + (1 - cfg.b2) * g * g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if decays(name, p):
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * delta).to(p.dtype))
        state.m[name].copy_(m)
        state.v[name].copy_(v)
    return params, AdamWState(step=step, m=state.m, v=state.v), {
        "grad_norm": gnorm, "lr": lr}
