"""Spec-first parameters, the port's counterpart of ``repro/models/params.py``.

A model is declared as a tree of :class:`ParamSpec` (shape, dtype,
initializer); :class:`Params` turns a spec dict into an ``nn.Module`` whose
parameters are allocated but not filled, and :func:`materialize` fills them
from an explicit ``torch.Generator`` with the reference's distribution
(``ParamSpec.initializer``, params.py:46-59): a standard normal truncated
at +-2, times ``scale`` (default ``1/sqrt(shape[-2])``, or ``shape[0]`` for a
vector); ones and zeros as named.  The bits differ from ``jax.random``'s.

Parameters are made without ``requires_grad``: a train step
(``training/train_step.py``) turns it on for the parameters it trains, and
serving runs under ``torch.no_grad()``.  Sharding axes are dropped: each
rank of the port holds whole parameters.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: float | None = None  # None => fan-in 1/sqrt(shape[-2] or [0])

    def initializer(self, generator: torch.Generator | None,
                    device: torch.device | str) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        scale = self.scale
        if scale is None:
            fan_in = self.shape[-2] if len(self.shape) >= 2 else self.shape[0]
            scale = 1.0 / math.sqrt(fan_in)
        x = torch.empty(self.shape, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (x * scale).to(self.dtype)


class Params(nn.Module):
    """Parameters declared by a (nested) dict of :class:`ParamSpec`: a leaf
    becomes a parameter of that name, a dict a child ``Params``, a list an
    ``nn.ModuleList`` of them.  Allocated on ``device``, not filled."""

    def __init__(self, specs: dict, device: torch.device | str | None = None):
        super().__init__()
        self.specs: dict[str, ParamSpec] = {}
        for name, spec in specs.items():
            if isinstance(spec, ParamSpec):
                self.specs[name] = spec
                self.register_parameter(name, nn.Parameter(
                    torch.empty(spec.shape, dtype=spec.dtype, device=device),
                    requires_grad=False))
            elif isinstance(spec, list):
                self.add_module(name, nn.ModuleList(
                    Params(s, device) for s in spec))
            else:
                self.add_module(name, Params(spec, device))


@torch.no_grad()
def materialize(params: nn.Module, generator: torch.Generator | None
                ) -> nn.Module:
    """Fill every parameter of ``params`` from its spec, in module order,
    on its own device (use a generator on that device)."""
    for module in params.modules():
        if isinstance(module, Params):
            for name, spec in module.specs.items():
                p = getattr(module, name)
                p.copy_(spec.initializer(generator, p.device))
    return params


def named_specs(tree, prefix: str = "") -> list[tuple[str, ParamSpec]]:
    """The leaves of a spec tree with the names :class:`Params` gives them
    (``named_parameters()``'s: a dict's keys, a list's items by index)."""
    out = []
    for name, spec in tree.items():
        full = f"{prefix}{name}"
        if isinstance(spec, ParamSpec):
            out.append((full, spec))
        elif isinstance(spec, list):
            for i, item in enumerate(spec):
                out += named_specs(item, f"{full}.{i}.")
        else:
            out += named_specs(spec, f"{full}.")
    return out


def count_params(tree) -> int:
    """Parameters declared by a spec tree (nothing allocated)."""
    return sum(math.prod(spec.shape) for _, spec in named_specs(tree))


def shape_tree(tree) -> dict[str, torch.Tensor]:
    """Stand-ins of a spec tree's parameters on the meta device, by name:
    shapes and dtypes, no memory (the reference's ``ShapeDtypeStruct``
    tree, for a dry run)."""
    return {name: torch.empty(spec.shape, dtype=spec.dtype, device="meta")
            for name, spec in named_specs(tree)}
