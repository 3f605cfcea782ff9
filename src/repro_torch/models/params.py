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
serving runs under ``torch.no_grad()``.

Each spec carries the reference's logical sharding ``axes`` (one a dim,
``None`` replicated; ``None`` for the whole tuple replicates every dim).
Over a mesh whose model axis is larger than 1, :func:`shard_specs` gives a
rank the spec of its slice by the reference's rule (params.py:81-107: a
dim splits over its axis's mesh extent unless its size does not divide
by it); the data axes (``dp``, ``fsdp``) leave a dim whole, since the port
keeps parameters replicated over data ranks.  A slice's spec remembers
its place (``part``): :meth:`ParamSpec.initializer` draws the whole
tensor from the generator, as one rank would, and keeps the slice, so t
ranks hold exactly the slices of the weights one rank holds.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.distributed.sharding import DATA_AXES, ShardingRules


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"  # "normal" | "zeros" | "ones"
    scale: float | None = None  # None => fan-in 1/sqrt(shape[-2] or [0])
    #: One logical axis a dim ("tp", "fsdp", "ep", ...), None replicated.
    axes: tuple[str | None, ...] | None = None
    #: A rank's slice of a whole tensor: (parts, index) a dim.
    part: tuple[tuple[int, int], ...] | None = None

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")

    @property
    def logical_axes(self) -> tuple[str | None, ...]:
        return self.axes if self.axes is not None else (None,) * len(
            self.shape)

    @property
    def full_shape(self) -> tuple[int, ...]:
        """The whole tensor's shape (``shape`` unless this is a slice)."""
        if self.part is None:
            return self.shape
        return tuple(s * n for s, (n, _) in zip(self.shape, self.part))

    def initializer(self, generator: torch.Generator | None,
                    device: torch.device | str) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        full = self.full_shape
        scale = self.scale
        if scale is None:
            fan_in = full[-2] if len(full) >= 2 else full[0]
            scale = 1.0 / math.sqrt(fan_in)
        x = torch.empty(full, dtype=torch.float32, device=device)
        nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return (shard_tensor(x, self) * scale).to(self.dtype)


def shard_parts(spec: ParamSpec, rules: ShardingRules) -> tuple[int, ...]:
    """The ranks each dim of ``spec`` splits over under ``rules`` (their
    mesh sizes): its logical axis's mesh extent, or 1 where the size does
    not divide by it (the reference's guard) or the axis only shards data.
    """
    parts = []
    for size, logical in zip(spec.shape, spec.logical_axes):
        n = 1
        if logical is not None and logical not in DATA_AXES:
            n = rules.size(rules.resolve(logical))
        parts.append(n if size % n == 0 else 1)
    return tuple(parts)


def local_spec(spec: ParamSpec, rules: ShardingRules,
               coords: dict[str, int]) -> ParamSpec:
    """The spec of this rank's slice of ``spec``: each split dim cut to
    size / parts at the rank's coordinate (``coords``: mesh axis name ->
    index) along the dim's mesh axis (a split dim's axis is never a data
    axis, so it binds one mesh axis)."""
    parts = shard_parts(spec, rules)
    if all(n == 1 for n in parts):
        return spec
    place = tuple((n, coords[rules.resolve(logical)] if n > 1 else 0)
                  for n, logical in zip(parts, spec.logical_axes))
    shape = tuple(s // n for s, n in zip(spec.shape, parts))
    return dataclasses.replace(spec, shape=shape, part=place)


def shard_tensor(x: torch.Tensor, spec: ParamSpec) -> torch.Tensor:
    """This rank's slice of the whole tensor ``x`` of ``spec`` (a view; the
    whole ``x`` where ``spec`` is not a slice)."""
    for dim, (n, index) in enumerate(spec.part or ()):
        size = x.shape[dim] // n
        x = x.narrow(dim, index * size, size)
    return x


def shard_specs(tree, rules: ShardingRules, coords: dict[str, int]):
    """A spec tree (nested dicts and lists) with every leaf replaced by
    the spec of this rank's slice (:func:`local_spec`)."""
    if isinstance(tree, ParamSpec):
        return local_spec(tree, rules, coords)
    if isinstance(tree, list):
        return [shard_specs(t, rules, coords) for t in tree]
    return {k: shard_specs(t, rules, coords) for k, t in tree.items()}


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


def module_specs(params: nn.Module) -> dict[str, ParamSpec]:
    """Every parameter's spec by its ``named_parameters()`` name (a
    rank's slices keep their ``part``)."""
    return {f"{prefix}.{name}" if prefix else name: spec
            for prefix, module in params.named_modules()
            if isinstance(module, Params)
            for name, spec in module.specs.items()}


def count_params(tree) -> int:
    """Parameters declared by a spec tree (nothing allocated)."""
    return sum(math.prod(spec.shape) for _, spec in named_specs(tree))


def shape_tree(tree) -> dict[str, torch.Tensor]:
    """Stand-ins of a spec tree's parameters on the meta device, by name:
    shapes and dtypes, no memory (the reference's ``ShapeDtypeStruct``
    tree, for a dry run)."""
    return {name: torch.empty(spec.shape, dtype=spec.dtype, device="meta")
            for name, spec in named_specs(tree)}
