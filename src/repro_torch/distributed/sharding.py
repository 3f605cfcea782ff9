"""Logical-axis sharding rules (counterpart of
``repro.distributed.sharding``).

Code names the *logical* axes of a tensor; a :class:`ShardingRules` binds
them to mesh axes:

    logical axis   meaning                         production binding
    ------------   -----------------------------   -------------------
    "dp"           batch (pure data parallel)      ("pod", "data")
    "fsdp"         weight dim sharded ZeRO-3       ("pod", "data")
    "tp"           tensor-parallel weight dim      "model"
    "sp"           sequence dim (long-ctx KV)      "model"
    "ep"           expert dim                      "model"

The port runs data parallelism by ranks: one process a rank (the
``torch.distributed`` harness of ``distributed.multihost``), each rank
holding its shard of the batch and the whole parameters, as the
reference's robust step requires.  So :func:`constrain` is the identity
wherever every logical axis resolves to ``None``, to a data axis (the
rules' ``dp``/``fsdp`` axes: parameters and optimizer state stay
replicated, not ZeRO-sharded), or to a mesh axis of size 1; a binding that
needs tensor, sequence or expert parallelism over a mesh axis larger than
1 raises ``NotImplementedError`` (one card cannot hold such a mesh;
ROADMAP.md).  The model functions take no rules: only the train steps and
the training launcher do.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

#: The logical axes that only shard the batch (and, under ZeRO, the
#: weights over the same ranks): each rank runs whole tensors.
DATA_AXES = ("dp", "fsdp")


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """The reference's bindings, field for field; ``mesh_sizes`` (mesh axis
    name, size) pairs of the mesh the rules were made for
    (:func:`rules_for_mesh`), empty for the standard bindings.  An axis
    the mesh does not have counts as size 1."""

    dp: Any = None
    fsdp: Any = None
    tp: Any = None
    sp: Any = None
    ep: Any = None
    mesh_sizes: tuple[tuple[str, int], ...] = ()

    def resolve(self, logical: str | None):
        if logical is None:
            return None
        if logical not in ("dp", "fsdp", "tp", "sp", "ep"):
            raise ValueError(f"unknown logical axis {logical!r}")
        return getattr(self, logical)

    def pspec(self, *axes: str | None) -> tuple:
        """The mesh axes each logical axis resolves to, in order (the
        reference's ``PartitionSpec`` entries)."""
        return tuple(self.resolve(a) for a in axes)

    def size(self, mesh_axes) -> int:
        """Ranks along ``mesh_axes`` (a name, a tuple of names or None)."""
        if mesh_axes is None:
            return 1
        names = mesh_axes if isinstance(mesh_axes, (tuple, list)) \
            else (mesh_axes,)
        sizes = dict(self.mesh_sizes)
        out = 1
        for name in names:
            out *= sizes.get(name, 1)
        return out

    def check(self, *axes: str | None) -> None:
        """Raise where a logical axis in ``axes`` would shard over a mesh
        axis larger than 1 outside the data axes."""
        for a in axes:
            if a is None or a in DATA_AXES:
                continue
            bound = self.resolve(a)
            if self.size(bound) > 1:
                raise NotImplementedError(
                    f"logical axis {a!r} binds mesh axis {bound!r} of size "
                    f"{self.size(bound)}: tensor, sequence and expert "
                    f"parallelism wait for a later slice of the port "
                    f"(ROADMAP.md); the port runs data parallelism by ranks")


# Standard bindings ----------------------------------------------------------
SINGLE_DEVICE = ShardingRules()

SINGLE_POD = ShardingRules(
    dp=("data",), fsdp=("data",), tp="model", sp="model", ep="model"
)

MULTI_POD = ShardingRules(
    dp=("pod", "data"), fsdp=("pod", "data"), tp="model", sp="model",
    ep="model",
)


def rules_for_mesh(mesh) -> ShardingRules:
    """The binding for a ``torch.distributed`` ``DeviceMesh`` by its
    ``mesh_dim_names`` (as ``multihost.multihost_mesh`` builds it), with
    the mesh's axis sizes attached."""
    names = tuple(mesh.mesh_dim_names or ())
    sizes = tuple(zip(names, (int(s) for s in mesh.mesh.shape)))
    if "pod" in names:
        rules = MULTI_POD
    elif "data" in names:
        rules = SINGLE_POD
    else:
        rules = SINGLE_DEVICE
    return dataclasses.replace(rules, mesh_sizes=sizes)


def constrain(x: torch.Tensor, rules: ShardingRules,
              *axes: str | None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` under logical names:
    ``x`` itself (each rank holds whole tensors), after checking that no
    axis needs a model-parallel split (:meth:`ShardingRules.check`).
    Only the tests call it until a model-parallel slice of the port puts
    it in the model's functions."""
    rules.check(*axes)
    return x
