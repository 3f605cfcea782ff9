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

The port runs one process a rank (the ``torch.distributed`` harness of
``distributed.multihost``).  Along the data axes each rank holds its
shard of the batch and the whole parameters, as the reference's robust
step requires: parameters and optimizer state stay replicated, not
ZeRO-sharded.  Along the model axis every LM family serves with tensor
parallelism (``models.parallel``): the ``tp``-tagged weight dims (heads,
the SSD mixer's inner width, MLP columns, the experts' ff columns, the
vocabulary) are split by the reference's rule
(``models.params.shard_specs``), the experts by expert (``ep``) where the
reference's ``_use_ep`` holds, and the decode cache, which the reference
splits by sequence (``sp``), is split by KV head (an SSD state by head;
MLA's latent cache stays whole), which gives the same numbers.
:meth:`ShardingRules.check` lets ``tp``, ``sp`` and ``ep`` over a model
axis larger than 1 pass on that path (``serving=`` the config), and
raises ``NotImplementedError`` naming ROADMAP.md, at build, for
everything else over such an axis: a split that cuts a head (attention,
SSD or MLA) or puts an SSD rank's heads across two of its B/C groups, a
cache that only a sequence split could place (more ranks than KV heads
where ``wk``/``wv`` are split; item 14), experts that the model ranks do
not divide (item 15), and any train step (item 11).  :func:`constrain`
is the identity wherever it does not raise: a rank's tensors are its own
shards already.
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

    @property
    def mesh(self):
        """The ``DeviceMesh`` the rules were made for, where
        :func:`rules_for_mesh` made them (a tensor-parallel rank's
        collectives run over it), else None.  An attribute, not a field:
        it takes no part in comparisons, and ``dataclasses.replace``
        drops it."""
        return self.__dict__.get("_mesh")

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

    def check(self, *axes: str | None, serving=None) -> None:
        """Raise ``NotImplementedError`` (naming ROADMAP.md) where a
        logical axis in ``axes`` would shard over a mesh axis larger than
        1 outside the data axes.  With ``serving`` a model config, ``tp``
        and ``sp`` pass where the port places that config's heads over the
        model axis (:func:`_check_serving`), and ``ep``
        where the config splits its experts by expert (the reference's
        ``_use_ep``) over ranks that divide them."""
        for a in axes:
            if a is None or a in DATA_AXES:
                continue
            bound = self.resolve(a)
            ranks = self.size(bound)
            if ranks <= 1:
                continue
            if serving is not None and a in ("tp", "sp", "ep"):
                _check_serving(serving, ranks)
                if a == "ep":
                    _check_experts(serving, ranks)
                continue
            raise NotImplementedError(
                f"logical axis {a!r} binds mesh axis {bound!r} of size "
                f"{ranks}: the port splits weights over a model axis only "
                f"to serve; a train step over it waits for a later slice "
                f"(ROADMAP.md, Queue 1, item 11)")


def _check_serving(cfg, ranks: int) -> None:
    """Raise unless the port places ``cfg``'s heads over ``ranks`` model
    ranks: the attention layers' query and KV heads
    (:func:`~repro_torch.models.attention.head_layout`; a family without
    attention layers has none to place), the SSD mixer's heads and B/C
    groups (:func:`~repro_torch.models.ssm.head_split`) and MLA's heads
    (:func:`~repro_torch.models.attention.mla_heads`)."""
    from repro_torch.models.attention import head_layout, mla_heads
    from repro_torch.models.ssm import head_split

    if cfg.ssm is not None:
        head_split(cfg, ranks, 0)
    if cfg.mla is not None:
        mla_heads(cfg, ranks)
    elif cfg.family != "ssm":
        head_layout(cfg, ranks, 0)


def _check_experts(cfg, ranks: int) -> None:
    """Raise unless ``cfg``'s experts split by expert over ``ranks``: the
    reference's ``_use_ep`` holds and the ranks divide the experts (where
    they do not, each rank would hold every expert)."""
    from repro_torch.models.moe import _use_ep

    if cfg.moe is None or not _use_ep(cfg) \
            or cfg.moe.num_experts % ranks:
        experts = 0 if cfg.moe is None else cfg.moe.num_experts
        raise NotImplementedError(
            f"{cfg.name}: expert parallelism ('ep') over {ranks} model "
            f"ranks serves a config whose experts split by expert "
            f"(moe_ep, experts a multiple of TP_SIZE) into equal shares; "
            f"{experts} experts with moe_ep={cfg.moe_ep} wait for a later "
            f"slice (ROADMAP.md, Queue 1, item 15)")


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
    rules = dataclasses.replace(rules, mesh_sizes=sizes)
    object.__setattr__(rules, "_mesh", mesh)
    return rules


def constrain(x: torch.Tensor, rules: ShardingRules,
              *axes: str | None) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` under logical names:
    ``x`` itself (a rank's tensor is its shard already), after checking
    that no axis needs a model-parallel split outside the dense serving
    path (:meth:`ShardingRules.check`, which the model's entry points
    call with ``serving=``)."""
    rules.check(*axes)
    return x
