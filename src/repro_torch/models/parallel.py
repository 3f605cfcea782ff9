"""Tensor parallelism over a mesh's model axis, for serving every LM
family.

The reference gives every model function ``rules`` and lets GSPMD split
heads, MLP columns and the vocabulary over the ``model`` axis.  The port
runs one process a rank, so a rank computes on its own slices and meets
the others in explicit collectives, Megatron-style:

* the embedding table and the unembedding are split by vocabulary: a
  masked local lookup and one all-reduce (``layers.embed``), the logits
  of the rank's slice and one all-gather (``layers.logits``);
* attention (self and cross) runs on the rank's h/t query heads and the
  KV heads they use (``attention.head_layout``), self-attention's flash
  kernel on those heads; ``wo`` is split by rows and followed by one
  all-reduce;
* MLA runs on the rank's h/t heads (``attention.mla_heads``) over the
  latent every rank computes whole; ``wo`` as above;
* the SSD mixer runs on the rank's heads of its inner width
  (``ssm.head_split``), B and C whole; its gated RMSNorm over the whole
  width adds the ranks' fp32 sums of squares in one all-reduce, and
  ``out_proj`` is split by rows and followed by another;
* the MLP's ``w_gate``/``w_up`` are split by columns and ``w_down`` by
  rows, followed by one all-reduce;
* an MoE layer's experts are split by their ff columns, or by expert
  where the reference's ``_use_ep`` holds (``models.moe``); the routed
  output's fp32 partial and the shared expert's join one all-reduce.

Every split product that ends in a sum over the ranks
(:func:`fp32_product`) keeps its partial sums in fp32 through the
all-reduce and rounds once to the compute type
(:meth:`TensorParallel.reduce_partial`), as one rank's GEMM rounds its
fp32 accumulator once: twice the bytes of a bf16 all-reduce, for logits
closer to one rank's (NVIDIA H100 80GB HBM3, 700 W, Llama-3-8B over 2
ranks: 0.086 from serve's at most, against 0.102 with bf16 partial sums;
PERF.md §6).

Everything else (the other norms, RoPE, residuals, sampling, the whisper
encoder's output) runs whole on every rank, on identical values.

One device, serving, computes what 2 ranks split by the halves that they
hold (``ssm._head_parts``, ``attention._halves``, ``mlp.mlp``,
``layers.logits``): each half's column products and per-head work with a
rank's shapes, the sums over a split dim as the two halves' fp32
partials added.  The sum of two terms does not depend on their order, so
2 ranks give one device's bits.  In bf16 that matters: a bit that differs
in an early layer grows to the logits' whole bf16 noise, past the greedy
tokens' margins of mamba2-780m's 48 layers (``tools/tp_bits.py``).  The
MoE experts and MLA are not split so: their ranks stay within bf16 noise
of one device.

A :class:`TensorParallel` context carries the
rank's place and its collectives, which go through a
``multihost.MeshComm``'s ``model`` group, so its call, byte and second
counters count them.  :func:`tensor_parallel` builds it from the
reference's ``rules`` (``sharding.rules_for_mesh(mesh)``), once a mesh,
after :meth:`~repro_torch.distributed.sharding.ShardingRules.check` has
refused what the port does not serve over a model axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import ShardingRules


@dataclass(frozen=True, eq=False)
class TensorParallel:
    """One rank's place on the model axis: ``size`` ranks, this one at
    ``index``, its collectives through ``comm`` (a ``MeshComm``) and its
    mesh coordinates by axis name (``coords``, for ``params.shard_specs``).
    """

    comm: object

    @property
    def size(self) -> int:
        return self.comm.model_size

    @property
    def index(self) -> int:
        return self.comm.model_index

    @property
    def coords(self) -> dict[str, int]:
        mesh = self.comm.mesh
        return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the model ranks."""
        return self.comm.all_reduce(x, over="model")

    def reduce_partial(self, y: torch.Tensor, dtype: torch.dtype
                       ) -> torch.Tensor:
        """The sum of the fp32 partial ``y`` over the model ranks, added
        in fp32 and rounded to ``dtype`` once."""
        return self.all_reduce(y).to(dtype)

    def row_parallel(self, x: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
        """``x @ w`` where ``x`` holds this rank's columns and ``w`` its
        rows, summed over the model ranks: the partial products in fp32,
        added in fp32, rounded to ``x``'s type once."""
        return self.reduce_partial(fp32_product(x, w), x.dtype)

    def gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every model rank's ``x`` joined along the last dim, in rank
        order (each rank holds one slice of that dim)."""
        parts = self.comm.all_gather(x, over="model")  # (t, ..., n)
        return parts.movedim(0, -2).reshape(*x.shape[:-1], -1)


def fp32_product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` accumulated and returned in fp32, for a partial sum over
    the model ranks: fp32 operands take the plain product; on the card
    bf16 ones take ``torch.mm`` / ``torch.bmm`` with ``out_dtype``, and
    the CPU, which has no mixed-type product, upcasts them.  ``w`` is 2-D
    (``x``'s rows flattened) or, with ``x``, 3-D (a batched product)."""
    if x.dtype == torch.float32:
        return x @ w
    if w.dim() == 3:
        if x.is_cuda:
            return torch.bmm(x, w, out_dtype=torch.float32)
        return torch.bmm(x.float(), w.float())
    flat = x.reshape(-1, x.shape[-1])
    if flat.is_cuda:
        y = torch.mm(flat, w, out_dtype=torch.float32)
    else:
        y = flat.float() @ w.float()
    return y.reshape(*x.shape[:-1], w.shape[-1])


#: (config, rules, id of the mesh) -> (the mesh, kept alive, its context).
_CONTEXTS: dict[tuple, tuple[object, TensorParallel]] = {}


def tensor_parallel(cfg: ModelConfig, rules: ShardingRules | None
                    ) -> TensorParallel | None:
    """The context of this rank for serving ``cfg`` under ``rules``, or
    None where the model axis has one rank (the single-device path, the
    data-parallel one).  Raises ``NotImplementedError`` naming ROADMAP.md
    for what the port does not serve over a model axis (a split that cuts
    a head or an SSD rank's B/C groups, experts the ranks do not divide, a
    cache only a sequence split could place), before it touches any
    process group."""
    if rules is None or rules.size(rules.tp) == rules.size(rules.sp) \
            == rules.size(rules.ep) == 1:
        return None
    key = (cfg, rules, id(rules.mesh))
    if key in _CONTEXTS:
        return _CONTEXTS[key][1]
    from repro_torch.models import get_model
    from repro_torch.models.params import named_specs

    axes = {"sp"}  # the decode cache, sequence-tagged in the reference
    for _, spec in named_specs(get_model(cfg).specs()):  # "ep" included
        axes.update(a for a in spec.logical_axes if a is not None)
    rules.check(*sorted(axes), serving=cfg)
    if rules.mesh is None:
        raise ValueError("rules over a model axis larger than 1 need their "
                         "mesh: make them with rules_for_mesh(mesh)")
    from repro_torch.distributed.multihost import MeshComm

    dp = rules.dp if isinstance(rules.dp, (tuple, list)) else (
        () if rules.dp is None else (rules.dp,))
    tp = TensorParallel(MeshComm(rules.mesh, tuple(dp), model_axis=rules.tp))
    _CONTEXTS[key] = (rules.mesh, tp)
    return tp
