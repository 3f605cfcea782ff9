"""Dense MLP (SwiGLU, llama-style), as ``repro/models/mlp.py``, with the
reference's Megatron axes: over a model axis ``w_gate``/``w_up`` hold the
rank's columns and ``w_down`` its rows, so the rank's output is a partial
sum (:func:`mlp_partial`, in fp32), added over the model ranks by one
all-reduce (``TensorParallel.reduce_partial``).  An MoE layer's shared
expert adds its partial to the routed experts' before their one
all-reduce."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import axis_if, by_halves, tp_ok
from repro_torch.models.parallel import fp32_product
from repro_torch.models.params import ParamSpec


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    ff_tp = axis_if(tp_ok(ff), "tp")
    return {
        "w_gate": ParamSpec((d, ff), cfg.pdtype, axes=("fsdp", ff_tp)),
        "w_up": ParamSpec((d, ff), cfg.pdtype, axes=("fsdp", ff_tp)),
        "w_down": ParamSpec((ff, d), cfg.pdtype, axes=(ff_tp, "fsdp")),
    }


def is_split(params) -> bool:
    """Whether this rank holds a slice of the MLP's ff columns (else the
    whole MLP: one rank, or an ff the model ranks do not divide)."""
    return params.specs["w_down"].part is not None


def _hidden(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = cfg.cdtype
    return F.silu(x @ params.w_gate.to(cd)) * (x @ params.w_up.to(cd))


def mlp_partial(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """This rank's fp32 partial of the MLP's output: ``w_down``'s product
    over the rank's rows, accumulated in fp32 and not reduced."""
    return fp32_product(_hidden(params, x, cfg), params.w_down.to(cfg.cdtype))


def mlp(params, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """The MLP; over a model axis the rank's partial, reduced.  Computed
    whole and serving (no autograd), where 2 ranks would split ff, it runs
    each half of ff apart and sums the halves' fp32 partials, as those
    ranks compute and add theirs, so that they give its bits
    (``layers.by_halves``)."""
    if tp is not None and is_split(params):
        return tp.reduce_partial(mlp_partial(params, x, cfg), cfg.cdtype)
    cd = cfg.cdtype
    w_down = params.w_down.to(cd)
    ff = w_down.shape[0]
    if not (by_halves() and tp_ok(ff) and ff % 2 == 0):
        return _hidden(params, x, cfg) @ w_down
    w_gate, w_up = params.w_gate.to(cd), params.w_up.to(cd)
    part = [fp32_product(F.silu(x @ w_gate[:, c]) * (x @ w_up[:, c]),
                         w_down[c])
            for c in (slice(0, ff // 2), slice(ff // 2, ff))]
    return (part[0] + part[1]).to(cd)
