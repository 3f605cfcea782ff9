"""Dense MLP (SwiGLU, llama-style), as ``repro/models/mlp.py``, with the
reference's Megatron axes: over a model axis ``w_gate``/``w_up`` hold the
rank's columns and ``w_down`` its rows, so the rank's output is a partial
sum, added over the model ranks by one all-reduce
(``TensorParallel.row_parallel``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import axis_if, tp_ok
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


def mlp(params, x: torch.Tensor, cfg: ModelConfig, tp=None) -> torch.Tensor:
    cd = cfg.cdtype
    g = x @ params.w_gate.to(cd)
    u = x @ params.w_up.to(cd)
    h, w_down = F.silu(g) * u, params.w_down.to(cd)
    if tp is not None and params.specs["w_down"].part is not None:
        return tp.row_parallel(h, w_down)
    return h @ w_down
