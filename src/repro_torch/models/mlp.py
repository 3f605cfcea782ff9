"""Dense MLP (SwiGLU, llama-style), as ``repro/models/mlp.py``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec


def mlp_specs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    return {
        "w_gate": ParamSpec((d, ff), cfg.pdtype),
        "w_up": ParamSpec((d, ff), cfg.pdtype),
        "w_down": ParamSpec((ff, d), cfg.pdtype),
    }


def mlp(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cd = cfg.cdtype
    g = x @ params.w_gate.to(cd)
    u = x @ params.w_up.to(cd)
    return (F.silu(g) * u) @ params.w_down.to(cd)
