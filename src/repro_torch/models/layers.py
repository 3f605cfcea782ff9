"""Shared model primitives: RMSNorm, RoPE, embeddings, as
``repro/models/layers.py``.  ``chunked_cross_entropy`` waits for training."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


def padded_vocab(vocab: int) -> int:
    """Pad embedding tables to a multiple of 256, as the reference."""
    return -(-vocab // 256) * 256


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), torch.float32, init="ones")


def rmsnorm(w: Tensor, x: Tensor, eps: float = 1e-5) -> Tensor:
    """RMSNorm with fp32 internals, cast back to ``x``'s type."""
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(dt)


def rope_freqs(hd: int, theta: float, device=None) -> Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (B, S, H, hd); positions: (B, S).  Rotates the two halves
    ``x1, x2 = split(x, 2)`` as the reference does (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (B, S, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_specs(cfg: ModelConfig) -> dict:
    pv = padded_vocab(cfg.vocab)
    spec = {"table": ParamSpec((pv, cfg.d_model), cfg.pdtype, scale=1.0)}
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((cfg.d_model, pv), cfg.pdtype)
    return spec


def embed(params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    return params.table[tokens].to(cfg.cdtype)


def unembed_matrix(params) -> Tensor:
    if hasattr(params, "unembed"):
        return params.unembed
    return params.table.T
