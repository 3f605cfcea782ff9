"""GQA attention for training, prefill and decode, as
``repro/models/attention.py``.

Training and prefill are causal.  Prefill goes to the flash kernel
(``kernels/flash_attention.py``) when ``cfg.flash_attention`` is on;
otherwise, and always in training (the reference's ``allow_flash=(mode !=
"train")``: the kernel has no backward), to the plain chunked attention,
which the reference also computes outside Pallas.  In training each query
chunk is recomputed in backward (the reference's per-chunk
``jax.checkpoint``), so backward holds one chunk's fp32 scores at a time.
Decode attends one new token over the whole ``s_max`` cache in fp32, plain
PyTorch as in the reference, and writes the token's K/V into the cache in
place.  Its position is a 0-d device tensor, as the reference's traced
``pos``: no host value enters the step, so a CUDA graph can capture it
(``serving/engine.py``).  The cache holds the un-repeated KV heads.  MLA
and cross-attention wait (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import apply_rope, recompute
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor
NEG_INF = -1e30


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {
        "wq": ParamSpec((d, h * hd), cfg.pdtype),
        "wk": ParamSpec((d, kv * hd), cfg.pdtype),
        "wv": ParamSpec((d, kv * hd), cfg.pdtype),
        "wo": ParamSpec((h * hd, d), cfg.pdtype),
    }


def _sdpa_chunk(qc: Tensor, kf: Tensor, vf: Tensor, c0: int, causal: bool,
                scale: float) -> Tensor:
    """One query chunk (rows ``c0`` on) against fp32 K/V, in fp32."""
    qf = qc.to(torch.float32) * scale
    scores = torch.einsum("bqhd,bshd->bhqs", qf, kf)
    if causal:
        rows = torch.arange(c0, c0 + qf.shape[1], device=qc.device)
        mask = rows[:, None] >= torch.arange(kf.shape[1],
                                             device=qc.device)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", probs, vf).to(qc.dtype)


def _sdpa_chunked(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                  q_chunk: int, scale: float) -> Tensor:
    """Exact attention over query chunks of ``q_chunk`` rows (scores peak at
    (B, H, q_chunk, S_k)); (B, S, H, hd) layout, GQA KV already repeated.
    While autograd records, each chunk is recomputed in backward."""
    sq = q.shape[1]
    ck = min(q_chunk, sq)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    outs = [recompute(_sdpa_chunk, q[:, c0:c0 + ck], kf, vf, c0, causal,
                      scale) for c0 in range(0, sq, ck)]
    return torch.cat(outs, dim=1)


def repeat_kv(x: Tensor, n_rep: int) -> Tensor:
    """(B, S, KV, hd) -> (B, S, KV * n_rep, hd), GQA group-expansion."""
    if n_rep == 1:
        return x
    b, s, kv, hd = x.shape
    x = x[:, :, :, None, :].expand(b, s, kv, n_rep, hd)
    return x.reshape(b, s, kv * n_rep, hd)


def _split_heads(x: Tensor, n: int, hd: int) -> Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def attention(params, x: Tensor, positions: Tensor, cfg: ModelConfig,
              *, train: bool = False) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """Causal self-attention over (B, S, d); returns ``(y, (k, v))`` with the
    un-repeated (B, S, KV, hd) K/V for the cache.  ``train`` never takes the
    flash kernel."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cd = cfg.cdtype
    q = _split_heads(x @ params.wq.to(cd), h, hd)
    k = _split_heads(x @ params.wk.to(cd), kv, hd)
    v = _split_heads(x @ params.wv.to(cd), kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    cache = (k, v)
    k, v = repeat_kv(k, h // kv), repeat_kv(v, h // kv)
    b, s = q.shape[:2]
    scale = 1.0 / float(hd) ** 0.5
    if cfg.flash_attention and not train:
        out = fa.flash_attention(q, k, v, causal=True, scale=scale)
    else:
        out = _sdpa_chunked(q, k, v, causal=True, q_chunk=cfg.q_chunk,
                            scale=scale)
    return out.reshape(b, s, h * hd) @ params.wo.to(cd), cache


def attention_decode(params, x: Tensor, cache_k: Tensor, cache_v: Tensor,
                     pos: Tensor, cfg: ModelConfig) -> Tensor:
    """One new token (B, 1, d) at position ``pos`` (a 0-d integer tensor on
    ``x``'s device) against the (B, S_max, KV, hd) caches, which it updates
    in place at ``pos``."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    g = h // kv
    cd = cfg.cdtype
    b = x.shape[0]
    s_max = cache_k.shape[1]
    at = pos.reshape(1).to(torch.long)
    positions = at.expand(b, 1)
    q = apply_rope(_split_heads(x @ params.wq.to(cd), h, hd), positions,
                   cfg.rope_theta)
    k_new = apply_rope(_split_heads(x @ params.wk.to(cd), kv, hd), positions,
                       cfg.rope_theta)
    v_new = _split_heads(x @ params.wv.to(cd), kv, hd)
    cache_k.index_copy_(1, at, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v_new.to(cache_v.dtype))

    qf = q.reshape(b, 1, kv, g, hd).to(torch.float32) / float(hd) ** 0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, cache_k.to(torch.float32))
    mask = torch.arange(s_max, device=x.device) <= pos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache_v.to(torch.float32))
    return out.to(cd).reshape(b, 1, h * hd) @ params.wo.to(cd)
