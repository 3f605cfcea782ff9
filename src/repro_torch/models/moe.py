"""Mixture-of-Experts FFN with two dispatch strategies, as
``repro/models/moe.py``.

``grouped`` (training and prefill)
    Capacity dispatch with the batch row as the dispatch group: each
    (row, expert) takes at most ``cap`` assignments, ranked by a cumsum
    over the row's sequence-major assignments; the rest are dropped.  The
    experts run as one batched product over a (B, E, cap, d) buffer.
``gather`` (decode, one token a row)
    The top-k experts' weights gathered per token and contracted with it:
    only the useful products.

Shared experts (Qwen style) are a dense MLP added to the routed output.
The router's aux loss is Switch-style load balancing.  Nothing here has a
data-dependent shape or reads a value back to the host (no ``nonzero``, no
boolean-mask indexing, no ``.item()``), so a decode that routes can be
captured in a CUDA graph.  Top-k takes ties as ``jax.lax.top_k`` (a stable
descending sort: the lower expert first), and the aux loss's counts are
integer sums, the same on every run.  Expert parallelism (``moe_ep``)
needs a model-parallel mesh; on one rank the experts keep the non-EP
layout.  Plain PyTorch, as the reference computes MoE outside any Pallas
kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import TP_SIZE, axis_if, tp_ok
from repro_torch.models.mlp import mlp, mlp_specs
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


def _use_ep(cfg: ModelConfig) -> bool:
    """The reference's expert-parallel layout (moe.py:35-38)."""
    return bool(cfg.moe_ep) and cfg.moe.num_experts % TP_SIZE == 0


def moe_specs(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    d, ff, e = cfg.d_model, moe.d_ff_expert, moe.num_experts
    # The reference's axes (declarations: the port refuses MoE over a
    # model axis larger than 1 at build).
    if _use_ep(cfg):
        up = down = ("ep", None, None)
    else:
        ff_tp = axis_if(tp_ok(ff), "tp")
        up, down = (None, "fsdp", ff_tp), (None, ff_tp, "fsdp")
    spec = {
        "router": ParamSpec((d, e), torch.float32, axes=(None, None)),
        "w_gate": ParamSpec((e, d, ff), cfg.pdtype, axes=up),
        "w_up": ParamSpec((e, d, ff), cfg.pdtype, axes=up),
        "w_down": ParamSpec((e, ff, d), cfg.pdtype, axes=down),
    }
    if moe.num_shared:
        spec["shared"] = mlp_specs(cfg, d_ff=moe.d_ff_shared)
    return spec


def _route(params, x: Tensor, cfg: ModelConfig
           ) -> tuple[Tensor, Tensor, Tensor]:
    """Top-k routing of x (B, S, d) in fp32: the weights (B, S, k) in x's
    type, the expert ids (B, S, k) and the aux loss."""
    moe = cfg.moe
    num = moe.num_experts
    probs = torch.softmax(x.to(torch.float32) @ params.router, dim=-1)
    ids = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[..., :moe.top_k]
    w = probs.gather(-1, ids)
    w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
    # Switch-style load balancing: E * sum_e(frac_tokens_e * mean_prob_e).
    experts = torch.arange(num, device=x.device)
    counts = (ids.reshape(-1, 1) == experts).sum(0).to(torch.float32)
    frac_tok = counts / torch.clamp_min(counts.sum(), 1.0)
    frac_prob = probs.mean(dim=(0, 1))
    aux = num * torch.sum(frac_tok * frac_prob) * moe.router_aux_weight
    return w.to(x.dtype), ids, aux


def capacity(cfg: ModelConfig, s: int) -> int:
    """Assignments an expert takes from one row of ``s`` tokens: the
    reference's expression, to the letter."""
    moe = cfg.moe
    return max(8, int(s * moe.top_k / moe.num_experts * moe.capacity_factor
                      + 0.999) // 8 * 8)


def _slots(ids: Tensor, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """Each assignment's buffer slot and whether it is kept, (B, S k) in
    sequence-major order: expert ``e``'s slots are ``e cap .. e cap + cap -
    1``, taken in rank order (a cumsum over the row's assignments); an
    assignment ranked past ``cap`` is dropped to a trash slot of its own,
    past the experts', so every slot is written once."""
    b, s, k = ids.shape
    e = cfg.moe.num_experts
    cap = capacity(cfg, s)
    flat_ids = ids.reshape(b, 1, s * k)
    experts = torch.arange(e, device=ids.device)[None, :, None]
    onehot = (flat_ids == experts).to(torch.int32)  # (B, E, S k)
    # The rank of each assignment: the cumsum runs along the last axis.
    ranks = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    rank = ranks.gather(1, flat_ids)[:, 0]
    flat_ids = flat_ids[:, 0]
    keep = rank < cap
    trash = e * cap + torch.arange(s * k, device=ids.device)
    return torch.where(keep, flat_ids * cap + rank, trash), keep


def _moe_grouped(params, x: Tensor, w: Tensor, ids: Tensor,
                 cfg: ModelConfig) -> Tensor:
    """Capacity dispatch, group = batch row."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = capacity(cfg, s)
    slot, keep = _slots(ids, cfg)

    xk = x.repeat_interleave(k, dim=1)  # (B, S k, d): a token per assignment
    buf = torch.zeros(b, e * cap + s * k, d, dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot[..., None].expand(b, s * k, d), xk)
    buf = buf[:, :e * cap].reshape(b, e, cap, d)

    cd = cfg.cdtype
    g = torch.einsum("becd,edf->becf", buf, params.w_gate.to(cd))
    u = torch.einsum("becd,edf->becf", buf, params.w_up.to(cd))
    out = torch.einsum("becf,efd->becd", F.silu(g) * u,
                       params.w_down.to(cd))

    # Back to the assignments, weighted (a dropped one's trash-slot read is
    # masked by ``keep``), summed over each token's k.
    out_flat = out.reshape(b, e * cap, d)
    safe_slot = torch.clamp_max(slot, e * cap - 1)
    y = out_flat.gather(1, safe_slot[..., None].expand(b, s * k, d))
    y = y * (w.reshape(b, s * k, 1) * keep[..., None]).to(y.dtype)
    return y.reshape(b, s, k, d).sum(dim=2)


def _moe_gather(params, x: Tensor, w: Tensor, ids: Tensor,
                cfg: ModelConfig) -> Tensor:
    """Per-token expert gather (decode shapes): each token's top-k
    experts' weights taken along the expert axis (``jnp.take``) and
    contracted with it.  One gathered weight (T, k, ., .) is alive at a
    time."""
    b, s, d = x.shape
    cd = cfg.cdtype
    xt = x.reshape(b * s, d)
    idt = ids.reshape(b * s, -1)  # (T, k)
    wt = w.reshape(b * s, -1)

    def take(weight: Tensor) -> Tensor:  # (T, k, ., .)
        rows = torch.index_select(weight, 0, idt.reshape(-1))
        return rows.reshape(*idt.shape, *weight.shape[1:]).to(cd)

    # Batched over (token, expert) on the gathered layout, as
    # "td,tkdf->tkf" and "tkf,tkfd->tkd" without a transposed copy.
    xq = xt[:, None, None, :]  # (T, 1, 1, d)
    g = xq @ take(params.w_gate)  # (T, k, 1, f)
    u = xq @ take(params.w_up)
    out = (F.silu(g) * u) @ take(params.w_down)  # (T, k, 1, d)
    y = (out[:, :, 0] * wt[..., None].to(out.dtype)).sum(dim=1)
    return y.reshape(b, s, d)


def moe_ffn(params, x: Tensor, cfg: ModelConfig, *,
            dispatch: str | None = None) -> tuple[Tensor, Tensor]:
    """Returns ``(y, aux)``.  ``dispatch`` None picks by shape: one token a
    row gathers, longer rows go grouped."""
    if dispatch is None:
        dispatch = "gather" if x.shape[1] == 1 else "grouped"
    w, ids, aux = _route(params, x, cfg)
    if dispatch == "grouped":
        y = _moe_grouped(params, x, w, ids, cfg)
    elif dispatch == "gather":
        y = _moe_gather(params, x, w, ids, cfg)
    else:
        raise ValueError(f"unknown dispatch {dispatch!r}")
    if cfg.moe.num_shared:
        y = y + mlp(params.shared, x, cfg)
    return y, aux
