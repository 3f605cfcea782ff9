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
integer sums, the same on every run.  Plain PyTorch, as the reference
computes MoE outside any Pallas kernel.

Over a model axis (``tp``, a ``models.parallel.TensorParallel``) a rank
holds the reference's slice of the experts (``moe_specs``' axes):

* by ff columns (every shipped config): ``w_gate``/``w_up`` (E, d, ff/t)
  and ``w_down`` (E, ff/t, d); the rank runs every expert on its columns;
* by expert where the reference's ``_use_ep`` holds (``moe_ep`` and
  experts a multiple of ``TP_SIZE``): (E/t, d, ff) each; the rank runs its
  experts on its slice of the replicated dispatch buffer, the slot gather
  reads only its slots (the rest masked to zero), and the decode gather
  takes only its experts for each token (the rest zeroed).

Either way ``w_down``'s product is accumulated in fp32, the routed output
is combined (slot gather, routing weight, sum over k) into a (B, S, d)
fp32 partial, the shared expert's partial joins it, and one all-reduce a
layer sums them (``TensorParallel.reduce_partial``): the combine is linear
in the experts' outputs, so reducing (B, S, d) moves k·E·cap/(S·k) times
fewer bytes than reducing the (B, E·cap, d) buffer.  The router runs on
the replicated residual stream, so every rank routes every token alike
as long as every all-reduce hands every rank the same bits.  A weight the
model ranks do not divide stays whole (``params.shard_parts``) and is
computed whole on every rank, outside the sum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import TP_SIZE, axis_if, tp_ok
from repro_torch.models.mlp import is_split, mlp, mlp_partial, mlp_specs
from repro_torch.models.parallel import fp32_product
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


def _use_ep(cfg: ModelConfig) -> bool:
    """The reference's expert-parallel layout (moe.py:35-38)."""
    return bool(cfg.moe_ep) and cfg.moe.num_experts % TP_SIZE == 0


def moe_specs(cfg: ModelConfig) -> dict:
    moe = cfg.moe
    d, ff, e = cfg.d_model, moe.d_ff_expert, moe.num_experts
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


def _dispatch(x: Tensor, slot: Tensor, cfg: ModelConfig) -> Tensor:
    """The (B, E, cap, d) buffer: each kept assignment's token in its
    slot, zeros elsewhere."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = capacity(cfg, s)
    xk = x.repeat_interleave(k, dim=1)  # (B, S k, d): a token per assignment
    buf = torch.zeros(b, e * cap + s * k, d, dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot[..., None].expand(b, s * k, d), xk)
    return buf[:, :e * cap].reshape(b, e, cap, d)


def _moe_grouped(params, x: Tensor, w: Tensor, ids: Tensor,
                 cfg: ModelConfig) -> Tensor:
    """Capacity dispatch, group = batch row."""
    b, s, d = x.shape
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = capacity(cfg, s)
    slot, keep = _slots(ids, cfg)
    buf = _dispatch(x, slot, cfg)

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


def _experts_held(params, cfg: ModelConfig) -> tuple[int, int] | None:
    """The experts this rank's routed weights cover, ``(first, count)``:
    all E under the ff split, its E/t under ``ep``; None where the
    weights are whole (one rank, or dims the model ranks do not divide)."""
    part = params.specs["w_gate"].part
    if part is None:
        return None
    (n, index), e = part[0], cfg.moe.num_experts
    return index * (e // n), e // n


def _experts_on_rank(params, xe: Tensor, cfg: ModelConfig) -> Tensor:
    """The rank's experts on their tokens: ``xe`` (n, T, d) in the
    compute type, one row of tokens an expert; the fp32 partial (n, T, d)
    of the rank's ff columns (all of them under ``ep``)."""
    cd = cfg.cdtype
    g = torch.bmm(xe, params.w_gate.to(cd))
    u = torch.bmm(xe, params.w_up.to(cd))
    return fp32_product(F.silu(g) * u, params.w_down.to(cd))


def _grouped_partial(params, x: Tensor, w: Tensor, ids: Tensor,
                     cfg: ModelConfig, first: int, count: int) -> Tensor:
    """Capacity dispatch on a rank: experts ``first .. first + count - 1``
    of the replicated buffer through the rank's weights, combined into
    the (B, S, d) fp32 partial of the routed output.  Slots of other
    ranks' experts (and dropped assignments) read as zero."""
    b, s, d = x.shape
    k = cfg.moe.top_k
    cap = capacity(cfg, s)
    slot, keep = _slots(ids, cfg)
    buf = _dispatch(x, slot, cfg)[:, first:first + count]
    # Expert-major rows (n, B cap, d): one batched product an expert.
    xe = buf.transpose(0, 1).reshape(count, b * cap, d)
    out = _experts_on_rank(params, xe, cfg).reshape(count * b * cap, d)
    # Slot (row i, e cap + c) of the rank's expert e sits at row
    # (e b + i) cap + c of the expert-major output.
    local = slot - first * cap
    mine = keep & (local >= 0) & (local < count * cap)
    local = torch.clamp(local, 0, count * cap - 1)
    rows = torch.arange(b, device=x.device)[:, None]
    at = ((local // cap) * b + rows) * cap + local % cap  # (B, S k)
    y = out.index_select(0, at.reshape(-1)).reshape(b, s * k, d)
    y = y * (w.reshape(b, s * k, 1).to(torch.float32) * mine[..., None])
    return y.reshape(b, s, k, d).sum(dim=2)


def _gather_partial(params, x: Tensor, w: Tensor, ids: Tensor,
                    cfg: ModelConfig, first: int, count: int) -> Tensor:
    """The per-token gather on a rank: each token's top-k experts taken
    from the rank's weights (an expert another rank holds is read at a
    clamped index and zeroed), the (B, S, d) fp32 partial of the routed
    output."""
    b, s, d = x.shape
    k = ids.shape[-1]
    local = ids.reshape(-1) - first  # (T k,)
    mine = (local >= 0) & (local < count)
    local = torch.clamp(local, 0, count - 1)
    cd = cfg.cdtype

    def take(weight: Tensor) -> Tensor:  # (T k, ., .)
        return torch.index_select(weight, 0, local).to(cd)

    xq = x.reshape(b * s, 1, d).repeat_interleave(k, dim=0)  # (T k, 1, d)
    g = torch.bmm(xq, take(params.w_gate))
    u = torch.bmm(xq, take(params.w_up))
    out = fp32_product(F.silu(g) * u, take(params.w_down))  # (T k, 1, d)
    scale = w.reshape(-1).to(torch.float32) * mine
    y = (out[:, 0] * scale[:, None]).reshape(b * s, k, d).sum(dim=1)
    return y.reshape(b, s, d)


def moe_ffn(params, x: Tensor, cfg: ModelConfig, *,
            dispatch: str | None = None, tp=None) -> tuple[Tensor, Tensor]:
    """Returns ``(y, aux)``.  ``dispatch`` None picks by shape: one token a
    row gathers, longer rows go grouped.  ``tp`` (a model axis): the
    rank's experts and shared columns, one all-reduce of their fp32
    partials."""
    if dispatch is None:
        dispatch = "gather" if x.shape[1] == 1 else "grouped"
    if dispatch not in ("grouped", "gather"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    w, ids, aux = _route(params, x, cfg)
    held = None if tp is None else _experts_held(params, cfg)
    partial = y = None
    if held is not None:
        fn = _grouped_partial if dispatch == "grouped" else _gather_partial
        partial = fn(params, x, w, ids, cfg, *held)
    elif dispatch == "grouped":
        y = _moe_grouped(params, x, w, ids, cfg)
    else:
        y = _moe_gather(params, x, w, ids, cfg)
    if cfg.moe.num_shared:
        if tp is not None and is_split(params.shared):
            shared = mlp_partial(params.shared, x, cfg)
            partial = shared if partial is None else partial + shared
        else:
            shared = mlp(params.shared, x, cfg)
            y = shared if y is None else y + shared
    if partial is not None:
        summed = tp.reduce_partial(partial, cfg.cdtype)
        y = summed if y is None else y + summed
    return y, aux
