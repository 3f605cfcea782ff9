"""GQA attention (self and cross) and MLA for training, prefill and
decode, as ``repro/models/attention.py``.

Self-attention is causal unless ``causal=False`` (the whisper encoder);
given a ``ctx`` (B, T, d), K and V come from it, without RoPE and without a
mask (cross-attention).  Self-attention outside training goes to the flash
kernel (``kernels/flash_attention.py``) when the caller allows it and
``cfg.flash_attention`` is on (the reference's ``allow_flash``, which only
self-attention layers outside training pass: the kernel has no backward);
everything else takes the plain chunked attention, which the reference
also computes outside Pallas.  In training each query chunk is recomputed
in backward (the reference's per-chunk ``jax.checkpoint``), so backward
holds one chunk's fp32 scores at a time.  Decode attends one new token over
the whole ``s_max`` cache in fp32, plain PyTorch as in the reference, and
writes the token's K/V into the cache in place.  Its position is a 0-d
device tensor, as the reference's traced ``pos``: no host value enters the
step, so a CUDA graph can capture it (``serving/engine.py``).  The cache
holds the un-repeated KV heads.

Over a model axis (``tp``, a ``models.parallel.TensorParallel``) a rank
attends with its own query heads (:func:`head_layout`): h/t of them when
``wq`` is split, and the KV heads they use, from its shard of ``wk``/``wv``
where those are split (t must divide the KV heads) or from their columns
where they stay whole.  The flash kernel gets those heads; ``wo`` is split
by rows, so the rank's product is a partial sum, added over the model
ranks by one all-reduce (``TensorParallel.row_parallel``).  Decode works on the rank's KV-head cache with
no collective inside attention and the one after ``wo``.

Cross-attention over a model axis is the same: K and V of the context
from the rank's ``wk``/``wv`` columns (its cache holds its KV heads),
``wo`` row-parallel (:func:`cross_decode` likewise).

MLA (DeepSeek-V2) is plain by construction, as in the reference: training
and prefill decode per-head K/V from the normalised latent and attend over
query chunks with split nope/rope fp32 scores; decode absorbs ``W_uk`` into
the query and attends over the latent cache ((B, S_max, kv_lora) and
(B, S_max, rope_dim)), updated in place at ``pos``.  Over a model axis a
rank takes h/t heads (:func:`mla_heads`): ``wq_b``, ``wkv_b`` (so the
absorbed ``W_uk``/``W_uv``) and ``wo`` hold its heads' columns and rows,
while ``wq_a``, ``wkv_a`` and the norms are whole, so every rank computes
the same latent and holds the whole latent cache; ``wo`` is row-parallel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models.layers import (
    apply_rope, axis_if, by_columns, by_halves, recompute, rmsnorm,
    rmsnorm_spec, tp_ok,
)
from repro_torch.models.parallel import fp32_product
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor
NEG_INF = -1e30


def attn_specs(cfg: ModelConfig) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q_tp = axis_if(tp_ok(h * hd), "tp")
    kv_tp = axis_if(tp_ok(kv * hd), "tp")
    return {
        "wq": ParamSpec((d, h * hd), cfg.pdtype, axes=("fsdp", q_tp)),
        "wk": ParamSpec((d, kv * hd), cfg.pdtype, axes=("fsdp", kv_tp)),
        "wv": ParamSpec((d, kv * hd), cfg.pdtype, axes=("fsdp", kv_tp)),
        "wo": ParamSpec((h * hd, d), cfg.pdtype, axes=(q_tp, "fsdp")),
    }


class HeadLayout(NamedTuple):
    """The heads one rank of ``t`` attends with: query heads ``q0`` to
    ``q0 + heads``, KV heads ``kv0`` to ``kv0 + kv_heads`` (the ones its
    cache holds), ``q_split`` where its ``wq``/``wo`` are its slices and
    ``kv_split`` where its ``wk``/``wv`` are (else they are whole and the
    rank takes the columns of its KV heads)."""
    heads: int
    q0: int
    kv_heads: int
    kv0: int
    q_split: bool
    kv_split: bool

    @property
    def group(self) -> int:
        """Query heads a KV head serves on this rank."""
        return self.heads // self.kv_heads


def head_layout(cfg: ModelConfig, ranks: int = 1, index: int = 0
                ) -> HeadLayout:
    """Rank ``index`` of ``ranks`` on the model axis.  A tagged dim splits
    where its size divides by ``ranks`` (``params.shard_parts``).  Raises
    ``NotImplementedError`` naming ROADMAP.md where the heads cannot be
    placed whole: a split that cuts a head, or split ``wk``/``wv`` over
    more ranks than KV heads, whose cache only the reference's sequence
    split (``sp``) could place."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q_split = ranks > 1 and tp_ok(h * hd) and h * hd % ranks == 0
    kv_split = ranks > 1 and tp_ok(kv * hd) and kv * hd % ranks == 0
    if q_split and h % ranks:
        raise NotImplementedError(
            f"{cfg.name}: {h} query heads do not split over {ranks} model "
            f"ranks (ROADMAP.md, Queue 1, item 14)")
    if kv_split and (kv % ranks or not q_split):
        raise NotImplementedError(
            f"{cfg.name}: wk/wv split over {ranks} model ranks would cut "
            f"its {kv} KV heads; only a sequence split (sp) of the cache "
            f"could place them, which waits for a later slice (ROADMAP.md, "
            f"Queue 1, item 14)")
    heads = h // ranks if q_split else h
    q0 = index * heads if q_split else 0
    if kv_split:
        return HeadLayout(heads, q0, kv // ranks, index * (kv // ranks),
                          True, True)
    g = h // kv
    if heads % g and g % heads:
        raise NotImplementedError(
            f"{cfg.name}: {heads} query heads a rank straddle its KV "
            f"groups of {g} (ROADMAP.md, Queue 1, item 14)")
    return HeadLayout(heads, q0, max(1, heads // g), q0 // g, q_split,
                      False)


def _kv_weights(params, lay: HeadLayout, cfg: ModelConfig
                ) -> tuple[Tensor, Tensor]:
    """``wk``, ``wv`` of the rank's KV heads: its shards, or the columns
    of those heads where the weights are whole."""
    wk, wv = params.wk, params.wv
    if lay.kv_split or lay.kv_heads == cfg.n_kv_heads:
        return wk, wv
    cols = slice(lay.kv0 * cfg.hd, (lay.kv0 + lay.kv_heads) * cfg.hd)
    return wk[:, cols], wv[:, cols]


def _layout(cfg: ModelConfig, tp) -> HeadLayout:
    return head_layout(cfg) if tp is None else head_layout(
        cfg, tp.size, tp.index)


def _halves(cfg: ModelConfig, tp) -> list[HeadLayout] | None:
    """Serving on the whole heads (one device, or a rank that holds them
    all), the layouts of the 2 ranks whose split it computes by (None
    where the model axis ``tp`` splits ``wq``, where autograd runs, or
    where 2 ranks would not split ``wq``).  The Q/K/V products are each
    half's columns' (``layers.by_columns``), the plain attention runs each
    half of the heads apart, so that its batched products have a rank's
    shapes and so its bits, and ``wo``'s product is the sum of the halves'
    fp32 partials, as 2 ranks add theirs: then 2 ranks give one device's
    bits (the flash kernel's heads do not depend on each other).  In bf16
    any bit that differs grows, layer by layer, to the logits' whole bf16
    noise (tools/tp_bits.py)."""
    if not by_halves() or _layout(cfg, tp).q_split:
        return None
    try:
        halves = [head_layout(cfg, 2, i) for i in range(2)]
    except NotImplementedError:  # a head or a KV group cut in two
        return None
    return halves if halves[0].q_split else None


def _columns(halves: list[HeadLayout] | None, hd: int, kv: bool = False
             ) -> list[slice] | None:
    """The column slices of the ``halves``' query (or KV) heads, each span
    once (two halves that read one whole KV head share it)."""
    if halves is None:
        return None
    spans = []
    for lay in halves:
        span = (lay.kv0, lay.kv_heads) if kv else (lay.q0, lay.heads)
        if span not in spans:
            spans.append(span)
    return [slice(a * hd, (a + n) * hd) for a, n in spans]


def _apart(core, halves: list[HeadLayout] | None, q: Tensor, k: Tensor,
           v: Tensor) -> Tensor:
    """``core(q, k, v)`` over (B, S, H, hd) query heads and their K/V
    (repeated to H heads): each of the ``halves`` apart, joined."""
    if halves is None:
        return core(q, k, v)
    return torch.cat([core(*(t[:, :, lay.q0:lay.q0 + lay.heads]
                             for t in (q, k, v))) for lay in halves], dim=2)


def _out_proj(params, out: Tensor, lay: HeadLayout, cfg: ModelConfig,
              tp, halves: list[HeadLayout] | None = None) -> Tensor:
    """(B, S, heads * hd) @ ``wo``, summed over the model ranks where
    ``wo`` holds the rank's rows, or over the ``halves``' rows."""
    wo = params.wo.to(cfg.cdtype)
    if lay.q_split:
        return tp.row_parallel(out, wo)
    if halves is None:
        return out @ wo
    rows = [slice(h.q0 * cfg.hd, (h.q0 + h.heads) * cfg.hd) for h in halves]
    part = [fp32_product(out[..., r].contiguous(), wo[r]) for r in rows]
    return (part[0] + part[1]).to(cfg.cdtype)


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
              *, causal: bool = True, ctx: Tensor | None = None,
              allow_flash: bool = False, tp=None
              ) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """Self-attention over (B, S, d), or cross-attention over ``ctx`` (B,
    T, d) when it is given (no RoPE, no mask); returns ``(y, (k, v))`` with
    the un-repeated (B, S or T, KV, hd) K/V for the cache (the rank's KV
    heads over a model axis ``tp``).  The flash kernel runs only where
    ``allow_flash`` and ``cfg.flash_attention``."""
    lay, halves = _layout(cfg, tp), _halves(cfg, tp)
    hd = cfg.hd
    cd = cfg.cdtype
    kv_src = x if ctx is None else ctx
    wk, wv = _kv_weights(params, lay, cfg)
    qc, kc = _columns(halves, hd), _columns(halves, hd, kv=True)
    q = _split_heads(by_columns(x, params.wq.to(cd), qc), lay.heads, hd)
    k = _split_heads(by_columns(kv_src, wk.to(cd), kc), lay.kv_heads, hd)
    v = _split_heads(by_columns(kv_src, wv.to(cd), kc), lay.kv_heads, hd)
    if ctx is None:  # RoPE only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    cache = (k, v)
    k, v = repeat_kv(k, lay.group), repeat_kv(v, lay.group)
    b, s = q.shape[:2]
    scale = 1.0 / float(hd) ** 0.5
    causal = causal and ctx is None
    if allow_flash and cfg.flash_attention:
        out = fa.flash_attention(q, k, v, causal=causal, scale=scale)
    else:
        out = _apart(lambda q, k, v: _sdpa_chunked(
            q, k, v, causal=causal, q_chunk=cfg.q_chunk, scale=scale),
            halves, q, k, v)
    return _out_proj(params, out.reshape(b, s, lay.heads * hd), lay, cfg,
                     tp, halves), cache


def attention_decode(params, x: Tensor, cache_k: Tensor, cache_v: Tensor,
                     pos: Tensor, cfg: ModelConfig, tp=None) -> Tensor:
    """One new token (B, 1, d) at position ``pos`` (a 0-d integer tensor on
    ``x``'s device) against the (B, S_max, KV, hd) caches (the rank's KV
    heads over a model axis ``tp``), which it updates in place at
    ``pos``."""
    lay, halves = _layout(cfg, tp), _halves(cfg, tp)
    h, kv, hd = lay.heads, lay.kv_heads, cfg.hd
    cd = cfg.cdtype
    b = x.shape[0]
    at = pos.reshape(1).to(torch.long)
    positions = at.expand(b, 1)
    wk, wv = _kv_weights(params, lay, cfg)
    qc, kc = _columns(halves, hd), _columns(halves, hd, kv=True)
    q = apply_rope(_split_heads(by_columns(x, params.wq.to(cd), qc), h, hd),
                   positions, cfg.rope_theta)
    k_new = apply_rope(_split_heads(by_columns(x, wk.to(cd), kc), kv, hd),
                       positions, cfg.rope_theta)
    v_new = _split_heads(by_columns(x, wv.to(cd), kc), kv, hd)
    cache_k.index_copy_(1, at, k_new.to(cache_k.dtype))
    cache_v.index_copy_(1, at, v_new.to(cache_v.dtype))
    if halves is None:
        out = _decode_core(q, cache_k, cache_v, pos)
    else:
        out = torch.cat([_decode_core(
            q[:, :, part.q0:part.q0 + part.heads],
            *(c[:, :, part.kv0:part.kv0 + part.kv_heads]
              for c in (cache_k, cache_v)), pos) for part in halves], dim=2)
    return _out_proj(params, out.to(cd).reshape(b, 1, h * hd), lay, cfg, tp,
                     halves)


def _decode_core(q: Tensor, cache_k: Tensor, cache_v: Tensor, pos: Tensor
                 ) -> Tensor:
    """One token's (B, 1, H, hd) query heads against their (B, S_max, KV,
    hd) cache up to ``pos``, in fp32: (B, 1, H, hd)."""
    b, _, h, hd = q.shape
    kv = cache_k.shape[2]
    qf = q.reshape(b, 1, kv, h // kv, hd).to(torch.float32) / float(hd) ** 0.5
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, cache_k.to(torch.float32))
    mask = torch.arange(cache_k.shape[1], device=q.device) <= pos
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, cache_v.to(torch.float32))
    return out.reshape(b, 1, h, hd)


def cross_decode(params, x: Tensor, cache_k: Tensor, cache_v: Tensor,
                 cfg: ModelConfig, tp=None) -> Tensor:
    """One token (B, 1, d) against a cross layer's static (B, T, KV, hd)
    context K/V (the reference's ``blocks._cross_decode``; the rank's KV
    heads over a model axis ``tp``): plain, one query chunk, no mask; the
    cache is only read."""
    lay, halves = _layout(cfg, tp), _halves(cfg, tp)
    hd = cfg.hd
    cd = cfg.cdtype
    b = x.shape[0]
    q = _split_heads(by_columns(x, params.wq.to(cd), _columns(halves, hd)),
                     lay.heads, hd)
    out = _apart(lambda q, k, v: _sdpa_chunked(
        q, k, v, causal=False, q_chunk=1, scale=1.0 / float(hd) ** 0.5),
        halves, q, repeat_kv(cache_k, lay.group),
        repeat_kv(cache_v, lay.group))
    return _out_proj(params, out.reshape(b, 1, lay.heads * hd), lay, cfg,
                     tp, halves)


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2)
# ---------------------------------------------------------------------------
def mla_specs(cfg: ModelConfig) -> dict:
    mla = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qd = mla.qk_nope_dim + mla.qk_rope_dim
    return {
        "wq_a": ParamSpec((d, mla.q_lora_rank), cfg.pdtype,
                          axes=("fsdp", None)),
        "q_norm": rmsnorm_spec(mla.q_lora_rank),
        "wq_b": ParamSpec((mla.q_lora_rank, h * qd), cfg.pdtype,
                          axes=(None, "tp")),
        "wkv_a": ParamSpec((d, mla.kv_lora_rank + mla.qk_rope_dim),
                           cfg.pdtype, axes=("fsdp", None)),
        "kv_norm": rmsnorm_spec(mla.kv_lora_rank),
        "wkv_b": ParamSpec(
            (mla.kv_lora_rank, h * (mla.qk_nope_dim + mla.v_head_dim)),
            cfg.pdtype, axes=(None, "tp")),
        "wo": ParamSpec((h * mla.v_head_dim, d), cfg.pdtype,
                        axes=("tp", "fsdp")),
    }


def mla_heads(cfg: ModelConfig, ranks: int = 1) -> int:
    """The MLA heads a rank of ``ranks`` holds: h / ranks where its
    ``wq_b``, ``wkv_b`` and ``wo`` split (by the reference's rule: their
    head dims divide by ``ranks``), else h.  Raises
    ``NotImplementedError`` naming ROADMAP.md where a split would cut a
    head or leave one of them whole."""
    mla, h = cfg.mla, cfg.n_heads
    widths = (mla.qk_nope_dim + mla.qk_rope_dim,
              mla.qk_nope_dim + mla.v_head_dim, mla.v_head_dim)
    splits = {ranks > 1 and h * w % ranks == 0 for w in widths}
    if splits == {False}:
        return h
    if splits != {True} or h % ranks:
        raise NotImplementedError(
            f"{cfg.name}: its {h} MLA heads do not split over {ranks} "
            f"model ranks: a rank's slice of wq_b, wkv_b and wo would cut "
            f"a head (ROADMAP.md, unported features)")
    return h // ranks


def _mla_split(params) -> bool:
    """Whether this rank holds a slice of the MLA heads (``wo``'s rows)."""
    return params.specs["wo"].part is not None


def _mla_scale(cfg: ModelConfig) -> float:
    """1 / sqrt(nope + rope): the query's width, not ``cfg.hd``."""
    return 1.0 / float(cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** 0.5


def _mla_qkv(params, x: Tensor, positions: Tensor, cfg: ModelConfig
             ) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The shared projections: ``q_nope`` (B, S, H, nope), ``q_rope`` (B,
    S, H, rope) rotated (the rank's heads: ``wq_b``'s columns), the
    normalised latent ``c_kv`` (B, S, kv_lora) and the rotated shared
    ``k_rope`` (B, S, rope)."""
    mla = cfg.mla
    cd = cfg.cdtype
    b, s, _ = x.shape
    q = rmsnorm(params.q_norm, x @ params.wq_a.to(cd), cfg.norm_eps,
                cfg.bf16_norm_grad)
    q = (q @ params.wq_b.to(cd)).reshape(
        b, s, -1, mla.qk_nope_dim + mla.qk_rope_dim)
    q_nope, q_rope = torch.split(
        q, [mla.qk_nope_dim, mla.qk_rope_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = torch.split(x @ params.wkv_a.to(cd),
                               [mla.kv_lora_rank, mla.qk_rope_dim], dim=-1)
    c_kv = rmsnorm(params.kv_norm, c_kv, cfg.norm_eps, cfg.bf16_norm_grad)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope[:, :, 0, :]


def _mla_up(params, cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """``wkv_b`` as (kv_lora, H, nope + v) (the rank's heads), split into
    ``W_uk`` (..., nope) and ``W_uv`` (..., v)."""
    mla = cfg.mla
    wkv_b = params.wkv_b.to(cfg.cdtype).reshape(
        mla.kv_lora_rank, -1, mla.qk_nope_dim + mla.v_head_dim)
    return torch.split(wkv_b, [mla.qk_nope_dim, mla.v_head_dim], dim=-1)


def _mla_chunk(qn: Tensor, qr: Tensor, kf: Tensor, rf: Tensor, vf: Tensor,
               c0: int, scale: float) -> Tensor:
    """One query chunk (rows ``c0`` on): causal split nope/rope scores in
    fp32 against the decoded K and the shared rope key."""
    sc = torch.einsum("bqhn,bshn->bhqs", qn.to(torch.float32), kf)
    sc = sc + torch.einsum("bqhr,bsr->bhqs", qr.to(torch.float32), rf)
    rows = torch.arange(c0, c0 + qn.shape[1], device=qn.device)
    mask = rows[:, None] >= torch.arange(kf.shape[1],
                                         device=qn.device)[None, :]
    sc = torch.where(mask, sc * scale, NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    return torch.einsum("bhqs,bshv->bqhv", probs, vf).to(qn.dtype)


def _mla_out(params, out: Tensor, cfg: ModelConfig, tp) -> Tensor:
    """(B, S, H, v) @ ``wo``, summed over the model ranks where ``wo``
    holds the rank's heads' rows."""
    out = out.reshape(*out.shape[:2], -1)
    wo = params.wo.to(cfg.cdtype)
    return tp.row_parallel(out, wo) if tp is not None and _mla_split(
        params) else out @ wo


def mla_attention(params, x: Tensor, positions: Tensor, cfg: ModelConfig,
                  tp=None) -> tuple[Tensor, tuple[Tensor, Tensor]]:
    """Training and prefill MLA over (B, S, d): per-head K/V decoded from
    the latent, query chunks of ``cfg.q_chunk`` (one chunk's (B, H, ck, S)
    fp32 scores alive at a time, recomputed in backward while autograd
    records).  Returns ``(y, (c_kv, k_rope))``, the latent cache (whole on
    every rank over a model axis ``tp``)."""
    s = x.shape[1]
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(params, x, positions, cfg)
    w_uk, w_uv = _mla_up(params, cfg)
    kf = torch.einsum("bsk,khn->bshn", c_kv, w_uk).to(torch.float32)
    vf = torch.einsum("bsk,khv->bshv", c_kv, w_uv).to(torch.float32)
    rf = k_rope.to(torch.float32)
    ck = min(cfg.q_chunk, s)
    scale = _mla_scale(cfg)
    out = torch.cat([recompute(_mla_chunk, q_nope[:, c0:c0 + ck],
                               q_rope[:, c0:c0 + ck], kf, rf, vf, c0, scale)
                     for c0 in range(0, s, ck)], dim=1)
    return _mla_out(params, out, cfg, tp), (c_kv, k_rope)


def mla_attention_decode(params, x: Tensor, cache_ckv: Tensor,
                         cache_rope: Tensor, pos: Tensor, cfg: ModelConfig,
                         tp=None) -> Tensor:
    """Absorbed decode of one token (B, 1, d) at ``pos`` (a 0-d integer
    tensor on ``x``'s device): ``W_uk`` folds into the query, so the
    scores and the output are taken over the latent cache itself, which
    is updated in place at ``pos`` (over a model axis ``tp`` the rank's
    heads, from its ``wkv_b`` columns, against the whole cache)."""
    cd = cfg.cdtype
    b = x.shape[0]
    s_max = cache_ckv.shape[1]
    at = pos.reshape(1).to(torch.long)
    q_nope, q_rope, c_new, r_new = _mla_qkv(params, x, at.expand(b, 1), cfg)
    cache_ckv.index_copy_(1, at, c_new.to(cache_ckv.dtype))
    cache_rope.index_copy_(1, at, r_new.to(cache_rope.dtype))

    w_uk, w_uv = _mla_up(params, cfg)
    q_lat = torch.einsum("bqhn,khn->bqhk", q_nope, w_uk)
    ckv = cache_ckv.to(torch.float32)
    sc = torch.einsum("bqhk,bsk->bhqs", q_lat.to(torch.float32), ckv)
    sc = sc + torch.einsum("bqhr,bsr->bhqs", q_rope.to(torch.float32),
                           cache_rope.to(torch.float32))
    mask = torch.arange(s_max, device=x.device) <= pos
    sc = torch.where(mask, sc * _mla_scale(cfg), NEG_INF)
    probs = torch.softmax(sc, dim=-1)
    o_lat = torch.einsum("bhqs,bsk->bqhk", probs, ckv)
    out = torch.einsum("bqhk,khv->bqhv", o_lat.to(cd), w_uv)
    return _mla_out(params, out, cfg, tp)
