"""Shared model primitives: RMSNorm (with the reference's bf16-gradient
variant), RoPE, embeddings and the chunked cross-entropy of training, as
``repro/models/layers.py``, and the reference's gates of which dims carry
the ``tp`` and ``fsdp`` tags (:data:`TP_SIZE`, :func:`tp_ok`).

Over a model axis (a ``models.parallel.TensorParallel`` context ``tp``)
the embedding table is split by vocabulary rows: :func:`embed` gathers the
rank's rows (zeros for tokens outside them) and sums over the model
ranks, and :func:`logits` computes the rank's vocabulary slice and
gathers the whole, so that every rank samples from the same logits."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


# The reference's production meshes fix the tensor-parallel degree, and its
# ParamSpec axes are chosen against it: a dim not divisible by TP_SIZE
# carries no "tp" tag (layers.py:21-38).  Which ranks a tagged dim then
# splits over is the mesh's (params.shard_parts).
TP_SIZE = 16
FSDP_SIZE = 32  # pod x data in the multi-pod mesh (16 single-pod divides it)


def tp_ok(dim: int) -> bool:
    return dim % TP_SIZE == 0


def fsdp_ok(dim: int) -> bool:
    return dim % FSDP_SIZE == 0


def axis_if(cond: bool, name: str) -> str | None:
    return name if cond else None


def padded_vocab(vocab: int) -> int:
    """Pad embedding tables to a multiple of 256, as the reference."""
    return -(-vocab // 256) * 256


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), torch.float32, init="ones", axes=(None,))


def rmsnorm(w: Tensor, x: Tensor, eps: float = 1e-5,
            bf16_grad: bool = False) -> Tensor:
    """RMSNorm with fp32 internals, cast back to ``x``'s type.

    ``bf16_grad``: the same values, with the reference's hand-written
    backward (``_rmsnorm_bwd``): autograd of the fp32 upcast hands back the
    residual stream's gradient in fp32; this one returns dx in ``x``'s type
    (dw in fp32)."""
    if bf16_grad and torch.is_grad_enabled():
        return _RMSNormBF16Grad.apply(w, x, eps)
    return _rmsnorm(w, x, eps)


def _rmsnorm(w: Tensor, x: Tensor, eps: float) -> Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w).to(dt)


class _RMSNormBF16Grad(torch.autograd.Function):
    """RMSNorm whose backward is the reference's ``_rmsnorm_bwd``."""

    @staticmethod
    def forward(ctx, w: Tensor, x: Tensor, eps: float) -> Tensor:
        ctx.save_for_backward(w, x)
        ctx.eps = eps
        return _rmsnorm(w, x, eps)

    @staticmethod
    def backward(ctx, dy: Tensor):
        w, x = ctx.saved_tensors
        d = x.shape[-1]
        xf = x.to(torch.float32)
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + ctx.eps)
        g = dy.to(torch.float32) * w
        xg = torch.sum(xf * g, dim=-1, keepdim=True)
        dx = r * g - (r ** 3 / d) * xf * xg
        dw = torch.sum(dy.to(torch.float32) * xf * r,
                       dim=tuple(range(x.ndim - 1)))
        return dw, dx.to(x.dtype), None


def recompute(fn, *args):
    """``fn(*args)``, its intermediates recomputed in backward (a
    non-reentrant ``torch.utils.checkpoint``) while autograd records; a
    plain call otherwise.  The reference's ``jax.checkpoint`` of one
    attention query chunk or one cross-entropy chunk."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


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
    d_fsdp = axis_if(fsdp_ok(cfg.d_model), "fsdp")
    spec = {"table": ParamSpec((pv, cfg.d_model), cfg.pdtype, scale=1.0,
                               axes=("tp", d_fsdp))}
    if not cfg.tie_embeddings:
        spec["unembed"] = ParamSpec((cfg.d_model, pv), cfg.pdtype,
                                    axes=(d_fsdp, "tp"))
    return spec


def _vocab_split(params, name: str, tp) -> bool:
    """Whether ``params.<name>`` holds this rank's vocabulary slice."""
    return tp is not None and params.specs[name].part is not None


def embed(params, tokens: Tensor, cfg: ModelConfig, tp=None) -> Tensor:
    """The tokens' rows of the table in the compute type; over a model
    axis a vocab-parallel lookup: the rank's rows where the token falls in
    its slice, zeros elsewhere, summed over the model ranks."""
    if not _vocab_split(params, "table", tp):
        return params.table[tokens].to(cfg.cdtype)
    rows = params.table.shape[0]
    local = tokens - tp.index * rows
    inside = (local >= 0) & (local < rows)
    x = params.table[local.clamp(0, rows - 1)].to(cfg.cdtype)
    return tp.all_reduce(torch.where(inside[..., None], x, 0))


def unembed_matrix(params) -> Tensor:
    if hasattr(params, "unembed"):
        return params.unembed
    return params.table.T


def by_halves() -> bool:
    """Whether a device that holds the whole of what 2 ranks of a model
    axis would split (one device, or a rank the split skips) computes it
    by the halves that they hold: while serving (no autograd; training
    keeps the reference's arithmetic and backward).  Then 2 ranks give
    one device's bits (``models/parallel.py``)."""
    return not torch.is_grad_enabled()


def by_columns(x: Tensor, w: Tensor,
               cols: list[slice] | None) -> Tensor:
    """``x @ w``; given ``cols``, the products over those column slices of
    ``w``, joined: what ranks that hold those columns compute, so that
    one device computing this way has their bits (a product's bits can
    depend on its width: on an H100 the first half of a (4, 4096) @ (4096,
    4096) product differs in its last bits from the product with that
    half of the columns, tools/tp_bits.py)."""
    if cols is None:
        return x @ w
    return torch.cat([x @ w[:, c] for c in cols], dim=-1)


def logits(params, x: Tensor, tp=None) -> Tensor:
    """``x @ unembed`` in ``x``'s type; over a model axis the rank's
    vocabulary slice, gathered into the whole (padded) vocabulary.  On
    one device, serving (no autograd), by the vocabulary's halves that 2
    ranks hold, so that they give its bits (``attention._halves``)."""
    w = unembed_matrix(params).to(x.dtype)
    name = "unembed" if hasattr(params, "unembed") else "table"
    if _vocab_split(params, name, tp):
        return tp.gather_last(x @ w)
    pv = w.shape[1]
    halves = None
    if by_halves() and pv % 2 == 0:
        halves = [slice(0, pv // 2), slice(pv // 2, pv)]
    return by_columns(x, w, halves)


def _chunk_nll(xc: Tensor, w_unembed: Tensor, lc: Tensor) -> Tensor:
    """The summed NLL of one chunk's valid positions (label >= 0), from
    fp32 logits."""
    logits = (xc @ w_unembed.to(xc.dtype)).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = logits.gather(-1, lc.clamp_min(0).to(torch.int64)[..., None])
    nll = torch.where(lc >= 0, lse - tgt[..., 0], 0.0)
    return nll.sum()


def chunked_cross_entropy(x: Tensor, w_unembed: Tensor, labels: Tensor,
                          cfg: ModelConfig) -> Tensor:
    """Mean CE over the valid positions (label >= 0) of (B, S, d) final
    hidden states against (B, S) labels, in sequence chunks of
    ``cfg.ce_chunk``: the sequence is padded to a multiple of the chunk
    (padded positions label -1, weight 0), each chunk's (B, ck, V) logits
    are fp32 and recomputed in backward, so backward also holds one
    chunk's logits at a time.  Chunks add up in order, as the reference's
    scan."""
    b, s, _ = x.shape
    ck = min(cfg.ce_chunk, s)
    pad = (-s) % ck
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for c0 in range(0, x.shape[1], ck):
        lc = labels[:, c0:c0 + ck]
        total = total + recompute(_chunk_nll, x[:, c0:c0 + ck], w_unembed,
                                  lc)
        count = count + (lc >= 0).sum(dtype=torch.int32)
    return total / torch.clamp_min(count, 1).to(torch.float32)
