"""Byzantine-robust consensus over a stacked client axis and the compressed
consensus wire (counterpart of ``repro.distributed.grad_compress``:
``CompressConfig`` :39-58, ``topk_sparsify`` / ``topk_reconstruct``
:91-104 and the robust combine and screens :205-285).

Everything here stays on the device: the live counts are device tensors and
the order statistics are picked with ``gather``, so a robust round never
waits on the host.  The stacked functions take the client axis E first, or
after a leading problem axis B for a batch (``active`` (B, E)); no value of
one problem ever reaches another's result.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor


@dataclass(frozen=True)
class CompressConfig:
    """The reference's ``CompressConfig``, field for field.  The port's
    solvers read ``topk_frac`` (``DCFConfig.consensus_compress``: ship only
    that fraction of each consensus U delta, with an error-feedback
    residual; ``None`` keeps the dense factor wire); the other fields
    configure the reference's gradient compression, which is not ported."""

    rank: int = 8
    rounds: int = 4  # consensus rounds T
    local_iters: int = 1  # K
    inner_sweeps: int = 2  # J
    rho: float = 1e-3
    lam_mult: float = 2.5  # threshold = lam_mult * robust sigma
    eta: float = 0.5
    min_dim: int = 64  # leaves smaller than this skip compression
    topk_frac: float | None = None


def topk_sparsify(g: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top-``k``-by-magnitude entries of each row of ``g`` (..., d) as
    (values fp32, int32 indices into the row), each (..., k): the wire
    payload of one compressed consensus message a row (a flat vector is
    the reference's call).

    ``jax.lax.top_k`` breaks ties by the lower index; ``torch.topk``
    promises no order.  A tie at the k-th magnitude between two zeros
    changes nothing (a zero shipped or kept is a zero), but a tie between
    two nonzero entries of equal magnitude can ship another one than the
    reference: the payload, the reconstruction and the error-feedback
    residual then differ by that entry (exact ties of nonzero fp32
    magnitudes are rare in a consensus delta)."""
    flat = g.to(torch.float32)
    idx = torch.topk(flat.abs(), k, dim=-1).indices
    return flat.gather(-1, idx), idx.to(torch.int32)


def topk_reconstruct(vals: Tensor, idx: Tensor, size: int) -> Tensor:
    """A (values, indices) payload back as a dense fp32 vector of ``size``
    entries; stacked payloads (..., k) come back as stacked rows
    (..., size).  Within one payload the indices are unique, so each entry
    is written once: no accumulation and no atomics.  The reference
    scatter-adds the concatenated payloads of E clients into one vector;
    here the sum of several payloads is the caller's, over the stacked
    rows in one fixed order (``torch.sum`` over the client axis, the same
    on every run)."""
    out = torch.zeros(*vals.shape[:-1], size, dtype=torch.float32,
                      device=vals.device)
    return out.scatter_(-1, idx.to(torch.int64), vals.to(torch.float32))


def _pick(xs: Tensor, idx: Tensor) -> Tensor:
    """Row ``idx`` of ``xs`` (..., E, F) along E, ``idx`` (...) on the
    device: (..., F), without a host sync."""
    i = idx.to(torch.int64)[..., None, None].expand(*idx.shape, 1,
                                                      xs.shape[-1])
    return xs.gather(-2, i).squeeze(-2)


def _sorted_median(xs: Tensor, count: Tensor) -> Tensor:
    """``0.5 * (xs[(c-1)//2] + xs[c//2])`` along the E axis (-2) of sorted
    ``xs``: the reference's (and ``jnp.median``'s) arithmetic."""
    return 0.5 * (_pick(xs, (count - 1) // 2) + _pick(xs, count // 2))


def robust_combine_stacked(x: Tensor, active: Tensor | None,
                           aggregator: str, trim_frac: float = 0.25
                           ) -> tuple[Tensor, Tensor]:
    """One-vote robust combination of stacked ``(E, ...)`` payloads, or
    ``(B, E, ...)`` with ``active`` (B, E) for a batch (one combination a
    problem).

    A client with any non-finite entry is dropped entirely, inactive ones
    (``active`` 0) are masked to ``+inf`` so they sort past every live
    value, and the order statistics index the live count ``c``:

    ``coordinate_median``  ``0.5 * (xs[(c-1)//2] + xs[c//2])`` per
                           coordinate, the reference's bits;
    ``trimmed_mean``       drops ``floor(trim_frac * E)`` values a side and
                           averages the middle; the median where fewer than
                           one value would remain.

    Returns ``(agg, count)``: ``agg`` is zeros when no client survives
    (callers keep the previous state where ``count == 0``).
    """
    lead = 0 if active is None else active.ndim - 1
    e = x.shape[lead]
    flat = x.reshape(*x.shape[:lead + 1], -1).to(torch.float32)
    finite = torch.isfinite(flat).all(dim=-1)
    keep = finite if active is None else finite & (active > 0)
    cnt = keep.sum(-1).to(torch.int32)
    inf = torch.full((), float("inf"), device=x.device)
    xs = torch.sort(torch.where(keep[..., None], flat, inf), dim=-2).values
    c = torch.clamp_min(cnt, 1)
    med = _sorted_median(xs, c)
    if aggregator == "coordinate_median":
        agg = med
    elif aggregator == "trimmed_mean":
        k = int(trim_frac * e)
        pos = torch.arange(e, device=x.device)[:, None]
        take = (pos >= k) & (pos < (c - k)[..., None, None])
        tsum = torch.where(take, xs, torch.zeros((), device=x.device)
                           ).sum(-2)
        denom = (c - 2 * k)[..., None]
        agg = torch.where(denom >= 1,
                          tsum / torch.clamp_min(denom, 1).to(torch.float32),
                          med)
    else:
        raise ValueError(f"unknown robust aggregator {aggregator!r}")
    agg = torch.where(cnt[..., None] > 0, agg,
                      torch.zeros((), device=x.device))
    return agg.reshape(*x.shape[:lead], *x.shape[lead + 1:]), cnt


def screen_from_norms(nrm: Tensor, active: Tensor,
                      threshold: float) -> Tensor:
    """Contribution-divergence screen from per-client payload norms (E,),
    or (B, E) for a batch: 0 for a client whose norm is non-finite or above
    ``threshold`` times the median norm of its problem's active, finite
    clients; 1 otherwise."""
    ok = torch.isfinite(nrm) & (active > 0)
    cnt = torch.clamp_min(ok.sum(-1), 1)
    inf = torch.full((), float("inf"), device=nrm.device)
    xs = torch.sort(torch.where(ok, nrm, inf), dim=-1).values
    med = _sorted_median(xs[..., None], cnt).squeeze(-1)
    keep = torch.isfinite(nrm) & (
        nrm <= threshold * torch.clamp_min(med, 1e-30)[..., None])
    return keep.to(torch.float32)


def divergence_screen_mask(delta: Tensor, active: Tensor,
                           threshold: float) -> Tensor:
    """The screen of a stacked ``(E, ...)`` delta (``(B, E, ...)`` with
    ``active`` (B, E)): per-client Frobenius norms through
    :func:`screen_from_norms`."""
    flat = delta.reshape(*active.shape, -1).to(torch.float32)
    nrm = torch.sqrt((flat ** 2).sum(-1))
    return screen_from_norms(nrm, active, threshold)
