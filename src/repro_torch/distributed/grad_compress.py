"""Byzantine-robust consensus over a stacked client axis (counterpart of
``repro.distributed.grad_compress`` :205-285; the compressed wire waits for
a later slice, ROADMAP.md).

Everything here stays on the device: the live counts are device tensors and
the order statistics are picked with ``index_select``, so a robust round
never waits on the host.
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pick(xs: Tensor, idx: Tensor) -> Tensor:
    """Row ``idx`` (a 0-d device tensor) of ``xs``, without a host sync."""
    return xs.index_select(0, idx.reshape(1).to(torch.int64)).squeeze(0)


def _sorted_median(xs: Tensor, count: Tensor) -> Tensor:
    """``0.5 * (xs[(c-1)//2] + xs[c//2])`` along axis 0 of sorted ``xs``:
    the reference's (and ``jnp.median``'s) arithmetic."""
    return 0.5 * (_pick(xs, (count - 1) // 2) + _pick(xs, count // 2))


def robust_combine_stacked(x: Tensor, active: Tensor | None,
                           aggregator: str, trim_frac: float = 0.25
                           ) -> tuple[Tensor, Tensor]:
    """One-vote robust combination of stacked ``(E, ...)`` payloads.

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
    e = x.shape[0]
    flat = x.reshape(e, -1).to(torch.float32)
    finite = torch.isfinite(flat).all(dim=1)
    keep = finite if active is None else finite & (active > 0)
    cnt = keep.sum().to(torch.int32)
    inf = torch.full((), float("inf"), device=x.device)
    xs = torch.sort(torch.where(keep[:, None], flat, inf), dim=0).values
    c = torch.clamp_min(cnt, 1)
    med = _sorted_median(xs, c)
    if aggregator == "coordinate_median":
        agg = med
    elif aggregator == "trimmed_mean":
        k = int(trim_frac * e)
        pos = torch.arange(e, device=x.device)[:, None]
        take = (pos >= k) & (pos < c - k)
        tsum = torch.where(take, xs, torch.zeros((), device=x.device)).sum(0)
        denom = c - 2 * k
        agg = torch.where(denom >= 1,
                          tsum / torch.clamp_min(denom, 1).to(torch.float32),
                          med)
    else:
        raise ValueError(f"unknown robust aggregator {aggregator!r}")
    agg = torch.where(cnt > 0, agg, torch.zeros((), device=x.device))
    return agg.reshape(x.shape[1:]), cnt


def screen_from_norms(nrm: Tensor, active: Tensor,
                      threshold: float) -> Tensor:
    """Contribution-divergence screen from per-client payload norms: 0 for
    a client whose norm is non-finite or above ``threshold`` times the
    median norm of the active, finite clients; 1 otherwise."""
    ok = torch.isfinite(nrm) & (active > 0)
    cnt = torch.clamp_min(ok.sum(), 1)
    inf = torch.full((), float("inf"), device=nrm.device)
    med = _sorted_median(torch.sort(torch.where(ok, nrm, inf)).values, cnt)
    keep = torch.isfinite(nrm) & (nrm <= threshold * torch.clamp_min(med,
                                                                     1e-30))
    return keep.to(torch.float32)


def divergence_screen_mask(delta: Tensor, active: Tensor,
                           threshold: float) -> Tensor:
    """The screen of a stacked ``(E, ...)`` delta: per-client Frobenius
    norms through :func:`screen_from_norms`."""
    e = delta.shape[0]
    nrm = torch.sqrt((delta.reshape(e, -1).to(torch.float32) ** 2).sum(1))
    return screen_from_norms(nrm, active, threshold)
