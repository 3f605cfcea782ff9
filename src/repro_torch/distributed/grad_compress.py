"""Byzantine-robust consensus over a stacked client axis and the compressed
consensus wire (counterpart of ``repro.distributed.grad_compress``:
``CompressConfig`` :39-58, ``topk_sparsify`` / ``topk_reconstruct``
:91-104, the robust combine and screens :205-285, and the collective
halves of the sharded engine's wire: ``gather_clients`` :187,
``median_aggregate`` :197, ``compressed_consensus_sum`` :107-142 and
``compressed_consensus_robust`` :288-335).

The collective functions take the rank's ``distributed.multihost.
MeshComm`` where the reference takes mesh axis names; they use only its
``all_gather`` (the list form, clients stacked in client order), so every
rank receives the same stack and computes the same result from it.

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

    The payload is ``jax.lax.top_k``'s, in its order: magnitude
    descending, and among equal magnitudes the lower index first (so a tie
    at the k-th magnitude keeps the lower index).  ``torch.topk`` promises
    no order among ties; a stable descending sort of the magnitudes gives
    the reference's (NaN, as there, ranks above every number).  The sort is
    deterministic, so the wire's bits repeat run to run."""
    flat = g.to(torch.float32)
    idx = torch.sort(flat.abs(), dim=-1, descending=True,
                     stable=True).indices[..., :k]
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


# ---------------------------------------------------------------------------
# The collective halves (the sharded engine: one client a rank)
# ---------------------------------------------------------------------------
def gather_clients(x: Tensor, comm) -> Tensor:
    """``x`` of every client (every rank of ``comm``'s data group), stacked
    ``(E, ...)`` in client order: the same stack on every rank, so stacked
    post-processing (median, trim, screens) stays in lock-step."""
    return comm.all_gather(x, "data")


def median_aggregate(g: Tensor, comm) -> Tensor:
    """Coordinate-wise median over the clients: one all-gather of ``g``."""
    gathered = gather_clients(g, comm).to(torch.float32)
    e = gathered.shape[0]
    xs = torch.sort(gathered.reshape(e, -1), dim=0).values
    med = 0.5 * (xs[(e - 1) // 2] + xs[e // 2])
    return med.reshape(g.shape).to(g.dtype)


def _ship(contrib: Tensor, k: int, err: Tensor, active: Tensor | None):
    """This rank's payload: the top-k of ``contrib + err`` (values masked
    to zero when ``active`` is 0) and the error-feedback residual (kept as
    it was when ``active`` is 0)."""
    g = contrib.to(torch.float32) + err
    vals, idx = topk_sparsify(g.reshape(-1), k)
    err_new = g - topk_reconstruct(vals, idx, g.numel()).reshape(g.shape)
    if active is not None:
        vals = torch.where(active > 0, vals, 0.0)
        err_new = torch.where(active > 0, err_new, err)
    return g, vals, idx, err_new


def compressed_consensus_sum(contrib: Tensor, comm, k: int, err: Tensor,
                             active: Tensor | None = None
                             ) -> tuple[Tensor, Tensor]:
    """Error-feedback top-k in place of the all-reduce of ``contrib`` over
    the clients.  Each rank ships the top-k of ``contrib + err`` as (k fp32
    values, k int32 indices); one all-gather of each moves the E payloads
    (E k 8 bytes a rank).  Every rank writes each payload into its own
    dense row and sums the rows in client order: no atomics, the same bits
    on every rank and every run.  What the top-k dropped stays in the
    returned residual (``shipped_t + err_t = contrib_t + err_{t-1}``).  An
    inactive rank (``active`` 0) ships zeros and keeps its residual.
    Returns ``(sum, err_new)``; exact when ``k`` is the size."""
    g, vals, idx, err_new = _ship(contrib, k, err, active)
    rows = topk_reconstruct(gather_clients(vals, comm),
                            gather_clients(idx, comm), g.numel())
    return rows.sum(0).reshape(g.shape).to(contrib.dtype), err_new


def compressed_consensus_robust(contrib: Tensor, comm, k: int, err: Tensor,
                                active: Tensor | None, aggregator: str,
                                trim_frac: float = 0.25,
                                screen: float | None = None,
                                reduce_m=None
                                ) -> tuple[Tensor, Tensor, Tensor]:
    """The robust sibling of :func:`compressed_consensus_sum`: the same
    wire, but every rank rebuilds the E per-client deltas and combines them
    one vote a client (:func:`robust_combine_stacked`), after the
    divergence screen on the shipped norms when ``screen`` is set
    (``reduce_m`` sums the squared norms over the model group, so every
    row block judges a client by its whole payload).  Returns ``(delta,
    err_new, count)``."""
    g, vals, idx, err_new = _ship(contrib, k, err, active)
    vals_g = gather_clients(vals, comm)
    recon = topk_reconstruct(vals_g, gather_clients(idx, comm), g.numel())
    e = vals_g.shape[0]
    one = torch.ones((), device=g.device)
    act = gather_clients(one if active is None else active * one, comm)
    if screen is not None:
        sq = (vals_g * vals_g).sum(1)
        if reduce_m is not None:
            sq = reduce_m(sq)
        act = act * screen_from_norms(torch.sqrt(sq), act, screen)
    delta, cnt = robust_combine_stacked(recon.reshape((e,) + g.shape), act,
                                        aggregator, trim_frac)
    return delta.to(contrib.dtype), err_new, cnt
