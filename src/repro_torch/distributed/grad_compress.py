"""DCF-PCA robust gradient aggregation, the Byzantine-robust consensus over a
stacked client axis and the compressed consensus wire (counterpart of
``repro.distributed.grad_compress``: ``CompressConfig`` :39-58,
``_robust_sigma`` :61-89, ``topk_sparsify`` / ``topk_reconstruct``
:91-104, ``consensus_compress`` :145-184, the robust combine and screens
:205-285, the collective halves of the sharded engine's wire:
``gather_clients`` :187, ``median_aggregate`` :197,
``compressed_consensus_sum`` :107-142 and ``compressed_consensus_robust``
:288-335, and ``aggregate_leaf`` / ``aggregate_tree`` /
``compression_ratio`` :338-383).

In data-parallel training worker i's gradient leaf ``G_i`` (m, k) is one
column block of the paper's ``M = [G_1 ... G_E]``.  A few DCF-PCA
consensus rounds give ``G_i ~= U V_i^T + S_i`` with U shared, and the
optimizer takes the robust mean ``U (mean_i V_i)^T``: the sparse term
absorbs one worker's gross corruption, which a plain mean passes on.  Each
rank is one client (E = 1 a rank): every round is one ``factorized.
local_round`` on its (1, m, k) block, so on the card ``huber_contract_v``
and ``huber_contract_u_diag`` run at the gradient's own shape.

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
    """The reference's ``CompressConfig``, field for field.  The solvers
    read ``topk_frac`` (``DCFConfig.consensus_compress``: ship only that
    fraction of each consensus U delta, with an error-feedback residual;
    ``None`` keeps the dense factor wire); the robust gradient aggregation
    (:func:`consensus_compress`) reads them all, through :meth:`dcf`."""

    rank: int = 8
    rounds: int = 4  # consensus rounds T
    local_iters: int = 1  # K
    inner_sweeps: int = 2  # J
    rho: float = 1e-3
    lam_mult: float = 2.5  # threshold = lam_mult * robust sigma
    eta: float = 0.5
    min_dim: int = 64  # leaves smaller than this skip compression
    topk_frac: float | None = None

    def dcf(self):
        """The DCF-PCA config of one aggregation: the reference's fields,
        but ``impl="auto"`` where the reference pins ``"ref"`` (it does so
        that a 512-device dry run lowers on forced CPU devices,
        ``repro/kernels/ops.py:4-5``): the card's kernels on CUDA
        gradients, the plain versions on CPU ones."""
        from repro_torch.core.factorized import DCFConfig

        return DCFConfig(
            rank=self.rank, outer_iters=self.rounds,
            local_iters=self.local_iters, inner_sweeps=self.inner_sweeps,
            rho=self.rho, eta0=self.eta, lr_schedule="fixed",
            precondition="lipschitz", impl="auto",
        )


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


# ---------------------------------------------------------------------------
# Robust gradient aggregation (one client a rank)
# ---------------------------------------------------------------------------
def _sorted_mid(xs: Tensor, start, count) -> Tensor:
    """``0.5 * (xs[start + (c-1)//2] + xs[start + c//2])`` of a sorted flat
    ``xs``; ``start`` and ``count`` may be device tensors."""
    return 0.5 * (xs[start + (count - 1) // 2] + xs[start + count // 2])


def _robust_sigma(g: Tensor, comm, eps: float = 1e-6) -> Tensor:
    """Robust scale of a gradient leaf, floored away from zero, averaged
    over the data group: 1.4826 times the MAD, or, where more than half the
    deviations are exactly 0 (embedding rows, sparse gradients), the MAD
    over the nonzero deviations; at least ``eps`` times the leaf's rms.
    Computed in fp32 (the reference computes it in the leaf's dtype: for a
    bf16 leaf its median and deviations round to bf16).
    One sort of the deviations serves both medians (the zeros sort first),
    and the picks index it with device tensors: no host read."""
    gf = g.to(torch.float32).reshape(-1)
    size = gf.numel()
    med = _sorted_mid(torch.sort(gf).values, 0, size)
    dev = (gf - med).abs()
    x = torch.sort(dev).values
    mad = _sorted_mid(x, 0, size)
    cnt = torch.clamp_min((dev > 0).sum(), 1)
    mad_nz = _sorted_mid(x, size - cnt, cnt)
    rms = torch.sqrt(torch.mean(gf * gf))
    sigma = torch.where(mad > 0, mad, mad_nz)
    local = torch.maximum(1.4826 * sigma, eps * rms)
    return comm.all_reduce(local) / comm.clients


def consensus_compress(g_local: Tensor, comm, ccfg: CompressConfig,
                       generator: torch.Generator | None = None, *,
                       omega: Tensor | None = None) -> Tensor:
    """Robust aggregate of this rank's 2-D gradient leaf (m, k) over the
    data group of ``comm`` (a ``multihost.MeshComm``), in the leaf's dtype.

    The threshold is ``lam_mult`` robust sigmas; U starts from the sketch
    ``pmean(G_i Omega)``, columns normalised (one power-iteration step
    toward the shared column space), with ``Omega`` (k, r) drawn from
    ``generator`` (the same seed on every rank gives every rank the same
    draw) or given as ``omega`` (a parity test passes the reference's);
    then ``rounds`` consensus rounds of :func:`factorized.local_round` on
    the rank's (1, m, k) block, each ending in the mean of the U copies
    (or, with ``topk_frac``, its error-feedback top-k wire); the result is
    ``U mean_i(V_i)^T``.  Collectives: one scalar and (rounds + 1) (m, r)
    all-reduces, one (k, r)."""
    from repro_torch.core import factorized as fz

    m, k = g_local.shape
    cfg = ccfg.dcf()
    dev = g_local.device
    e = comm.clients
    lam = ccfg.lam_mult * _robust_sigma(g_local, comm) + 1e-12
    gf = g_local.to(torch.float32)
    if omega is None:
        omega = torch.randn(k, ccfg.rank, generator=generator,
                            dtype=torch.float32, device=dev)
    u = comm.all_reduce(gf @ omega.to(device=dev, dtype=torch.float32)) / e
    u = u / (torch.linalg.vector_norm(u, dim=0, keepdim=True) + 1e-12)
    v = torch.zeros(1, k, ccfg.rank, dtype=torch.float32, device=dev)
    blk = gf[None]
    k_keep = None
    if ccfg.topk_frac is not None:
        from repro_torch.distributed.multihost import topk_k

        k_keep = topk_k(m * ccfg.rank, ccfg.topk_frac)
    err = torch.zeros_like(u)
    for t in range(ccfg.rounds):
        eta = cfg.lr(torch.full((), t, dtype=torch.float32, device=dev))
        u_i, v, _ = fz.local_round(u, v, blk, cfg=cfg, lam=lam,
                                   n_frac=1.0 / e, eta=eta)
        if k_keep is None:
            u = comm.all_reduce(u_i[0]) / e
        else:  # pmean(u_i) == u + sum_i (u_i - u) / E, shipped top-k
            delta, err = compressed_consensus_sum((u_i[0] - u) / e, comm,
                                                  k_keep, err)
            u = u + delta
    v_mean = comm.all_reduce(v[0]) / e
    return (u @ v_mean.T).to(g_local.dtype)


def aggregate_leaf(g: Tensor, comm, ccfg: CompressConfig,
                   generator: torch.Generator | None = None) -> Tensor:
    """One gradient leaf: DCF-PCA consensus on a large >= 2-D leaf (each
    trailing (m, k) matrix of a stacked leaf in turn, drawing from the same
    generator), the coordinate median over the ranks for the rest (norm
    scales, small matrices).  The port keeps one leaf a layer, so its
    models give 2-D leaves only."""
    dims = g.shape[-2:]
    if g.ndim >= 2 and min(dims) >= ccfg.min_dim and ccfg.rank < min(dims):
        if g.ndim == 2:
            return consensus_compress(g, comm, ccfg, generator)
        flat = g.reshape(-1, *dims)
        return torch.stack([consensus_compress(x, comm, ccfg, generator)
                            for x in flat]).reshape(g.shape)
    return median_aggregate(g, comm)


def aggregate_tree(grads: dict[str, Tensor], comm, ccfg: CompressConfig,
                   generator: torch.Generator | None = None
                   ) -> dict[str, Tensor]:
    """Every leaf of a gradient dict through :func:`aggregate_leaf`, in the
    dict's order (the same on every rank: the sketches draw in turn from
    one generator)."""
    return {name: aggregate_leaf(g, comm, ccfg, generator)
            for name, g in grads.items()}


def compression_ratio(shape: tuple[int, ...], ccfg: CompressConfig) -> float:
    """Static per-step bytes a worker ships, compressed over all-reduce:
    each consensus round the dense fp32 U (``m r 4`` bytes) or, with
    ``topk_frac``, the top-k payload at 8 bytes an entry (fp32 value and
    int32 index), plus the final V mean (``k r 4``), against the dense
    ``m k 4`` gradient.  1.0 for a leaf that skips compression."""
    from repro_torch.distributed.multihost import topk_k

    if len(shape) < 2 or min(shape[-2:]) < ccfg.min_dim \
            or ccfg.rank >= min(shape[-2:]):
        return 1.0
    m, k = shape[-2:]
    if ccfg.topk_frac is None:
        round_bytes = m * ccfg.rank * 4
    else:
        round_bytes = topk_k(m * ccfg.rank, ccfg.topk_frac) * (4 + 4)
    compressed = ccfg.rounds * round_bytes + k * ccfg.rank * 4
    return compressed / (m * k * 4)
