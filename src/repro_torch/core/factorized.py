"""Shared machinery of consensus-factorization RPCA (Sec. 2.2): the local
computation of Algorithm 1, batched over a leading client axis E.

The counterpart of ``repro.core.factorized``.  Where the reference vmaps one
client's round, every function here takes the stacked client blocks
``(E, m, n_i)`` at once, so each kernel launch serves all clients:

``local_round``  K local iterations of {J inner (V, S) sweeps, one U-step}:
                 every inner sweep is one batched ``huber_contract_v``
                 launch plus an r x r ridge back-substitution; the U-step
                 takes ``Psi V`` from one batched ``huber_contract_u_diag``
                 launch (``fused="diag"``, which also measures the round's
                 Huber objective and ``||Psi||_F^2``) or
                 ``huber_contract_u`` (``"off"``).  Under ``"dual"`` the
                 J-th sweep is one ``huber_dual_contract`` launch whose
                 ``Psi^T U`` makes the last V update and whose ``Psi V``
                 (one sweep stale) makes the U-step.
``finalize``     ``L = U V^T`` (``torch.matmul``) and ``S`` from one
                 ``residual_shrink`` launch.

Inner solvers: ``altmin`` (exact block-coordinate descent on the (V, S)
subproblem, Eqs. 15-16, with ``U^T (M - S) = G V^T + U^T Psi``) and
``huber_gd`` (gradient descent on the eliminated objective, Lemma 1).  The
r x r Gram matrix ``G + rho I`` is Cholesky-factored once per local
iteration (``cholesky_ex``, which does not wait for the device) and
back-substituted per sweep.

Everything in the loop stays on the device: ``lam`` and ``eta`` are device
tensors and nothing is read back to the host.

A batch of B problems folds into the client axis: ``local_round`` takes
B·E clients in the same launches (one threshold, step size and
regularizer share a client), and ``aggregate_stacked`` takes the stacked
factors with a leading problem axis, ``(B, E, m, r)``, one consensus a
problem.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Literal

import torch

from repro_torch.core import ops as core_ops
from repro_torch.kernels import bitmask
from repro_torch.kernels import ops as kops
from repro_torch.kernels._launch import grid_limit_error

Tensor = torch.Tensor


@dataclass(frozen=True)
class DCFConfig:
    """Hyperparameters of (D)CF-PCA: the fields, defaults and presets of
    ``repro.core.factorized.DCFConfig`` (see there for each field).

    ``impl`` is ``"auto"`` (kernel on CUDA tensors, plain version on CPU
    tensors), ``"cuda"`` or ``"ref"``.  The port runs every ``fused`` mode,
    dense and bit-packed masks (``pack_mask``), fp32 and bf16 data,
    ``lam_sample``, every aggregator, the divergence screen and the wire
    consensus (``consensus_compress``: a
    ``distributed.grad_compress.CompressConfig``; ``consensus_delay``).
    """

    rank: int
    outer_iters: int = 50  # T, consensus rounds
    local_iters: int = 2  # K, local U-steps per round
    inner_sweeps: int = 3  # J, (V, S) sweeps per local U-step
    rho: float = 1e-2
    lam: float | None = None  # None => robust_lam(M)
    lam_decay: float = 1.0
    lam_min_frac: float = 1e-3
    eta0: float = 0.05
    lr_schedule: Literal["decay", "fixed", "theory"] = "decay"
    inner: Literal["altmin", "huber_gd"] = "altmin"
    precondition: Literal["lipschitz", "newton", "raw"] = "lipschitz"
    impl: Literal["auto", "cuda", "ref"] = "auto"
    track_objective: bool = False
    fused: Literal["off", "diag", "dual"] = "diag"
    pack_mask: bool = False
    lam_sample: int | None = None
    consensus_compress: Any = None
    consensus_delay: int = 0
    stale_guard: float = 4.0
    aggregator: Literal[
        "weighted_mean", "trimmed_mean", "coordinate_median"
    ] = "weighted_mean"
    trim_frac: float = 0.25
    divergence_screen: float | None = None

    def lr(self, t: Tensor) -> Tensor:
        """Learning rate at round ``t`` (a device tensor), fp32."""
        t = t.to(torch.float32)
        if self.lr_schedule == "decay":
            return self.eta0 / (1.0 + t)
        if self.lr_schedule == "theory":
            kt = torch.full_like(t, float(self.local_iters * self.outer_iters))
            return self.eta0 / torch.sqrt(kt)
        return torch.full_like(t, self.eta0)

    def lam_at(self, lam0: Tensor, t: Tensor) -> Tensor:
        """Annealed threshold ``lam0 * max(lam_decay^t, lam_min_frac)``."""
        lam0 = lam0.to(torch.float32)
        if self.lam_decay >= 1.0:
            return lam0
        frac = torch.clamp_min(self.lam_decay ** t.to(torch.float32),
                               self.lam_min_frac)
        return lam0 * frac

    def final_lam(self, lam0: Tensor) -> Tensor:
        t = torch.full((), self.outer_iters - 1, dtype=torch.float32,
                       device=lam0.device)
        return self.lam_at(lam0, t)

    @classmethod
    def paper(cls, rank: int, **overrides) -> "DCFConfig":
        """Paper-faithful preset: fixed lam, decaying eta0=0.05, K=2."""
        kw = dict(rank=rank, outer_iters=50, local_iters=2, inner_sweeps=3,
                  rho=1e-2, eta0=0.05, lr_schedule="decay", lam_decay=1.0,
                  precondition="lipschitz")
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def tuned(cls, rank: int, **overrides) -> "DCFConfig":
        """Annealed threshold, fixed eta with Lipschitz conditioning."""
        kw = dict(rank=rank, outer_iters=100, local_iters=2, inner_sweeps=3,
                  rho=1e-2, eta0=0.5, lr_schedule="fixed", lam_decay=0.9,
                  lam_min_frac=1e-3, precondition="lipschitz")
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def tuned_hard(cls, rank: int, **overrides) -> "DCFConfig":
        """Slow-anneal preset for hard corners of the phase plane."""
        kw = dict(rank=rank, outer_iters=300, local_iters=2, inner_sweeps=3,
                  rho=1e-2, eta0=0.5, lr_schedule="fixed", lam_decay=0.97,
                  lam_min_frac=1e-3, precondition="lipschitz")
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def elastic(cls, rank: int, participation: float = 1.0,
                **overrides) -> "DCFConfig":
        """Partial participation: the masked preset at ``participation``."""
        return cls.masked(rank, observed_frac=participation, **overrides)

    @classmethod
    def masked(cls, rank: int, observed_frac: float = 0.7,
               **overrides) -> "DCFConfig":
        """Partial observation: slow anneal, budget stretched by
        ``1/observed_frac``."""
        iters = int(round(300 / max(observed_frac, 0.3)))
        kw = dict(rank=rank, outer_iters=iters, local_iters=2,
                  inner_sweeps=3, rho=1e-2, eta0=0.5, lr_schedule="fixed",
                  lam_decay=0.97, lam_min_frac=1e-3,
                  precondition="lipschitz")
        kw.update(overrides)
        return cls(**kw)


def check_supported(cfg: DCFConfig, device: torch.device) -> None:
    """Refuse, before any solve starts, what the port cannot run where the
    solve runs (``device``): on a CUDA device, an ``impl`` the port does
    not know (such as the reference's ``"pallas"``, which raises
    ``NotImplementedError`` naming ROADMAP.md), and ``impl="cuda"``
    anywhere else (``ValueError``).  Every option of the config solves,
    the wire consensus included, and the kernels take any rank."""
    if device.type == "cuda" and cfg.impl not in kops.IMPLS:
        raise NotImplementedError(
            f"impl={cfg.impl!r} on the card waits for a later slice of the "
            f"port (ROADMAP.md) (the port runs {', '.join(kops.IMPLS)})")
    if cfg.impl == "cuda" and device.type != "cuda":
        raise ValueError(f"impl='cuda' needs a CUDA device, got {device}")


def check_grid(cfg: DCFConfig, clients: int, m: int,
               device: torch.device) -> None:
    """Where the problem is built: on the kernel route, refuse a shape no
    kernel grid holds (``kernels._launch.grid_limit_error``), with its
    reason."""
    if device.type != "cuda" or cfg.impl == "ref":
        return
    why = grid_limit_error(clients, m, cfg.rank)
    if why is not None:
        raise ValueError(f"the card's kernels cannot take this problem: {why}")


def _median(xs: Tensor, count) -> Tensor:
    """Median of the first ``count`` entries of sorted ``xs``; the mean of
    the two middle values for an even count (as ``jnp.median``)."""
    return 0.5 * (xs[(count - 1) // 2] + xs[count // 2])


def robust_lam(m_obs: Tensor, mult: float = 2.0, mask: Tensor | None = None,
               sample: int | None = None) -> Tensor:
    """Data-driven soft-threshold level ``mult * 1.4826 * MAD(M)``, as a
    0-d device tensor.

    ``mask`` restricts both medians to the observed entries; ``sample``
    caps the entries fed to the medians with a stride made coprime with the
    column count (so the subsample sweeps every column).
    """
    if mask is not None and bitmask.is_packed(mask):
        mask = bitmask.unpack_mask(mask, m_obs.shape[-1])
    n_cols = m_obs.shape[-1] if m_obs.ndim >= 2 else 1
    x = m_obs.reshape(-1).to(torch.float32)
    keep = None if mask is None else mask.reshape(-1) > 0
    if sample is not None and x.numel() > sample:
        stride = -(-x.numel() // sample)
        while n_cols > 1 and math.gcd(stride, n_cols) > 1:
            stride += 1
        x = x[::stride]
        keep = None if keep is None else keep[::stride]
    if keep is None:
        c = x.numel()
        med = _median(torch.sort(x).values, c)
        return mult * 1.4826 * _median(torch.sort((x - med).abs()).values, c)
    inf = torch.full((), float("inf"), device=x.device)
    count = torch.clamp_min(keep.sum(), 1)
    med = _median(torch.sort(torch.where(keep, x, inf)).values, count)
    dev = torch.where(keep, (x - med).abs(), inf)
    return mult * 1.4826 * _median(torch.sort(dev).values, count)


def consensus_weights(n_cols: Tensor | None, part: Tensor | None,
                      num_clients: int,
                      device: torch.device) -> tuple[Tensor, Tensor]:
    """Normalized consensus weights ``w_i = p_i n_i / sum_j p_j n_j`` and
    their total ``wsum = sum_j p_j n_j`` (``n_cols=None``: equal blocks;
    ``part=None``: every client).  ``n_cols`` and ``part`` are (E,), or
    (B, E) for a batch (``wsum`` then (B,), one a problem).  Callers gate
    the consensus on ``wsum > 0``.  Normalizing before the weighted sum
    keeps equal blocks with everyone in bit-exact with the mean for a
    power-of-two E."""
    raw = torch.ones(num_clients, dtype=torch.float32, device=device)
    if n_cols is not None:
        raw = raw * n_cols
    if part is not None:
        raw = raw * part
    wsum = raw.sum(-1)
    return raw / torch.clamp_min(wsum, 1e-30)[..., None], wsum


def _clients(x: Tensor) -> Tensor:
    """Per-client (E,) or per-problem (B,) values against stacked factors
    (..., m, r)."""
    return x[..., None, None]


def _weighted(w: Tensor, u_i: Tensor, keep: Tensor, u_prev: Tensor,
              wsum: Tensor) -> Tensor:
    """``sum_i w_i u_i`` over the kept clients (the others count as
    ``u_prev``), or ``u_prev`` itself when ``wsum == 0``."""
    u_g = torch.where(_clients(keep) > 0, u_i, u_prev.unsqueeze(-3))
    return torch.where(_clients(wsum) > 0,
                       (_clients(w) * u_g).sum(dim=-3), u_prev)


def aggregate_stacked(cfg: DCFConfig, u_i: Tensor, u_prev: Tensor, *,
                      n_cols: Tensor | None = None,
                      part: Tensor | None = None,
                      num_clients: int) -> tuple[Tensor, Tensor | None]:
    """Consensus (Eq. 9) over the stacked ``(E, m, r)`` client factors, or
    ``(B, E, m, r)`` with ``u_prev`` (B, m, r) and ``n_cols`` / ``part``
    (B, E) for a batch (one consensus a problem, which never sees another
    problem's clients): the reference's dispatch
    (``repro.core.factorized.aggregate_stacked``).

    Returns ``(u_new, wsum)``.  ``wsum`` is ``None`` on the unconditional
    path (everyone in, no screen, weighted mean: the plain mean for equal
    blocks, bit for bit, the count-weighted mean for ragged ones);
    otherwise it is the round's total weight (weighted mean) or the count
    of surviving one-vote clients (robust aggregators), ``> 0`` where a
    consensus step happened.  A dropped, screened or non-finite client
    counts as ``u_prev`` (the weighted mean) or is left out (robust)."""
    e = num_clients
    robust = cfg.aggregator != "weighted_mean"
    if not robust and cfg.divergence_screen is None:
        if part is None:
            if n_cols is None:
                return u_i.mean(dim=-3), None
            w, _ = consensus_weights(n_cols, None, e, u_i.device)
            return (_clients(w) * u_i).sum(dim=-3), None
        w, wsum = consensus_weights(n_cols, part, e, u_i.device)
        return _weighted(w, u_i, part, u_prev, wsum), wsum
    from repro_torch.distributed import grad_compress as gcomp

    active = (torch.ones(u_i.shape[:-2], dtype=torch.float32,
                         device=u_i.device) if part is None else part)
    delta = (u_i - u_prev.unsqueeze(-3)).to(torch.float32)
    if cfg.divergence_screen is not None:
        active = active * gcomp.divergence_screen_mask(
            delta, active, cfg.divergence_screen)
    if robust:
        # One vote a client: the ragged column counts are left out.
        agg, cnt = gcomp.robust_combine_stacked(delta, active, cfg.aggregator,
                                                cfg.trim_frac)
        u = torch.where(_clients(cnt) > 0, u_prev + agg.to(u_prev.dtype),
                        u_prev)
        return u, cnt.to(torch.float32)
    w, wsum = consensus_weights(n_cols, active, e, u_i.device)
    return _weighted(w, u_i, active, u_prev, wsum), wsum


def aggregate_sharded(cfg: DCFConfig, u_i: Tensor, u_prev: Tensor, *,
                      comm, pt: Tensor, n_i: Tensor, uniform: bool,
                      reduce_m=None) -> tuple[Tensor, Tensor | None]:
    """Consensus (Eq. 9) across the ranks of the sharded engine, called by
    every rank with its own client's ``u_i`` (its row block of it): the
    reference's ``aggregate_sharded``, over ``comm``
    (``distributed.multihost.MeshComm``).

    ``pt`` is this client's participation weight for the round (1.0 when
    no schedule), ``n_i`` its true column count (1.0 unless ragged), and
    ``uniform`` takes the plain mean (no schedule, no ragged tail): one
    ``all_reduce`` of ``u_i`` over the data group, then ``/ E``.  The
    weighted path sums ``w_i u_i`` with ``w_i = p_i n_i / sum_j p_j n_j``
    (an all-reduce of the weights, then of the weighted factors).  The
    robust and screened paths all-gather the deltas and combine the
    stacked clients as :func:`aggregate_stacked` does; their non-finite
    counts and norms are summed over the model group by ``reduce_m``, so
    every row block agrees on who is quarantined.  Every rank runs the
    same collectives (lock-step).  Returns ``(u_new, wsum)`` with
    :func:`aggregate_stacked`'s ``wsum``."""
    from repro_torch.distributed import grad_compress as gcomp

    reduce_m = reduce_m or _identity
    robust = cfg.aggregator != "weighted_mean"
    if not robust and cfg.divergence_screen is None:
        if uniform:
            return comm.all_reduce(u_i) / comm.clients, None
        u_g = torch.where(pt > 0, u_i, u_prev)
        raw_w = pt * n_i
        wsum = comm.all_reduce(raw_w)
        wgt = raw_w / torch.clamp_min(wsum, 1e-30)
        u_cand = comm.all_reduce(wgt * u_g)
        return torch.where(wsum > 0, u_cand, u_prev), wsum
    one = torch.ones((), device=u_i.device)
    stacked = gcomp.gather_clients((u_i - u_prev).to(torch.float32), comm)
    active = gcomp.gather_clients(pt * one, comm)
    e = stacked.shape[0]
    flat = stacked.reshape(e, -1)
    bad = reduce_m((~torch.isfinite(flat)).to(torch.float32).sum(1))
    active = active * (bad == 0).to(torch.float32)
    if cfg.divergence_screen is not None:
        nrm = torch.sqrt(reduce_m((flat * flat).sum(1)))
        active = active * gcomp.screen_from_norms(nrm, active,
                                                  cfg.divergence_screen)
    if robust:
        agg, cnt = gcomp.robust_combine_stacked(stacked, active,
                                                cfg.aggregator, cfg.trim_frac)
        u = torch.where(cnt > 0, u_prev + agg.to(u_prev.dtype), u_prev)
        return u, cnt.to(torch.float32)
    # The screened weighted mean over the gathered stack: every rank holds
    # the same stack, so no further collective is needed.
    raw = active * gcomp.gather_clients(n_i * one, comm)
    wsum = raw.sum()
    w = raw / torch.clamp_min(wsum, 1e-30)
    step = (_clients(w) * torch.where(_clients(active) > 0, stacked,
                                      0.0)).sum(0)
    return torch.where(wsum > 0, u_prev + step.to(u_prev.dtype),
                       u_prev), wsum


@dataclass(frozen=True)
class DCFState:
    """Factors: ``u`` (m, r) global, ``v`` (n_i, r) or (E, n_i, r)."""

    u: Tensor
    v: Tensor


def init_state(generator: torch.Generator, m: int, n_local: int, rank: int,
               device: torch.device, clients: int | None = None) -> DCFState:
    """Random init, ``U, V ~ N(0, 1/sqrt(r))``, drawn on the CPU from
    ``generator`` (so a seed gives the same factors on every device).
    ``clients`` stacks independent V blocks ``(clients, n_local, r)``."""
    scale = 1.0 / math.sqrt(rank)
    v_shape = (n_local, rank) if clients is None else (clients, n_local, rank)
    u = torch.randn(m, rank, generator=generator) * scale
    v = torch.randn(v_shape, generator=generator) * scale
    return DCFState(u=u.to(device), v=v.to(device))


# ---------------------------------------------------------------------------
# Inner solvers for Eq. (7): argmin_{V,S} given U, batched over clients
# ---------------------------------------------------------------------------
def _gram(u: Tensor) -> Tensor:
    return u.transpose(-1, -2) @ u


def _identity(x: Tensor) -> Tensor:
    return x


def _altmin_update(u: Tensor, rho: float, reduce_m=_identity):
    """The ridge update ``V^T <- (G + rho I)^{-1} (G V^T + U^T Psi)`` with
    ``G = U^T U`` (summed over the row blocks by ``reduce_m``), factored
    once per U.

    The back-substitution is two triangular solves: batched over clients
    on the card, ``torch.cholesky_solve`` takes a path that synchronises
    with the host and allocates on every call (see PERF.md), while
    ``solve_triangular`` stays one asynchronous batched launch each."""
    g = reduce_m(_gram(u))
    eye = torch.eye(g.shape[-1], dtype=g.dtype, device=g.device)
    chol, _ = torch.linalg.cholesky_ex(g + rho * eye)
    chol_t = chol.transpose(-1, -2)

    def update(v: Tensor, contr: Tensor) -> Tensor:
        rhs = g @ v.transpose(-1, -2) + contr.transpose(-1, -2)
        y = torch.linalg.solve_triangular(chol, rhs, upper=False)
        x = torch.linalg.solve_triangular(chol_t, y, upper=True)
        return x.transpose(-1, -2).contiguous()

    return update


def _gd_update(u: Tensor, rho: float, reduce_m=_identity):
    """One Lemma-1 step ``V <- V - (rho V - Psi^T U) /
    (rho + sigma_max(U)^2)``."""
    g = reduce_m(_gram(u))
    step = (1.0 / (rho + core_ops.spectral_norm_ub_gram(g)))[..., None, None]

    def update(v: Tensor, contr: Tensor) -> Tensor:
        return v - step * (rho * v - contr)

    return update


def _sweeps(update, u, v, m_blk, lam, sweeps, impl, w, reduce_m=_identity):
    """``sweeps`` inner (V, S) sweeps against a fixed U: one batched
    ``huber_contract_v`` launch (its row-partial summed by ``reduce_m``)
    and one ``update`` (altmin or huber_gd) each."""
    for _ in range(sweeps):
        v = update(v, reduce_m(kops.huber_contract_v(u, v, m_blk, lam, w=w,
                                                     impl=impl)))
    return v


def _per_client(x) -> Any:
    """A per-client (E,) tensor as (E, 1, 1); scalars pass through."""
    if isinstance(x, Tensor) and x.ndim == 1:
        return x[:, None, None]
    return x


def _u_step(cfg: DCFConfig, u_i: Tensor, v_i: Tensor, psi_v: Tensor,
            n_frac, eta: Tensor) -> Tensor:
    """One gradient step on the local U copies from ``Psi V``:
    ``grad = -Psi V + (n_i/n) rho U``, raw, Lipschitz-scaled or Newton."""
    grad_u = -psi_v + _per_client(n_frac) * cfg.rho * u_i
    if cfg.precondition == "raw":
        upd = _per_client(eta) * grad_u
    else:
        gram_v = _gram(v_i)
        if cfg.precondition == "newton":
            eye = torch.eye(gram_v.shape[-1], dtype=gram_v.dtype,
                            device=gram_v.device)
            h = gram_v + _per_client(n_frac) * cfg.rho * eye
            sol, _ = torch.linalg.solve_ex(h, grad_u.transpose(-1, -2))
            upd = _per_client(eta) * sol.transpose(-1, -2)
        else:
            lip = core_ops.spectral_norm_ub_gram(gram_v) + n_frac * cfg.rho
            upd = _per_client(eta / lip) * grad_u
    return u_i - upd


def local_round(u_global: Tensor, v: Tensor, m_blk: Tensor, *,
                cfg: DCFConfig, lam, n_frac, eta: Tensor, w=None,
                reduce_m=None):
    """Every client's work in one consensus round (Alg. 1): K local
    iterations of {inner (V, S) solve; one gradient step on the local U}.

    ``u_global`` is the (m, r) broadcast (or an (E, m, r) stack), ``v`` and
    ``m_blk`` are (E, n_i, r) and (E, m, n_i), ``lam`` is one threshold per
    client (E,) or a scalar, ``n_frac`` the clients' regularizer shares,
    ``eta`` the step size (0-d, or (E,) one a client).  A batch of B
    problems comes as B·E clients, its U broadcast as a (B·E, m, r) stack.
    ``m_blk`` may be bf16 and ``w`` dense or bit-packed (the kernels take
    both as they are).  Returns ``(U_i (E, m, r), V_i, diag)``; ``diag`` is
    ``(H_lam(R_W), ||Psi||_F^2)`` per client from the last fused pass
    (``None`` under ``fused="off"``): under ``"diag"`` at (U_i before its
    step, V_i final), under ``"dual"`` one sweep earlier, as the reference.

    ``reduce_m`` sums row-partial results over the model group of the
    sharded engine (each rank holding a row block of its client): the Gram
    of U and every ``Psi^T U``.  ``Psi V`` and the U-step stay row-local.
    ``None`` is the identity (the simulated engine).
    """
    reduce_m = reduce_m or _identity
    e = m_blk.shape[0]
    u_i = u_global.expand(e, *u_global.shape[-2:]).contiguous()
    make_update = _altmin_update if cfg.inner == "altmin" else _gd_update
    diag = None
    for _ in range(cfg.local_iters):
        # One inner-solver context (Gram, factorization) per U.
        update = make_update(u_i, cfg.rho, reduce_m)
        if cfg.fused == "dual":
            v = _sweeps(update, u_i, v, m_blk, lam, cfg.inner_sweeps - 1,
                        cfg.impl, w, reduce_m)
            cv, psi_v, obj, psi2 = kops.huber_dual_contract(
                u_i, v, m_blk, lam, w=w, impl=cfg.impl)
            v = update(v, reduce_m(cv))
            diag = (obj, psi2)
        else:
            v = _sweeps(update, u_i, v, m_blk, lam, cfg.inner_sweeps,
                        cfg.impl, w, reduce_m)
            if cfg.fused == "diag":
                psi_v, obj, psi2 = kops.huber_contract_u_diag(
                    u_i, v, m_blk, lam, w=w, impl=cfg.impl)
                diag = (obj, psi2)
            else:
                psi_v = kops.huber_contract_u(u_i, v, m_blk, lam, w=w,
                                              impl=cfg.impl)
        u_i = _u_step(cfg, u_i, v, psi_v, n_frac, eta)
    return u_i, v, diag


def finalize(u: Tensor, v: Tensor, m_blk: Tensor, lam, impl: str,
             w=None) -> tuple[Tensor, Tensor]:
    """Recovered ``(L, S)``: ``L = U V^T`` dense, ``S`` on observed entries."""
    l_blk = u @ v.transpose(-1, -2)
    u_full = u if m_blk.ndim == u.ndim else (
        u.expand(m_blk.shape[0], *u.shape).contiguous())
    s_blk = kops.residual_shrink(u_full, v, m_blk, lam, w=w, impl=impl)
    return l_blk, s_blk


def local_objective(u, v, m_blk, rho: float, lam, n_frac, w=None) -> Tensor:
    """Per-client ``g_i(U)``: the eliminated objective (Eq. 17) plus the
    client's share of the U regularizer; shape ``m_blk.shape[:-2]``."""
    resid = m_blk.to(torch.float32) - u @ v.transpose(-1, -2)
    if w is not None:
        resid = bitmask.resolve_mask(w, m_blk.shape[-1]) * resid
    data = core_ops.huber_loss(resid, _per_client(lam), dim=(-2, -1))
    return data + 0.5 * rho * ((v * v).sum(dim=(-2, -1))
                               + n_frac * (u * u).sum(dim=(-2, -1)))


def reg_terms(u: Tensor, v: Tensor, rho: float, n_frac) -> Tensor:
    """The rho/2 regularizer share added to an epilogue-measured data term;
    one a problem for a batch (``u`` (B, m, r), ``v`` (B, n, r) or
    (B, E, n_i, r))."""
    if u.ndim == 2:
        return 0.5 * rho * ((v * v).sum() + n_frac * (u * u).sum())
    return 0.5 * rho * ((v * v).sum(dim=tuple(range(1, v.ndim)))
                        + n_frac * (u * u).sum(dim=(-2, -1)))
