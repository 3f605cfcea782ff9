"""APGM: accelerated proximal gradient for relaxed RPCA (Lin et al. 2009), a
centralized baseline of paper Fig. 1 (counterpart of ``repro.core.apgm``).
It solves formulation (3):

    min_{L,S}  mu ||L||_* + mu lam ||S||_1 + 1/2 ||L + S - M||_F^2

with Nesterov acceleration and continuation on mu (mu_k -> mu_bar).  Each
iteration takes one full SVD (``core.ops.svt``): the scaling bottleneck
DCF-PCA removes.  It runs on the solver runtime (``core.runtime.run``, all
three modes) and registers itself as method ``"apgm"`` with the front door;
:func:`apgm` is a thin shim over ``repro_torch.rpca.solve``.  fp32 data
only (the front door refuses bf16, as the reference's caps do).  On the
card each SVD synchronises with the host (cuSOLVER's ``info``), so a
scan-mode solve syncs once an iteration here, unlike the factorized
solvers.  A batch (:func:`apgm_batch`: (B, m, n)) takes one batched SVD
an iteration for all B problems.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch import rpca as _rpca
from repro_torch.core import runtime as rt
from repro_torch.core import validate
from repro_torch.core.ops import (
    fro, masked_soft_threshold, per_problem as pp, soft_threshold,
    spectral_norm, svt, total,
)

Tensor = torch.Tensor


@dataclass(frozen=True)
class APGMConfig:
    iters: int = 200
    lam: float | None = None  # None => 1/sqrt(max(m, n))
    mu_scale: float = 0.99  # mu_0 = mu_scale * ||M||_2
    mu_bar_scale: float = 1e-5  # mu_bar = mu_bar_scale * mu_0
    eta: float = 0.9  # continuation factor mu_{k+1} = max(eta mu_k, mu_bar)
    track_objective: bool = True  # kept for API compat; tracking is free here


class ConvexResult(NamedTuple):
    l: Tensor
    s: Tensor
    stats: rt.SolveStats

    @property
    def history(self) -> Tensor:
        """The per-iteration objective trace (APGM: the full relaxed
        objective; IALM: ``||L||_* + lam ||S||_1``)."""
        return self.stats.objective


class APGMProblem(NamedTuple):
    """Observed matrix and initial iterates on one device.  The cold start
    is ``L = S = 0``.  ``mask`` (0/1 Omega, ``None`` = fully observed)
    makes the coupling term ``1/2 ||P_Omega(L + S - M)||_F^2`` (robust
    matrix completion).  ``lam0`` optionally gives the l1 weight as an
    operand instead of the shape's default."""

    m_obs: Tensor
    l_init: Tensor
    s_init: Tensor
    mask: Tensor | None = None
    lam0: Tensor | None = None


class _Carry(NamedTuple):
    l: Tensor
    s: Tensor
    l_prev: Tensor
    s_prev: Tensor
    t_nes: Tensor
    t_prev: Tensor
    mu: Tensor
    lam: Tensor
    mu_bar: Tensor
    m_fro: Tensor
    diag: rt.Diag


def default_lam(p, lam: float | None) -> Tensor:
    """The l1 weight: the problem's ``lam0`` operand, else ``lam``, else
    ``1/sqrt(max(m, n))``, as a 0-d tensor of the data's type (one a
    problem, (B,), for a batch)."""
    m, n = p.m_obs.shape[-2:]
    like = dict(dtype=p.m_obs.dtype, device=p.m_obs.device)
    if p.lam0 is not None:
        return torch.as_tensor(p.lam0, **like)
    if lam is not None:
        lam = torch.tensor(lam, **like)
    else:
        lam = 1.0 / torch.sqrt(torch.tensor(float(max(m, n)), **like))
    return lam.expand(p.m_obs.shape[:-2])


def make_solver(cfg: APGMConfig) -> rt.Solver:
    """The runtime Solver for APGM under ``cfg``."""

    def init(p: APGMProblem) -> _Carry:
        lam = default_lam(p, cfg.lam)
        # convex_data zero-fills hidden entries, so every norm below is an
        # observed-entry norm.
        norm2 = spectral_norm(p.m_obs)
        mu0 = cfg.mu_scale * norm2
        lead = p.m_obs.shape[:-2]  # () or (B,)
        one = torch.ones(lead, device=p.m_obs.device)
        inf = torch.full(lead, float("inf"), device=p.m_obs.device)
        return _Carry(
            l=p.l_init, s=p.s_init, l_prev=p.l_init, s_prev=p.s_init,
            t_nes=one, t_prev=one, mu=mu0,
            lam=lam, mu_bar=cfg.mu_bar_scale * mu0,
            m_fro=fro(p.m_obs) + 1e-30,
            diag=rt.Diag(inf, inf),
        )

    def step(p: APGMProblem, c: _Carry, t: Tensor) -> _Carry:
        # Nesterov extrapolation points.
        beta = pp((c.t_prev - 1.0) / c.t_nes)
        yl = c.l + beta * (c.l - c.l_prev)
        ys = c.s + beta * (c.s - c.s_prev)
        # Gradient of the coupling term (Lipschitz 2; a mask only shrinks
        # the constant).
        g = yl + ys - p.m_obs
        if p.mask is not None:
            g = p.mask * g
        l_new, sv = svt(yl - 0.5 * g, c.mu / 2.0)
        if p.mask is None:
            s_new = soft_threshold(ys - 0.5 * g, pp(c.lam * c.mu / 2.0))
        else:  # S lives on the observed support
            s_new = masked_soft_threshold(ys - 0.5 * g,
                                          pp(c.lam * c.mu / 2.0), p.mask)
        t_new = (1.0 + torch.sqrt(1.0 + 4.0 * c.t_nes * c.t_nes)) / 2.0
        mu_new = torch.maximum(cfg.eta * c.mu, c.mu_bar)
        # The full relaxed objective at this iteration's mu; ||L||_* is
        # svt's thresholded spectrum.
        resid = l_new + s_new - p.m_obs
        if p.mask is not None:
            resid = p.mask * resid
        coupling = 0.5 * total(resid * resid)
        obj = c.mu * (sv.sum(-1) + c.lam * total(s_new.abs())) + coupling
        # Relative primal change: the standard APGM stopping measure.
        resid = (fro(l_new - c.l) + fro(s_new - c.s)) / c.m_fro
        return _Carry(
            l=l_new, s=s_new, l_prev=c.l, s_prev=c.s,
            t_nes=t_new, t_prev=c.t_nes, mu=mu_new,
            lam=c.lam, mu_bar=c.mu_bar, m_fro=c.m_fro,
            diag=rt.Diag(obj, resid),
        )

    def diagnostics(p: APGMProblem, c: _Carry) -> rt.Diag:
        return c.diag

    def finalize(p: APGMProblem, c: _Carry):
        return c.l, c.s

    return rt.Solver(init, step, diagnostics, finalize)


def convex_data(m_obs, warm, mask, device: torch.device):
    """The fp32 data plane, the warm pair and the dense mask on ``device``,
    hidden entries zero-filled: the solution must not depend on what the
    caller stored there, and ``+ 0.0`` turns -0.0 into +0.0 so the SVD sees
    one representation."""
    m_obs = torch.as_tensor(m_obs).to(device=device, dtype=torch.float32)
    if mask is not None:
        validate.check_mask(mask, tuple(m_obs.shape))
        mask = torch.as_tensor(mask).to(device=device, dtype=torch.float32)
        m_obs = mask * m_obs + 0.0
    if warm is not None:
        warm = tuple(torch.as_tensor(x).to(device=device, dtype=torch.float32)
                     for x in warm)
    return m_obs.contiguous(), warm, mask


def _problem(m_obs: Tensor, warm, mask=None, lam0=None) -> APGMProblem:
    """The problem from device tensors (:func:`convex_data`'s)."""
    if warm is None:
        z = torch.zeros_like(m_obs)
        return APGMProblem(m_obs=m_obs, l_init=z, s_init=z, mask=mask,
                           lam0=lam0)
    l0, s0 = warm
    return APGMProblem(m_obs=m_obs, l_init=l0, s_init=s0, mask=mask,
                       lam0=lam0)


def solve_problem(problem: APGMProblem, cfg: APGMConfig,
                  run: rt.RunConfig | str | None = None) -> ConvexResult:
    """Run the solver on an assembled problem (or a batch (B, m, n):
    ``runtime.solve_batch``) and finalize."""
    return solve_convex(make_solver(cfg), problem, cfg.iters, run)


def solve_convex(solver: rt.Solver, problem, iters: int,
                 run: rt.RunConfig | str | None) -> ConvexResult:
    """``solver`` on one problem (``runtime.run``) or a batch
    (``runtime.solve_batch``), finalized."""
    run = rt.resolve_run(run)
    if problem.m_obs.ndim == 3:
        (l, s), _, stats = rt.solve_batch(solver, problem, iters, run)
        return ConvexResult(l=l, s=s, stats=stats)
    carry, stats = rt.run(solver, problem, iters, run)
    l, s = solver.finalize(problem, carry)
    return ConvexResult(l=l, s=s, stats=stats)


def _solve(m_obs, cfg: APGMConfig, *, run: rt.RunConfig, warm=None,
           mask=None, device: torch.device) -> ConvexResult:
    m_obs, warm, mask = convex_data(m_obs, warm, mask, device)
    return solve_problem(_problem(m_obs, warm, mask), cfg, run)


# ---------------------------------------------------------------------------
# Registry adapter and entry point (repro_torch.rpca front door)
# ---------------------------------------------------------------------------
def _registry_make(spec, cfg, run_cfg, device):
    cfg = cfg if cfg is not None else APGMConfig()
    _rpca.require_cfg_type("apgm", cfg, APGMConfig)
    if spec.warm is not None:
        validate.check_warm_lowrank_sparse(spec.warm, tuple(spec.m_obs.shape))
    res = _solve(spec.m_obs, cfg, run=run_cfg, warm=spec.warm,
                 mask=spec.mask, device=device)
    return res.l, res.s, None, None, res.stats


def convex_aot_hooks(name: str, cfg_type: type, make_solver,
                     make_problem) -> _rpca.AOTHooks:
    """A convex solver's compile-cache hooks (the reference's
    ``_aot_program`` of IALM and APGM): the padded tail is mask-zero, so
    every iterate stays zero there and the true block matches the unpadded
    solve; ``lam0`` pins the true-shape threshold unless the config fixed
    one.  The entry buckets and pads, but its rounds run eagerly: the SVD
    reads cuSOLVER's status on the host every iteration, which no CUDA
    graph can capture (the solver is not ``capturable``)."""

    def resolve_cfg(cfg, spec):
        cfg = cfg if cfg is not None else cfg_type()
        _rpca.require_cfg_type(name, cfg, cfg_type)
        return cfg

    def program(cfg, run_cfg: rt.RunConfig):
        def problem(m_obs, key, mask, warm, lam0):
            del key  # no random init
            m_obs, warm, mask = convex_data(m_obs, warm, mask, m_obs.device)
            return make_problem(m_obs, warm, mask,
                                lam0=None if cfg.lam is not None else lam0)

        return make_solver(cfg), cfg.iters, problem

    def warm_shapes(cfg, m: int, n: int):
        return (("L", (m, n), "(m, n)"), ("S", (m, n), "(m, n)"))

    return _rpca.AOTHooks(resolve_cfg=resolve_cfg, program=program,
                          warm_shapes=warm_shapes)


def convex_service_hooks(make_solver_fn, problem_fn,
                         default_cfg: type) -> _rpca.ServiceHooks:
    """The slot-service hooks shared by the convex (L, S) solvers (APGM,
    IALM; the reference's ``convex_service_hooks``).  Both carry the same
    slot layout: data-shaped ``m_obs``, ``l_init``, ``s_init`` planes and
    an always-present mask plane (all-ones for maskless submissions:
    numerically the unmasked path); warm starts are ``(L, S)`` iterates,
    padded along the columns for ragged widths.  An empty slot is the
    zero matrix, which both solvers' initialisations take (IALM's guard,
    APGM's zero spectrum)."""

    def empty_problems(cfg, slots: int, m: int, n: int,
                       device: torch.device):
        def zeros():  # one tensor a field: slot writes go into each
            return torch.zeros(slots, m, n, device=device)

        return problem_fn(zeros(), (zeros(), zeros()),
                          torch.ones(slots, m, n, device=device))

    def make_problem(m_obs, cfg, key, warm, mask, device: torch.device):
        del key  # convex solvers have no random init
        if mask is None:
            mask = torch.ones(tuple(m_obs.shape), device=device)
        m_obs, warm, mask = convex_data(m_obs, warm, mask, device)
        return problem_fn(m_obs, warm, mask)

    def warm_layout(cfg, m: int, n_req: int):
        return (
            ("L", (m, n_req), "(m, n)", 1),
            ("S", (m, n_req), "(m, n)", 1),
        )

    return _rpca.ServiceHooks(
        make_solver=make_solver_fn,
        empty_problems=empty_problems,
        make_problem=make_problem,
        unpack=lambda fin: (fin[0], fin[1], None, None),
        warm_layout=warm_layout,
        default_cfg=default_cfg,
        cfg_type=default_cfg,  # the convex config classes are the factory
    )


_rpca.register_solver(
    "apgm",
    _rpca.SolverCaps(supports_mask=True, supports_factors=False,
                     batchable=True, supports_service=True),
    _registry_make,
    service=convex_service_hooks(make_solver, _problem, APGMConfig),
    aot=convex_aot_hooks("apgm", APGMConfig, make_solver, _problem),
)


def apgm(m_obs, cfg: APGMConfig = APGMConfig(), *,
         run: rt.RunConfig | str | None = None,
         warm: tuple[Any, Any] | None = None, mask=None,
         device: torch.device | str | None = None) -> ConvexResult:
    """Solve one problem on ``device`` (the card unless ``"cpu"``).
    ``run=None`` is the paper's fixed schedule; ``mask`` (0/1 Omega)
    solves robust matrix completion.  A shim over
    ``repro_torch.rpca.solve(..., method="apgm")``."""
    res = _rpca.solve(_rpca.RPCASpec(m_obs, mask=mask, warm=warm),
                      method="apgm", run=run, cfg=cfg, device=device)
    return ConvexResult(l=res.l, s=res.s, stats=res.stats)


def apgm_batch(m_batch, cfg: APGMConfig = APGMConfig(), *,
               run: rt.RunConfig | str | None = None,
               warm: tuple[Any, Any] | None = None, mask=None,
               device: torch.device | str | None = None) -> ConvexResult:
    """Solve a stack of problems (``m_batch``, ``mask`` and each warm
    component (B, m, n)) together, one batched SVD an iteration; under the
    early-exit modes a finished problem freezes.  A shim over
    ``repro_torch.rpca.solve`` (the leading axis selects the batch)."""
    return apgm(m_batch, cfg, run=run, warm=warm, mask=mask, device=device)
