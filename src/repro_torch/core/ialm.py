"""IALM: the inexact augmented Lagrangian method for exact RPCA (Lin et al.
2010, the "ALM" baseline of paper Fig. 1; counterpart of
``repro.core.ialm``).  It solves formulation (2):

    min ||L||_* + lam ||S||_1   s.t.  L + S = M

through the augmented Lagrangian ``||L||_* + lam ||S||_1 + <Y, M - L - S>
+ mu/2 ||M - L - S||_F^2`` with one prox update of each block per dual
step: one full SVD an iteration (``core.ops.svt``).  It runs on the solver
runtime and registers itself as method ``"ialm"``, the front door's pick
for a small fp32 problem given with no rank (``rpca.auto_method``).  The
residual diagnostic is the constraint violation ``||M - L - S||_F /
||M||_F`` (the standard stopping rule), the objective ``||L||_* + lam
||S||_1``.  As APGM, fp32 data only, and one host sync an iteration on the
card (the SVD).  A batch (:func:`ialm_batch`: (B, m, n)) takes one batched
SVD an iteration for all B problems.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch import rpca as _rpca
from repro_torch.core import runtime as rt
from repro_torch.core import validate
from repro_torch.core.apgm import (
    ConvexResult, convex_aot_hooks, convex_data, default_lam, solve_convex,
)
from repro_torch.core.ops import (
    amax, fro, masked_soft_threshold, per_problem as pp, soft_threshold,
    spectral_norm, svt, total,
)

Tensor = torch.Tensor


@dataclass(frozen=True)
class IALMConfig:
    iters: int = 100
    lam: float | None = None  # None => 1/sqrt(max(m, n))
    mu_factor: float = 1.25  # mu_0 = mu_factor / ||M||_2
    rho: float = 1.5  # geometric dual step growth
    mu_max_scale: float = 1e7
    track_objective: bool = True  # kept for API compat; tracking is free here


class IALMProblem(NamedTuple):
    """Observed matrix and initial iterates on one device.  ``mask`` (0/1
    Omega, ``None`` = fully observed) solves the completion variant: the
    constraint ``L + S = M`` holds on Omega only, and off the mask S
    absorbs the residual, so the SVT step still sees a dense argument while
    the hidden entries of M never reach the solution.  ``lam0`` optionally
    gives the l1 weight as an operand."""

    m_obs: Tensor
    l_init: Tensor
    s_init: Tensor
    mask: Tensor | None = None
    lam0: Tensor | None = None


class _Carry(NamedTuple):
    l: Tensor
    s: Tensor
    y: Tensor
    mu: Tensor
    lam: Tensor
    mu_max: Tensor
    m_fro: Tensor
    diag: rt.Diag


def make_solver(cfg: IALMConfig) -> rt.Solver:
    """The runtime Solver for IALM under ``cfg``."""

    def init(p: IALMProblem) -> _Carry:
        lam = default_lam(p, cfg.lam)
        # Zero-matrix guard: an all-zero M would put 0/0 into y and inf
        # into mu.  max(x, tiny) is x for any real problem, and the zero
        # case gets the right fixed point y = 0.
        norm2 = torch.clamp_min(spectral_norm(p.m_obs), 1e-30)
        # The standard IALM initialization (Lin et al. 2010).
        j2 = torch.maximum(norm2, amax(p.m_obs.abs()) / lam)
        mu0 = cfg.mu_factor / norm2
        inf = torch.full(p.m_obs.shape[:-2], float("inf"),
                         device=p.m_obs.device)
        return _Carry(
            l=p.l_init, s=p.s_init, y=p.m_obs / pp(j2), mu=mu0,
            lam=lam, mu_max=cfg.mu_max_scale * mu0,
            m_fro=fro(p.m_obs) + 1e-30,
            diag=rt.Diag(inf, inf),
        )

    def step(p: IALMProblem, c: _Carry, t: Tensor) -> _Carry:
        mu = pp(c.mu)
        l_new, sv = svt(p.m_obs - c.s + c.y / mu, 1.0 / c.mu)
        s_arg = p.m_obs - l_new + c.y / mu
        if p.mask is None:
            s_new = soft_threshold(s_arg, pp(c.lam / c.mu))
        else:
            # Off the mask S is free: it absorbs the residual there, so the
            # constraint (and the dual update) act on Omega only.
            s_new = (masked_soft_threshold(s_arg, pp(c.lam / c.mu), p.mask)
                     + (1.0 - p.mask) * s_arg)
        resid = p.m_obs - l_new - s_new
        y_new = c.y + mu * resid
        mu_new = torch.minimum(cfg.rho * c.mu, c.mu_max)
        s_obs = s_new if p.mask is None else p.mask * s_new
        obj = sv.sum(-1) + c.lam * total(s_obs.abs())
        rel_resid = resid if p.mask is None else p.mask * resid
        rel = fro(rel_resid) / c.m_fro
        return _Carry(
            l=l_new, s=s_new, y=y_new, mu=mu_new,
            lam=c.lam, mu_max=c.mu_max, m_fro=c.m_fro,
            diag=rt.Diag(obj, rel),
        )

    def diagnostics(p: IALMProblem, c: _Carry) -> rt.Diag:
        return c.diag

    def finalize(p: IALMProblem, c: _Carry):
        # S on the observed support only (off the mask it holds the
        # constraint's fill, not a sparse-corruption estimate).
        return c.l, (c.s if p.mask is None else p.mask * c.s)

    return rt.Solver(init, step, diagnostics, finalize)


def _problem(m_obs: Tensor, warm, mask=None, lam0=None) -> IALMProblem:
    """The problem from device tensors (``apgm.convex_data``'s)."""
    if warm is None:
        z = torch.zeros_like(m_obs)
        return IALMProblem(m_obs=m_obs, l_init=z, s_init=z, mask=mask,
                           lam0=lam0)
    l0, s0 = warm
    return IALMProblem(m_obs=m_obs, l_init=l0, s_init=s0, mask=mask,
                       lam0=lam0)


def solve_problem(problem: IALMProblem, cfg: IALMConfig,
                  run: rt.RunConfig | str | None = None) -> ConvexResult:
    """Run the solver on an assembled problem (or a batch (B, m, n):
    ``runtime.solve_batch``) and finalize."""
    return solve_convex(make_solver(cfg), problem, cfg.iters, run)


def _solve(m_obs, cfg: IALMConfig, *, run: rt.RunConfig, warm=None,
           mask=None, device: torch.device) -> ConvexResult:
    m_obs, warm, mask = convex_data(m_obs, warm, mask, device)
    return solve_problem(_problem(m_obs, warm, mask), cfg, run)


# ---------------------------------------------------------------------------
# Registry adapter and entry point (repro_torch.rpca front door)
# ---------------------------------------------------------------------------
def _registry_make(spec, cfg, run_cfg, device):
    cfg = cfg if cfg is not None else IALMConfig()
    _rpca.require_cfg_type("ialm", cfg, IALMConfig)
    if spec.warm is not None:
        validate.check_warm_lowrank_sparse(spec.warm, tuple(spec.m_obs.shape))
    res = _solve(spec.m_obs, cfg, run=run_cfg, warm=spec.warm,
                 mask=spec.mask, device=device)
    return res.l, res.s, None, None, res.stats


_rpca.register_solver(
    "ialm",
    _rpca.SolverCaps(supports_mask=True, supports_factors=False,
                     batchable=True, supports_service=True),
    _registry_make,
    aot=convex_aot_hooks("ialm", IALMConfig, make_solver, _problem),
)


def ialm(m_obs, cfg: IALMConfig = IALMConfig(), *,
         run: rt.RunConfig | str | None = None,
         warm: tuple[Any, Any] | None = None, mask=None,
         device: torch.device | str | None = None) -> ConvexResult:
    """Solve one problem on ``device`` (the card unless ``"cpu"``).
    ``run=None`` is the paper's fixed schedule; ``mask`` (0/1 Omega)
    solves robust matrix completion.  A shim over
    ``repro_torch.rpca.solve(..., method="ialm")``."""
    res = _rpca.solve(_rpca.RPCASpec(m_obs, mask=mask, warm=warm),
                      method="ialm", run=run, cfg=cfg, device=device)
    return ConvexResult(l=res.l, s=res.s, stats=res.stats)


def ialm_batch(m_batch, cfg: IALMConfig = IALMConfig(), *,
               run: rt.RunConfig | str | None = None,
               warm: tuple[Any, Any] | None = None, mask=None,
               device: torch.device | str | None = None) -> ConvexResult:
    """Solve a stack of problems (``m_batch``, ``mask`` and each warm
    component (B, m, n)) together, one batched SVD an iteration; under the
    early-exit modes a finished problem freezes.  A shim over
    ``repro_torch.rpca.solve`` (the leading axis selects the batch)."""
    return ialm(m_batch, cfg, run=run, warm=warm, mask=mask, device=device)
