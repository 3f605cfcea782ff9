"""DCF-PCA, Algorithm 1: distributed RPCA by consensus factorization, in the
simulated-client engine (counterpart of ``repro.core.dcf_pca`` :54-270 and
:490-599).

The E column blocks live on a leading axis of one device.  Each round the
server broadcasts U, every client runs K local iterations (all clients in
the same batched kernel launches), and the consensus (Eq. 9) is the mean of
the client factors over that axis, weighted by true column counts when
``n % E != 0``.  A ragged ``n`` is zero-padded into equal blocks and the
padding is excluded through a mask-zero plane, so a ragged problem always
carries a mask.

The topology is elastic and fault-tolerant, as the reference's: a
``participation`` schedule (T, E) drops clients from rounds, and a fault
table (``distributed.faults``) crashes, poisons or delays them at the
consensus boundary.  Every client still runs its local round in the
batched launches (a round's launch counts do not depend on who is in);
the consensus leaves out the dropped ones, and a crashed or dropped
client's ``V_i`` is frozen bit for bit.  ``cfg.aggregator`` and
``cfg.divergence_screen`` choose a Byzantine-robust consensus
(``core.factorized.aggregate_stacked``).  A solve with ``checkpoint_dir``
or ``resume_from`` runs through ``runtime.run_segmented``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import rpca as _rpca
from repro_torch.core import factorized as fz
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core import validate
from repro_torch.core.cf_pca import prepare_data
from repro_torch.device import resolve_device
from repro_torch.distributed import faults as flt
from repro_torch.kernels import bitmask

Tensor = torch.Tensor


class DCFResult(NamedTuple):
    l: Tensor  # recovered low-rank matrix (m, n)
    s: Tensor  # recovered sparse matrix (m, n)
    u: Tensor  # consensus left factor (m, r)
    v: Tensor  # per-client right factors (E, n_i, r)
    stats: rt.SolveStats


class DCFProblem(NamedTuple):
    """Client blocks and initial factors on one device.  ``n_cols`` holds
    the true per-client column counts of a ragged split (``None`` = equal
    blocks); a ragged split always carries ``mask``."""

    blocks: Tensor  # (E, m, n_i), contiguous fp32 or bf16
    u_init: Tensor  # (m, r) server broadcast
    v_init: Tensor  # (E, n_i, r)
    lam0: Tensor  # () base threshold
    t0: Tensor  # () int32 schedule offset
    # (E, m, n_i) fp32, or (E, m, ceil(n_i / 8)) uint8 when packed
    mask: Tensor | None = None
    n_cols: Tensor | None = None  # (E,) true column counts
    participation: Tensor | None = None  # (T_sched, E) fp32 0/1 schedule
    faults: Tensor | None = None  # (T_f, E) int32 fault codes


class _Carry(NamedTuple):
    u: Tensor
    v: Tensor
    diag: rt.Diag


def _inject_round_faults(p: DCFProblem, t: Tensor, u_i: Tensor,
                         u_prev: Tensor):
    """Round ``t``'s faults at the consensus boundary.  Returns ``(u_i,
    part, v_mask)``: the (possibly corrupted) payloads, the round's
    participation (crash and flaky votes dropped; ``None`` when everyone
    is in) and the V-advance mask (``None`` when every V advances)."""
    pt = (None if p.participation is None
          else flt.round_codes(p.participation, t))
    if p.faults is None:
        return u_i, pt, pt
    code = flt.round_codes(p.faults, t)
    u_i = flt.corrupt_payload(code, u_i, u_prev)
    live, adv = flt.live_mask(code), flt.v_advance_mask(code)
    if pt is None:
        return u_i, live, adv
    return u_i, pt * live, pt * adv


def _sim_local_rounds(cfg: fz.DCFConfig, p: DCFProblem, u: Tensor,
                      v: Tensor, eta: Tensor, lam_t: Tensor):
    """Broadcast U; all clients run their K local iterations in the same
    batched launches.  Returns ``(u_i, v_new, diag_i, n_frac)``."""
    e = p.blocks.shape[0]
    n_frac = 1.0 / e if p.n_cols is None else p.n_cols / p.n_cols.sum()
    lam_e = lam_t.expand(e).contiguous()
    u_i, v_new, diag_i = fz.local_round(u, v, p.blocks, cfg=cfg, lam=lam_e,
                                        n_frac=n_frac, eta=eta, w=p.mask)
    return u_i, v_new, diag_i, n_frac


def make_solver(cfg: fz.DCFConfig, *, with_objective: bool = False) -> rt.Solver:
    """Runtime Solver for the simulated-client engine."""
    fz.check_supported(cfg)
    track = cfg.track_objective or with_objective

    def init(p: DCFProblem) -> _Carry:
        inf = torch.full((), float("inf"), device=p.blocks.device)
        return _Carry(u=p.u_init, v=p.v_init, diag=rt.Diag(inf, inf))

    def step(p: DCFProblem, c: _Carry, t: Tensor) -> _Carry:
        e = p.blocks.shape[0]
        t = t + p.t0
        lam_t = cfg.lam_at(p.lam0, t)
        # The kernels' epilogues measure the objective, except where a
        # client may drop out: its epilogue measured a local round whose
        # factors are then discarded, so those rounds take the objective
        # pass over the frozen state (as the reference).
        fused_obj = (track and cfg.fused != "off"
                     and p.participation is None and p.faults is None)
        u_i, v_new, diag_i, n_frac = _sim_local_rounds(cfg, p, c.u, c.v,
                                                       cfg.lr(t), lam_t)
        u_i, pt, v_mask = _inject_round_faults(p, t, u_i, c.u)
        v = (v_new if v_mask is None
             else torch.where(v_mask[:, None, None] > 0, v_new, c.v))
        u, wsum = fz.aggregate_stacked(cfg, u_i, c.u, n_cols=p.n_cols,
                                       part=pt, num_clients=e)
        if fused_obj:
            # Data terms from the U-step epilogues plus the regularizer
            # (sum_i n_frac_i == 1, so U and the stacked V take full weight).
            obj = diag_i[0].sum() + fz.reg_terms(u, v, cfg.rho, 1.0)
        elif track:
            obj = fz.local_objective(u, v, p.blocks, cfg.rho, lam_t, n_frac,
                                     w=p.mask).sum()
        else:
            obj = torch.zeros((), device=u.device)
        resid = torch.linalg.norm(u - c.u) / (torch.linalg.norm(c.u) + 1e-30)
        if wsum is not None:
            # An all-dropout round (a user's schedule may hold one) is a
            # no-op: it re-emits the previous residual (a zero would read as
            # convergence) and an inf objective ("not measured").
            resid = torch.where(wsum > 0, resid, c.diag.residual)
            if track:
                obj = torch.where(wsum > 0, obj,
                                  torch.full((), float("inf"),
                                             device=u.device))
        return _Carry(u=u, v=v, diag=rt.Diag(obj, resid))

    def diagnostics(p: DCFProblem, c: _Carry) -> rt.Diag:
        return c.diag

    def finalize(p: DCFProblem, c: _Carry):
        e = p.blocks.shape[0]
        lam = cfg.final_lam(p.lam0).expand(e).contiguous()
        l_blocks, s_blocks = fz.finalize(c.u, c.v, p.blocks, lam, cfg.impl,
                                         w=p.mask)
        return (prob.merge_columns(l_blocks), prob.merge_columns(s_blocks),
                c.u, c.v)

    return rt.Solver(init, step, diagnostics, finalize)


def _resolve_participation(participation, rounds: int, num_clients: int,
                           gen: torch.Generator,
                           device: torch.device) -> Tensor | None:
    """The ``participation=`` argument as a (T, E) fp32 schedule on
    ``device``: a scalar rate draws a ``(rounds, E)`` schedule from ``gen``
    (every round keeps a participant: ``problems.participation_schedule``);
    a 2-D array is used as it is (values outside {0, 1} act as weights)."""
    if participation is None:
        return None
    part = torch.as_tensor(participation)
    if part.ndim == 0:
        return prob.participation_schedule(gen, rounds, num_clients,
                                           float(part)).to(device)
    if part.ndim != 2 or part.shape[1] != num_clients:
        raise ValueError(
            f"participation schedule has shape {tuple(part.shape)}, "
            f"expected (rounds, num_clients={num_clients})"
        )
    return part.to(device=device, dtype=torch.float32).contiguous()


def make_problem(
    m_obs,
    cfg: fz.DCFConfig,
    num_clients: int,
    generator: int | torch.Generator | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    t0: int | None = None,
    mask=None,
    participation=None,
    faults=None,
    *,
    device: torch.device | str | None = None,
) -> DCFProblem:
    """Assemble the simulated-engine problem on ``device`` (the card unless
    ``"cpu"``).  The blocks are made contiguous here, once; ``lam0`` is
    calibrated on the unpadded data.  A bf16 ``m_obs`` stays bf16, and
    ``cfg.pack_mask`` packs each client's mask slice after the split (a
    ragged split packs its all-ones base plane too, the padding's bits 0).
    ``participation`` is a (T, E) 0/1 schedule or a Bernoulli rate (drawn
    from ``generator`` after the initial factors); ``faults`` a
    ``distributed.faults.FaultPlan`` or its (T_f, E) code table."""
    validate.check_consensus_cfg(cfg, participation)
    validate.check_fault_plan(cfg, faults, num_clients)
    device = resolve_device(device)
    m_obs, mask, lam0 = prepare_data(m_obs, cfg, mask, device)
    m, n = m_obs.shape
    fz.check_grid(cfg, num_clients, m, device)
    blocks = prob.split_columns(m_obs, num_clients).contiguous()
    n_i = blocks.shape[-1]
    n_cols = None
    if n % num_clients:
        if mask is None:
            mask = torch.ones(m_obs.shape, device=device)
        n_cols = torch.tensor(prob.client_column_counts(n, num_clients),
                              dtype=torch.float32, device=device)
    if mask is not None:
        mask = prob.split_columns(mask, num_clients).contiguous()
        if cfg.pack_mask:
            mask = bitmask.pack_mask(mask)
    gen = prob.generator(generator)
    if warm is None:
        state = fz.init_state(gen, m, n_i, cfg.rank, device,
                              clients=num_clients)
        u0, v0 = state.u, state.v
    else:
        u0, v0 = validate.check_warm_shapes(
            warm, ("U", "V"),
            ((m, cfg.rank), (num_clients, n_i, cfg.rank)),
            ("(m, rank)", "(E, n_i, rank)"),
            suffixes=("", f" for num_clients={num_clients}, n={n}"),
        )
        u0 = torch.as_tensor(u0).to(device, torch.float32).contiguous()
        v0 = torch.as_tensor(v0).to(device, torch.float32).contiguous()
    sched = _resolve_participation(participation, cfg.outer_iters,
                                   num_clients, gen, device)
    if t0 is None:
        t0 = 0 if warm is None else cfg.outer_iters
    return DCFProblem(
        blocks=blocks, u_init=u0, v_init=v0, lam0=lam0,
        t0=torch.full((), t0, dtype=torch.int32, device=device), mask=mask,
        n_cols=n_cols, participation=sched,
        faults=flt.resolve_faults(faults, device),
    )


def solve_problem(problem: DCFProblem, cfg: fz.DCFConfig,
                  run: rt.RunConfig | str | None = None,
                  n: int | None = None, *,
                  checkpoint_dir: str | None = None,
                  resume_from: str | None = None) -> DCFResult:
    """Run the solver on an assembled problem and finalize; ``n`` trims the
    padding columns of a ragged split.  ``checkpoint_dir`` / ``resume_from``
    take the segmented driver (``runtime.run_segmented``: scan mode, a
    snapshot every ``run.checkpoint_every`` rounds, the same bits)."""
    run = rt.resolve_run(run)
    solver = make_solver(cfg, with_objective=run.needs_objective)
    if checkpoint_dir is None and resume_from is None:
        carry, stats = rt.run(solver, problem, cfg.outer_iters, run)
    else:
        carry, stats = rt.run_segmented(
            solver, problem, cfg.outer_iters, run,
            checkpoint_dir=checkpoint_dir, resume_from=resume_from)
    l, s, u, v = solver.finalize(problem, carry)
    if n is not None:
        l, s = l[:, :n], s[:, :n]
    return DCFResult(l=l, s=s, u=u, v=v, stats=stats)


def dcf_pca(
    m_obs,
    cfg: fz.DCFConfig,
    num_clients: int,
    generator: int | torch.Generator | None = None,
    *,
    run: rt.RunConfig | str | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    mask=None,
    participation=None,
    faults=None,
    checkpoint_dir: str | None = None,
    resume_from: str | None = None,
    device: torch.device | str | None = None,
) -> DCFResult:
    """DCF-PCA with ``num_clients`` simulated clients on ``device`` (the card
    unless ``"cpu"``).  ``n % num_clients != 0`` is allowed (padded blocks,
    count-weighted consensus); ``participation`` is a (T, E) 0/1 schedule
    or a rate (dropped clients freeze their V_i and sit out the round's
    consensus); ``faults`` a ``FaultPlan`` or code table;
    ``checkpoint_dir`` / ``resume_from`` snapshot and resume the solve
    (bit-exact with an uninterrupted one)."""
    problem = make_problem(m_obs, cfg, num_clients, generator, warm,
                           mask=mask, participation=participation,
                           faults=faults, device=device)
    return solve_problem(problem, cfg, run, n=m_obs.shape[-1],
                         checkpoint_dir=checkpoint_dir,
                         resume_from=resume_from)


# ---------------------------------------------------------------------------
# Registry adapters (repro_torch.rpca front door)
# ---------------------------------------------------------------------------
def _resolve_num_clients(spec) -> int:
    """E from the spec, or inferred from a 2-D participation schedule."""
    if spec.num_clients is not None:
        return spec.num_clients
    part = spec.participation
    if part is not None and len(getattr(part, "shape", ())) == 2:
        return part.shape[1]
    raise ValueError(
        "method 'dcf' needs a client count: set RPCASpec.num_clients "
        "(or pass a (T, E) participation schedule to infer E from)"
    )


def _default_cfg(spec, name: str) -> fz.DCFConfig:
    """The reference's default: the elastic preset at the schedule's mean
    participation (a rate as it is), the masked preset for a mask, else
    the tuned one."""
    rank = _rpca.require_rank(name, spec)
    part = spec.participation
    if part is not None:
        rate = float(torch.as_tensor(part, dtype=torch.float32).mean())
        return fz.DCFConfig.elastic(rank, participation=max(rate, 0.1))
    if spec.mask is not None:
        return fz.DCFConfig.masked(rank)
    return fz.DCFConfig.tuned(rank)


def _registry_make(spec, cfg, run_cfg, device):
    cfg = cfg if cfg is not None else _default_cfg(spec, "dcf")
    _rpca.require_cfg_type("dcf", cfg, fz.DCFConfig)
    num_clients = _resolve_num_clients(spec)
    validate.check_fault_plan(cfg, spec.faults, num_clients)
    res = dcf_pca(spec.m_obs, cfg, num_clients, _rpca.default_key(spec),
                  run=run_cfg, warm=spec.warm, mask=spec.mask,
                  participation=spec.participation, faults=spec.faults,
                  checkpoint_dir=spec.checkpoint_dir,
                  resume_from=spec.resume_from, device=device)
    return res.l, res.s, res.u, res.v, res.stats


def _registry_make_sharded(spec, cfg, run_cfg, device):
    raise NotImplementedError(
        "method 'dcf_sharded' (the SPMD engine over a device mesh) waits "
        "for a later slice of the port (ROADMAP.md)")


_rpca.register_solver(
    "dcf",
    _rpca.SolverCaps(supports_mask=True, supports_factors=True,
                     supports_clients=True, supports_participation=True,
                     batchable=True, needs_rank=True, supports_lowp=True,
                     supports_robust_agg=True, supports_checkpoint=True),
    _registry_make,
)

# The reference's caps, so that every refusal lists its methods; solving
# raises until the sharded engine is ported.
_rpca.register_solver(
    "dcf_sharded",
    _rpca.SolverCaps(supports_mask=True, supports_factors=True,
                     supports_participation=True, supports_sharding=True,
                     batchable=False, needs_rank=True, supports_lowp=True,
                     supports_multiprocess=True, supports_robust_agg=True,
                     supports_checkpoint=True),
    _registry_make_sharded,
)
