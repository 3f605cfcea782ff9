"""DCF-PCA, Algorithm 1: distributed RPCA by consensus factorization, in the
simulated-client engine and the sharded engine (counterpart of
``repro.core.dcf_pca`` :54-270, :490-599 and :863-1653).

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

``cfg.consensus_compress`` and ``cfg.consensus_delay`` take the wire solver
(:func:`_make_wire_solver`): the consensus in delta form, each client's
weighted delta top-k compressed with an error-feedback residual, and / or
applied one round late under a guard that falls back to synchronous
rounds.

A batch of B problems (:func:`make_batch`, :func:`dcf_pca_batch`) carries
a leading problem axis on every field and folds it into the kernels'
client axis: each sweep is one launch over B·E clients, and each problem
takes its own consensus.

The sharded engine (:func:`dcf_pca_sharded`, ``method="dcf_sharded"``)
runs one client a ``torch.distributed`` rank: each rank runs its client's
local iterations on its own block (a stack of one client, the same
kernels) and the ranks meet in collectives (``distributed.multihost.
MeshComm``), rows optionally split over a model axis.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from repro_torch import rpca as _rpca
from repro_torch.core import factorized as fz
from repro_torch.core import ops as core_ops
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
    blocks); a ragged split always carries ``mask``.  A batch
    (:func:`make_batch`) has a leading problem axis B on every field:
    blocks (B, E, m, n_i), u_init (B, m, r), lam0 and t0 (B,), n_cols
    (B, E), participation (B, T, E)."""

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


def _fold(x: Tensor | None) -> Tensor | None:
    """A batch's (B, E, ...) as the kernels' B·E clients (a view)."""
    return None if x is None else x.reshape(-1, *x.shape[2:])


def _clients(p: DCFProblem, x: Tensor) -> Tensor:
    """A batch's per-problem (B,) value for each of its B·E clients."""
    b, e = p.blocks.shape[:2]
    return x[:, None].expand(b, e).reshape(-1)


def _u_stack(p: DCFProblem, u: Tensor) -> Tensor:
    """A batch's consensus U (B, m, r) broadcast to its B·E clients."""
    b, e = p.blocks.shape[:2]
    return u[:, None].expand(b, e, *u.shape[-2:]).reshape(-1, *u.shape[-2:])


def _sim_local_rounds(cfg: fz.DCFConfig, p: DCFProblem, u: Tensor,
                      v: Tensor, eta: Tensor, lam_t: Tensor):
    """Broadcast U; all clients run their K local iterations in the same
    batched launches (a batch's B·E clients included).  Returns ``(u_i,
    v_new, diag_i, n_frac)``, stacked (E, ...) or (B, E, ...)."""
    if p.blocks.ndim == 3:
        e = p.blocks.shape[0]
        n_frac = 1.0 / e if p.n_cols is None else p.n_cols / p.n_cols.sum()
        lam_e = lam_t.expand(e).contiguous()
        u_i, v_new, diag_i = fz.local_round(u, v, p.blocks, cfg=cfg,
                                            lam=lam_e, n_frac=n_frac,
                                            eta=eta, w=p.mask)
        return u_i, v_new, diag_i, n_frac
    b, e = p.blocks.shape[:2]
    n_frac = (1.0 / e if p.n_cols is None
              else p.n_cols / p.n_cols.sum(-1, keepdim=True))
    u_i, v_new, diag_i = fz.local_round(
        _u_stack(p, u), _fold(v), _fold(p.blocks), cfg=cfg,
        lam=_clients(p, lam_t), eta=_clients(p, eta), w=_fold(p.mask),
        n_frac=n_frac if p.n_cols is None else n_frac.reshape(-1))
    diag = None if diag_i is None else tuple(d.view(b, e) for d in diag_i)
    return (u_i.view(b, e, *u_i.shape[1:]), v_new.view(v.shape), diag,
            n_frac)


def _objective(cfg: fz.DCFConfig, p: DCFProblem, u: Tensor, v: Tensor,
               lam_t: Tensor, n_frac) -> Tensor:
    """The global objective at the post-consensus state (one a problem)."""
    if p.blocks.ndim == 3:
        return fz.local_objective(u, v, p.blocks, cfg.rho, lam_t, n_frac,
                                  w=p.mask).sum()
    nf = n_frac if isinstance(n_frac, float) else n_frac.reshape(-1)
    obj = fz.local_objective(_u_stack(p, u), _fold(v), _fold(p.blocks),
                             cfg.rho, _clients(p, lam_t), nf,
                             w=_fold(p.mask))
    return obj.view(p.blocks.shape[:2]).sum(-1)


def _finalize(cfg: fz.DCFConfig, p: DCFProblem, u: Tensor, v: Tensor):
    """``(L, S, U, V)``: one shrink launch for every client (of the
    batch)."""
    lam = cfg.final_lam(p.lam0)
    if p.blocks.ndim == 3:
        lam = lam.expand(p.blocks.shape[0]).contiguous()
        l_blocks, s_blocks = fz.finalize(u, v, p.blocks, lam, cfg.impl,
                                         w=p.mask)
    else:
        l_blocks, s_blocks = fz.finalize(
            _u_stack(p, u), _fold(v), _fold(p.blocks), _clients(p, lam),
            cfg.impl, w=_fold(p.mask))
        l_blocks = l_blocks.view(*p.blocks.shape[:2], *l_blocks.shape[1:])
        s_blocks = s_blocks.view(l_blocks.shape)
    return (prob.merge_columns(l_blocks), prob.merge_columns(s_blocks),
            u, v)


def make_solver(cfg: fz.DCFConfig, *, with_objective: bool = False) -> rt.Solver:
    """Runtime Solver for the simulated-client engine (one problem or a
    batch, by the problem's shape); the wire solver when the config asks
    for a compressed or stale consensus."""
    track = cfg.track_objective or with_objective
    if cfg.consensus_compress is not None or cfg.consensus_delay:
        return _make_wire_solver(cfg, track)

    def init(p: DCFProblem) -> _Carry:
        inf = torch.full(p.lam0.shape, float("inf"), device=p.blocks.device)
        return _Carry(u=p.u_init, v=p.v_init, diag=rt.Diag(inf, inf))

    def step(p: DCFProblem, c: _Carry, t: Tensor) -> _Carry:
        e = p.blocks.shape[-3]
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
             else torch.where(v_mask[..., None, None] > 0, v_new, c.v))
        u, wsum = fz.aggregate_stacked(cfg, u_i, c.u, n_cols=p.n_cols,
                                       part=pt, num_clients=e)
        if fused_obj:
            # Data terms from the U-step epilogues plus the regularizer
            # (sum_i n_frac_i == 1, so U and the stacked V take full weight).
            obj = diag_i[0].sum(-1) + fz.reg_terms(u, v, cfg.rho, 1.0)
        elif track:
            obj = _objective(cfg, p, u, v, lam_t, n_frac)
        else:
            obj = torch.zeros(p.lam0.shape, device=u.device)
        resid = core_ops.fro(u - c.u) / (core_ops.fro(c.u) + 1e-30)
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
        return _finalize(cfg, p, c.u, c.v)

    return rt.Solver(init, step, diagnostics, finalize, capturable=True)


def _make_wire_solver(cfg: fz.DCFConfig, track: bool) -> rt.Solver:
    """The simulated-client solver with the consensus wire (the reference's
    ``_make_wire_solver``): top-k compressed deltas with error feedback
    (``cfg.consensus_compress``) and / or one-round stale application
    (``cfg.consensus_delay``).

    The consensus is taken in delta form: the active weights sum to 1, so
    ``sum_i w_i U_i == U + sum_i w_i (U_i - U)``, and each client's
    weighted delta is what crosses the wire (robust aggregators ship the
    unweighted delta and combine one vote a client on receipt).  With
    compression each client ships the top-k of its delta plus its
    error-feedback residual; what the top-k drops stays in the carry
    (``err``) and rides the next round's message.  The clients' payloads
    are scattered into one dense row each and summed over the client axis
    in one fixed order (``grad_compress.topk_reconstruct``): no atomics,
    the same bits on every run.  With ``consensus_delay=1`` the round's
    delta waits in ``pending`` and is applied a round later; the guard
    scalar, the fused epilogue's ``||Psi||_F^2`` summed over the clients
    (the ``diag``/``dual`` kernels give it free) or the delta's energy
    under ``fused="off"``, trips a sticky fall-back to synchronous
    application when it grows past ``cfg.stale_guard`` times its last
    value or turns non-finite.  ``finalize`` flushes ``pending``.

    The carry is a dict (``u``, ``v``, ``diag``; ``err``; ``pending``,
    ``sync`` (0-d bool), ``guard``), so the batch's freeze
    (``runtime.tree_where``) and the snapshots (``training.checkpoint``,
    sorted keys) take it as they take the named tuple."""
    from repro_torch.distributed import grad_compress as gcomp
    from repro_torch.distributed import multihost as mh

    compress, delay = cfg.consensus_compress, cfg.consensus_delay
    robust = cfg.aggregator != "weighted_mean"
    screen = cfg.divergence_screen

    def init(p: DCFProblem) -> dict:
        dev = p.blocks.device
        inf = torch.full(p.lam0.shape, float("inf"), device=dev)
        c = {"u": p.u_init, "v": p.v_init, "diag": rt.Diag(inf, inf)}
        if compress is not None:
            c["err"] = torch.zeros(p.v_init.shape[:-2] + p.u_init.shape[-2:],
                                   device=dev)
        if delay:
            c["pending"] = torch.zeros(p.u_init.shape, device=dev)
            c["sync"] = torch.zeros(p.lam0.shape, dtype=torch.bool,
                                    device=dev)
            c["guard"] = inf
        return c

    def step(p: DCFProblem, c: dict, t: Tensor) -> dict:
        e = p.blocks.shape[-3]
        dev = p.blocks.device
        lead = p.lam0.shape  # () or (B,)
        tg = t + p.t0
        lam_t = cfg.lam_at(p.lam0, tg)
        fused_obj = (track and cfg.fused != "off"
                     and p.participation is None and p.faults is None)
        u_used = c["u"]
        u_i, v_new, diag_i, n_frac = _sim_local_rounds(
            cfg, p, u_used, c["v"], cfg.lr(tg), lam_t)
        u_i, pt, v_mask = _inject_round_faults(p, tg, u_i, u_used)
        v = (v_new if v_mask is None
             else torch.where(v_mask[..., None, None] > 0, v_new, c["v"]))
        u_b = u_used.unsqueeze(-3)  # against the stacked clients
        wsum = None
        if robust:
            w = torch.ones(*lead, e, device=dev)
        elif pt is None:
            if p.n_cols is None:
                w = torch.full((*lead, e), 1.0 / e, device=dev)
            else:
                w, _ = fz.consensus_weights(p.n_cols, None, e, dev)
        else:
            w, wsum = fz.consensus_weights(p.n_cols, pt, e, dev)
            u_i = torch.where(pt[..., None, None] > 0, u_i, u_b)
        contrib = (w[..., None, None] * (u_i - u_b)).to(torch.float32)
        out = dict(c)
        if compress is None:
            if robust or screen is not None:
                act = torch.ones(*lead, e, device=dev) if pt is None else pt
                if screen is not None:
                    act = act * gcomp.divergence_screen_mask(contrib, act,
                                                             screen)
                if robust:
                    delta, cnt = gcomp.robust_combine_stacked(
                        contrib, act, cfg.aggregator, cfg.trim_frac)
                    wsum = cnt.to(torch.float32)
                else:
                    # The screened weighted mean: the weights again over the
                    # survivors.
                    w2, wsum = fz.consensus_weights(p.n_cols, act, e, dev)
                    deltas = (u_i - u_b).to(torch.float32)
                    delta = (w2[..., None, None] * torch.where(
                        act[..., None, None] > 0, deltas, 0.0)).sum(-3)
                    delta = torch.where(wsum[..., None, None] > 0, delta,
                                        0.0)
            else:
                delta = contrib.sum(-3)
        else:
            d = u_used.shape[-2] * u_used.shape[-1]
            k = mh.topk_k(d, compress.topk_frac)
            flat = (contrib + c["err"]).reshape(*contrib.shape[:-2], d)
            vals, idx = gcomp.topk_sparsify(flat, k)
            recon = gcomp.topk_reconstruct(vals, idx, d)
            err_new = (flat - recon).reshape(c["err"].shape)
            shipped = recon
            if pt is not None:
                # Dropped clients ship nothing and keep their residual.
                shipped = torch.where(pt[..., None] > 0, recon, 0.0)
                vals = torch.where(pt[..., None] > 0, vals, 0.0)
                err_new = torch.where(pt[..., None, None] > 0, err_new,
                                      c["err"])
            if robust:
                # A poisoned payload must not poison its own residual for
                # good: non-finite residuals reset.
                err_new = torch.where(torch.isfinite(err_new), err_new, 0.0)
                act = torch.ones(*lead, e, device=dev) if pt is None else pt
                if screen is not None:
                    # Judged on the shipped payloads' norms.
                    nrm = torch.sqrt((vals * vals).sum(-1))
                    act = act * gcomp.screen_from_norms(nrm, act, screen)
                delta, cnt = gcomp.robust_combine_stacked(
                    recon.reshape(contrib.shape), act, cfg.aggregator,
                    cfg.trim_frac)
                wsum = cnt.to(torch.float32)
            else:
                delta = shipped.sum(-2).reshape(u_used.shape)
            out["err"] = err_new
        if delay == 0:
            u = u_used + delta
        else:
            if diag_i is not None:
                scalar = diag_i[1].sum(-1)
            else:
                scalar = (delta * delta).sum(dim=(-2, -1))
            # Growth past the guard factor, or a non-finite scalar (NaN
            # compares False with everything, so growth alone would never
            # fire on it); once tripped, synchronous for good.
            trip = ~torch.isfinite(scalar) | (
                torch.isfinite(c["guard"])
                & (scalar > cfg.stale_guard * c["guard"]))
            sync = (c["sync"] | trip)[..., None, None]
            u = u_used + c["pending"] + torch.where(sync, delta, 0.0)
            out["pending"] = torch.where(sync, 0.0, delta)
            out["sync"] = sync[..., 0, 0]
            out["guard"] = scalar
        if fused_obj:
            obj = diag_i[0].sum(-1) + fz.reg_terms(u, v, cfg.rho, 1.0)
        elif track:
            obj = _objective(cfg, p, u, v, lam_t, n_frac)
        else:
            obj = torch.zeros(lead, device=dev)
        resid = core_ops.fro(u - u_used) / (core_ops.fro(u_used) + 1e-30)
        if delay:
            # Round 0 applies nothing (its delta waits): a zero residual
            # would read as convergence, so the previous one (inf) stays.
            resid = torch.where(t > 0, resid, c["diag"].residual)
        if wsum is not None:
            resid = torch.where(wsum > 0, resid, c["diag"].residual)
            if track:
                obj = torch.where(wsum > 0, obj,
                                  torch.full((), float("inf"), device=dev))
        out["u"], out["v"] = u, v
        out["diag"] = rt.Diag(obj, resid)
        return out

    def finalize(p: DCFProblem, c: dict):
        # The last round's delta is still in flight: apply it.
        u = c["u"] + c["pending"] if delay else c["u"]
        return _finalize(cfg, p, u, c["v"])

    return rt.Solver(init, step, lambda p, c: c["diag"], finalize,
                     capturable=True)


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


def make_batch(
    m_batch,
    cfg: fz.DCFConfig,
    num_clients: int,
    generators=None,
    warm: tuple[Tensor, Tensor] | None = None,
    mask=None,
    participation=None,
    *,
    device: torch.device | str | None = None,
) -> DCFProblem:
    """A batch of B problems (``m_batch`` (B, m, n)) on ``device``: problem
    b is :func:`make_problem` of ``m_batch[b]`` with its own seed or
    generator (``generators``: ``rpca.batch_keys``), ``mask[b]`` and
    ``warm`` ((B, m, r), (B, E, n_i, r)) slices, stacked on a leading
    problem axis.  ``participation`` is one (T, E) schedule for every
    problem, or a rate drawn per problem.  The kernels' grids must hold the
    batch's B·E clients (checked first).  The problems are built one by
    one (set-up); the solve runs them together."""
    device = resolve_device(device)
    b, m = m_batch.shape[0], m_batch.shape[-2]
    fz.check_supported(cfg, device)
    fz.check_grid(cfg, b * num_clients, m, device)
    keys = _rpca.batch_keys(generators, b)
    return rt.stack_problems([
        make_problem(m_batch[i], cfg, num_clients, keys[i],
                     None if warm is None else (warm[0][i], warm[1][i]),
                     mask=None if mask is None else mask[i],
                     participation=participation, device=device)
        for i in range(b)])


def solve_problem(problem: DCFProblem, cfg: fz.DCFConfig,
                  run: rt.RunConfig | str | None = None,
                  n: int | None = None, *,
                  checkpoint_dir: str | None = None,
                  resume_from: str | None = None) -> DCFResult:
    """Run the solver on an assembled problem and finalize; ``n`` trims the
    padding columns of a ragged split.  ``checkpoint_dir`` / ``resume_from``
    take the segmented driver (``runtime.run_segmented``: scan mode, a
    snapshot every ``run.checkpoint_every`` rounds, the same bits).  A
    batch (:func:`make_batch`) takes ``runtime.solve_batch``."""
    run = rt.resolve_run(run)
    solver = make_solver(cfg, with_objective=run.needs_objective)
    if problem.blocks.ndim == 4:
        if checkpoint_dir is not None or resume_from is not None:
            raise ValueError(_BATCH_CHECKPOINT)
        (l, s, u, v), _, stats = rt.solve_batch(solver, problem,
                                                cfg.outer_iters, run)
        if n is not None:
            l, s = l[..., :n], s[..., :n]
        return DCFResult(l=l, s=s, u=u, v=v, stats=stats)
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


def dcf_pca_batch(
    m_batch,
    cfg: fz.DCFConfig,
    num_clients: int,
    keys=None,
    *,
    run: rt.RunConfig | str | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    mask=None,
    participation=None,
    device: torch.device | str | None = None,
) -> DCFResult:
    """Solve a stack of problems (``m_batch`` (B, m, n)) together; under
    the early-exit modes a finished problem freezes.  ``keys``: one seed
    or generator a problem (``rpca.batch_keys``; default seeds 0..B-1);
    ``warm`` ((B, m, r), (B, E, n_i, r)); ``mask`` (B, m, n);
    ``participation`` one (T, E) schedule for the batch, or a rate that
    draws an independent schedule a problem.  A shim over
    ``repro_torch.rpca.solve`` (the leading axis selects the batch)."""
    res = _rpca.solve(
        _rpca.RPCASpec(m_batch, mask=mask, warm=warm, key=keys,
                       num_clients=num_clients,
                       participation=participation),
        method="dcf", run=run, cfg=cfg, device=device)
    return DCFResult(l=res.l, s=res.s, u=res.u, v=res.v, stats=res.stats)


# ---------------------------------------------------------------------------
# Engine 2: one client a rank, over a torch.distributed mesh
# ---------------------------------------------------------------------------
#: The reference's refusals of what the sharded engine does not take.
_SHARDED_PACK = ("cfg.pack_mask is not supported by the sharded engine (the "
                 "mask is sharded like M); use a dense mask, or the simulated "
                 "engine for bit-packed planes")
_SHARDED_SEGMENT_MODEL = (
    "checkpointed (segmented) sharded solves do not compose with model_axis "
    "row sharding; shard only over data_axes, or solve without "
    "checkpointing")


def _refuse_sharded(cfg: fz.DCFConfig, participation, mask) -> None:
    """What the sharded engine refuses whatever the mesh."""
    validate.check_consensus_cfg(cfg, participation)
    if cfg.pack_mask and mask is not None:
        raise ValueError(_SHARDED_PACK)


class ShardLayout(NamedTuple):
    """Where this rank's block sits: the rank's ``comm``
    (``distributed.multihost.MeshComm``: its client and row block), the
    global ``(m, n)``, the rows a row block holds (``m_loc``) and the
    padded columns a client holds (``n_i``; ``E n_i >= n``)."""

    comm: Any
    m: int
    n: int
    m_loc: int
    n_i: int

    @property
    def ragged(self) -> bool:
        return self.n_i * self.comm.clients != self.n


class ShardProblem(NamedTuple):
    """One rank's share of a sharded solve, on its device: its client's
    block of M (its row block of it) as a stack of one client, so the
    kernels take it as they take the simulated engine's blocks; the
    factors' rows it holds; the replicated threshold, schedule offset,
    participation schedule and fault table (each rank reads its client's
    column); and, for a ragged split, the mask (zero over the padding) and
    the client's true column count."""

    blocks: Tensor  # (1, m_loc, n_i), contiguous fp32 or bf16
    u_init: Tensor  # (m_loc, r): this row block of the server broadcast
    v_init: Tensor  # (1, n_i, r): this client's V_i
    lam0: Tensor  # () base threshold, calibrated on the whole M
    t0: Tensor  # () int32 schedule offset
    mask: Tensor | None = None  # (1, m_loc, n_i) fp32
    n_i: Tensor | None = None  # () fp32 true column count (ragged only)
    participation: Tensor | None = None  # (T_sched, E) fp32
    faults: Tensor | None = None  # (T_f, E) int32


def client_generator(key, client: int) -> torch.Generator:
    """The CPU generator of client ``client``'s initial ``V_i``: seeded from
    the solve's seed (a ``torch.Generator``'s initial seed) and the client
    index, so each rank draws its own block alone and a seed gives the
    same factors on any mesh of E clients."""
    base = key.initial_seed() if isinstance(key, torch.Generator) \
        else (0 if key is None else int(key))
    return torch.Generator().manual_seed(
        (base * 0x9E3779B1 + client + 1) % (1 << 63))


def make_sharded_problem(
    m_obs,
    cfg: fz.DCFConfig,
    comm,
    generator: int | torch.Generator | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    mask=None,
    participation=None,
    faults=None,
    *,
    device: torch.device | str | None = None,
) -> tuple[ShardProblem, ShardLayout]:
    """This rank's problem of a sharded solve over ``comm``'s mesh, on
    ``device`` (the card unless ``"cpu"``).

    Every rank is given the whole ``m_obs`` (and ``mask``), as every
    process is in the reference's multi-process entry; each computes the
    same ``lam0`` from it (on the unpadded data) and takes its client's
    columns (its data coordinate) and its row block (its model
    coordinate).  ``n % E != 0`` pads the column tail behind a mask-zero
    plane and weighs the consensus by each client's true column count.
    Cold factors: ``U`` from ``generator`` (the same on every rank), then
    ``V_i`` from :func:`client_generator`; a rate ``participation`` is
    drawn from ``generator`` after ``U``, the same on every rank.
    ``warm=(U, V)`` takes the engine's own result layout, ``(m, r)`` and
    ``(n, r)``, and resumes the schedules at ``t0 = outer_iters``."""
    _refuse_sharded(cfg, participation, mask)
    num_clients = comm.clients
    validate.check_fault_plan(cfg, faults, num_clients)
    device = resolve_device(device)
    m_obs, mask, lam0 = prepare_data(m_obs, cfg, mask, device)
    m, n = m_obs.shape
    if m % comm.model_size:
        raise ValueError(
            f"m={m} rows do not split into {comm.model_size} equal row "
            f"blocks over model_axis {comm.model_axis!r}")
    m_loc = m // comm.model_size
    n_i = -(-n // num_clients)
    layout = ShardLayout(comm=comm, m=m, n=n, m_loc=m_loc, n_i=n_i)
    fz.check_grid(cfg, 1, m_loc, device)
    rows = slice(comm.model_index * m_loc, (comm.model_index + 1) * m_loc)
    c0 = min(comm.client * n_i, n)
    c1 = min(c0 + n_i, n)

    def own(plane: Tensor) -> Tensor:
        """This rank's (m_loc, n_i) block, the padding zero."""
        blk = plane[rows, c0:c1]
        if c1 - c0 < n_i:
            blk = torch.nn.functional.pad(blk, (0, n_i - (c1 - c0)))
        return blk.contiguous()[None]

    n_true = None
    if layout.ragged:
        if mask is None:
            mask = torch.ones(m_obs.shape, device=device)
        n_true = torch.full((), float(c1 - c0), device=device)
    blocks = own(m_obs)
    mask = None if mask is None else own(mask)
    gen = prob.generator(generator)
    if warm is None:
        t0 = 0
        scale = 1.0 / math.sqrt(cfg.rank)
        u0 = torch.randn(m, cfg.rank, generator=gen) * scale
        v0 = torch.randn(n_i, cfg.rank,
                         generator=client_generator(generator,
                                                    comm.client)) * scale
    else:
        u0, v0 = validate.check_warm_shapes(
            warm, ("U", "V"), ((m, cfg.rank), (n, cfg.rank)),
            ("(m, rank)", "(n, rank)"))
        u0 = torch.as_tensor(u0).to(torch.float32)
        v0 = torch.as_tensor(v0).to(torch.float32)[c0:c1]
        if c1 - c0 < n_i:  # V's row tail padded like M's column tail
            v0 = torch.nn.functional.pad(v0, (0, 0, 0, n_i - (c1 - c0)))
        t0 = cfg.outer_iters
    sched = _resolve_participation(participation, cfg.outer_iters,
                                   num_clients, gen, device)
    problem = ShardProblem(
        blocks=blocks,
        u_init=u0[rows].to(device).contiguous(),
        v_init=v0.to(device).contiguous()[None],
        lam0=lam0, t0=torch.full((), t0, dtype=torch.int32, device=device),
        mask=mask, n_i=n_true, participation=sched,
        faults=flt.resolve_faults(faults, device))
    return problem, layout


def make_sharded_solver(cfg: fz.DCFConfig, layout: ShardLayout, *,
                        with_objective: bool = False) -> rt.Solver:
    """The per-rank solver of the sharded engine (the reference's
    ``solve_body``): each round this rank runs its client's K local
    iterations on its block (the same kernels, one client a launch), then
    the consensus over the data group (``fz.aggregate_sharded``; the wire,
    top-k with error feedback and / or one round stale, under
    ``cfg.consensus_compress`` / ``cfg.consensus_delay``).  With a model
    axis the Gram of U and every ``Psi^T U`` are summed over the row
    blocks (``reduce_m``).

    Every value that steers control flow comes out of a collective, so all
    ranks agree on it bit for bit: the objective and every guard scalar
    are summed over the whole mesh, the residual's norms over the model
    group (the consensus U itself is the same on the ranks of a row
    block), and ``wsum`` over the data group.  A round over gloo is not
    capturable (gloo runs its collectives on the host): ``capturable`` is
    the groups' backend being NCCL."""
    from repro_torch.distributed import grad_compress as gcomp
    from repro_torch.distributed import multihost as mh

    comm, n, ragged = layout.comm, layout.n, layout.ragged
    e, client = comm.clients, comm.client
    track = cfg.track_objective or with_objective
    compress, delay = cfg.consensus_compress, cfg.consensus_delay
    wire = compress is not None or bool(delay)
    robust = cfg.aggregator != "weighted_mean"
    screen = cfg.divergence_screen
    reduce_m = ((lambda x: comm.all_reduce(x, "model"))
                if comm.model_axis is not None else None)
    rm = reduce_m or (lambda x: x)

    def n_frac(p: ShardProblem):
        return p.n_i / n if ragged else 1.0 / e

    def one(p: ShardProblem) -> Tensor:
        return torch.ones((), device=p.lam0.device)

    def round_gates(p: ShardProblem, t: Tensor, u_i: Tensor, u_prev: Tensor):
        """This client's (payload, consensus weight, V-advance) for round
        ``t``: the schedule composed with the fault plan at the consensus
        boundary; the weights are ``None`` with neither."""
        pt = (None if p.participation is None
              else flt.round_codes(p.participation, t)[client])
        if p.faults is None:
            return u_i, pt, pt
        code = flt.round_codes(p.faults, t)[client]
        u_i = flt.corrupt_payload(code, u_i, u_prev)
        ptw = one(p) if pt is None else pt
        return u_i, ptw * flt.live_mask(code), ptw * flt.v_advance_mask(code)

    def local(p: ShardProblem, u: Tensor, v: Tensor, t: Tensor):
        lam_t = cfg.lam_at(p.lam0, t)
        u_i, v_new, diag_i = fz.local_round(
            u, v, p.blocks, cfg=cfg, lam=lam_t.expand(1).contiguous(),
            n_frac=n_frac(p), eta=cfg.lr(t), w=p.mask, reduce_m=reduce_m)
        return u_i[0], v_new, diag_i, lam_t

    def objective(p, u_new, v_new, diag_i, lam_t) -> Tensor:
        if not track:
            return torch.zeros((), device=u_new.device)
        if (diag_i is not None and p.participation is None
                and p.faults is None):
            # The fused epilogue's data term (summed over this block) plus
            # the regularizer share: summed over the mesh.
            val = diag_i[0][0] + fz.reg_terms(u_new, v_new, cfg.rho,
                                             n_frac(p))
        else:
            # Rounds where a client may drop out take the objective pass:
            # a dropped client's epilogue measured a discarded local run.
            val = fz.local_objective(u_new, v_new, p.blocks, cfg.rho, lam_t,
                                     n_frac(p), w=p.mask).sum()
        return comm.all_reduce(val, "all")

    def residual(u_new: Tensor, u_old: Tensor) -> Tensor:
        du2 = rm(((u_new - u_old) ** 2).sum())
        u2 = rm((u_old ** 2).sum())
        return torch.sqrt(du2) / (torch.sqrt(u2) + 1e-30)

    def gated(resid, obj, wsum, prev: rt.Diag):
        """An all-dropout round (``wsum`` 0, the same on every rank) is a
        no-op: the previous residual and an inf objective."""
        if wsum is None:
            return rt.Diag(obj, resid)
        resid = torch.where(wsum > 0, resid, prev.residual)
        if track:
            obj = torch.where(wsum > 0, obj,
                              torch.full((), float("inf"), device=obj.device))
        return rt.Diag(obj, resid)

    def plain_init(p: ShardProblem) -> _Carry:
        inf = torch.full((), float("inf"), device=p.lam0.device)
        return _Carry(u=p.u_init, v=p.v_init, diag=rt.Diag(inf, inf))

    def plain_step(p: ShardProblem, c: _Carry, t: Tensor) -> _Carry:
        t = t + p.t0
        u_i, v_new, diag_i, lam_t = local(p, c.u, c.v, t)
        u_i, pt, v_keep = round_gates(p, t, u_i, c.u)
        u_new, wsum = fz.aggregate_sharded(
            cfg, u_i, c.u, comm=comm, pt=one(p) if pt is None else pt,
            n_i=one(p) if p.n_i is None else p.n_i,
            uniform=pt is None and not ragged, reduce_m=reduce_m)
        if v_keep is not None:
            # Dropped or crashed this round: V_i freezes bit for bit.
            v_new = torch.where(v_keep > 0, v_new, c.v)
        obj = objective(p, u_new, v_new, diag_i, lam_t)
        return _Carry(u=u_new, v=v_new,
                      diag=gated(residual(u_new, c.u), obj, wsum, c.diag))

    def wire_init(p: ShardProblem) -> dict:
        c = plain_init(p)._asdict()
        if compress is not None:
            c["err"] = torch.zeros(p.u_init.shape, device=p.lam0.device)
        if delay:
            c["pending"] = torch.zeros(p.u_init.shape, device=p.lam0.device)
            c["sync"] = torch.zeros((), dtype=torch.bool,
                                    device=p.lam0.device)
            c["guard"] = c["diag"].objective
        return c

    def wire_step(p: ShardProblem, c: dict, t: Tensor) -> dict:
        # The consensus in delta form: each client's weighted delta crosses
        # the wire (top-k with error feedback when configured) and may be
        # applied one round late.
        tg = t + p.t0
        u_used = c["u"]
        u_i, v_new, diag_i, lam_t = local(p, u_used, c["v"], tg)
        u_i, pt, v_keep = round_gates(p, tg, u_i, u_used)
        n_i = one(p) if p.n_i is None else p.n_i
        wsum = None
        if robust:
            # One unweighted vote a client.
            wgt = 1.0
        elif pt is None and not ragged:
            wgt = 1.0 / e
        else:
            ptw = one(p) if pt is None else pt
            u_i = torch.where(ptw > 0, u_i, u_used)
            raw_w = ptw * n_i
            wsum = comm.all_reduce(raw_w)
            wgt = raw_w / torch.clamp_min(wsum, 1e-30)
        if v_keep is not None:
            v_new = torch.where(v_keep > 0, v_new, c["v"])
        contrib = (wgt * (u_i - u_used)).to(torch.float32)
        act = one(p) if pt is None else pt
        out = dict(c)
        if compress is None:
            if robust or screen is not None:
                u_cand, wsum = fz.aggregate_sharded(
                    cfg, u_i, u_used, comm=comm, pt=act, n_i=n_i,
                    uniform=False, reduce_m=reduce_m)
                delta = (u_cand - u_used).to(torch.float32)
            else:
                delta = comm.all_reduce(contrib)
        else:
            # One all-gather of the compact payloads over the data group;
            # each row block compresses its own rows.
            k = mh.topk_k(u_used.numel(), compress.topk_frac)
            if robust:
                delta, err_new, cnt = gcomp.compressed_consensus_robust(
                    contrib, comm, k, c["err"], act, cfg.aggregator,
                    cfg.trim_frac, screen=screen, reduce_m=reduce_m)
                wsum = cnt.to(torch.float32)
                # A poisoned payload must not poison its residual for good.
                err_new = torch.where(torch.isfinite(err_new), err_new, 0.0)
            else:
                delta, err_new = gcomp.compressed_consensus_sum(
                    contrib, comm, k, c["err"], active=pt)
            out["err"] = err_new
        if delay == 0:
            u_new = u_used + delta
        else:
            # The staleness guard: the fused epilogue's ||Psi||_F^2 summed
            # over the mesh, or (fault rounds, fused="off") the applied
            # delta's energy; the same on every rank.
            if diag_i is not None and p.faults is None:
                scalar = comm.all_reduce(diag_i[1][0], "all")
            else:
                scalar = rm((delta * delta).sum())
            trip = ~torch.isfinite(scalar) | (
                torch.isfinite(c["guard"])
                & (scalar > cfg.stale_guard * c["guard"]))
            sync = c["sync"] | trip
            u_new = u_used + c["pending"] + torch.where(sync, delta, 0.0)
            out["pending"] = torch.where(sync, 0.0, delta)
            out["sync"] = sync
            out["guard"] = scalar
        obj = objective(p, u_new, v_new, diag_i, lam_t)
        resid = residual(u_new, u_used)
        if delay:
            # Round 0 applies nothing (its delta waits).
            resid = torch.where(t > 0, resid, c["diag"].residual)
        out["u"], out["v"] = u_new, v_new
        out["diag"] = gated(resid, obj, wsum, c["diag"])
        return out

    def finalize(p: ShardProblem, c):
        # The last round's stale delta is still in flight: apply it.
        if wire:
            u = c["u"] + c["pending"] if delay else c["u"]
            v = c["v"]
        else:
            u, v = c.u, c.v
        lam = cfg.final_lam(p.lam0).expand(1).contiguous()
        l_blk, s_blk = fz.finalize(u, v, p.blocks, lam, cfg.impl, w=p.mask)
        return l_blk[0], s_blk[0], u, v[0]

    if wire:
        return rt.Solver(wire_init, wire_step, lambda p, c: c["diag"],
                         finalize, capturable=comm.capturable)
    return rt.Solver(plain_init, plain_step, lambda p, c: c.diag, finalize,
                     capturable=comm.capturable)


def _assemble(layout: ShardLayout, l_blk: Tensor, s_blk: Tensor,
              u: Tensor, v: Tensor) -> tuple[Tensor, Tensor, Tensor, Tensor]:
    """The whole ``(L (m, n), S (m, n), U (m, r), V (n, r))`` on every rank
    from the ranks' blocks: all-gathers in client order, the padding
    trimmed (the reference's ``process_allgather(tiled=True)`` view)."""
    comm = layout.comm
    e, mb = comm.clients, comm.model_size

    def plane(blk: Tensor) -> Tensor:
        g = comm.all_gather(blk, "all")  # (E * mb, m_loc, n_i), client-major
        g = g.view(e, mb, layout.m_loc, layout.n_i).permute(1, 2, 0, 3)
        return g.reshape(layout.m, e * layout.n_i)[:, :layout.n]

    u_full = u if mb == 1 else comm.all_gather(u, "model").reshape(
        layout.m, -1)
    v_full = comm.all_gather(v, "data").reshape(e * layout.n_i, -1)
    return plane(l_blk), plane(s_blk), u_full, v_full[:layout.n]


def _sharded_ckpt_template(cfg: fz.DCFConfig, device) -> dict:
    """The tree of a sharded segment snapshot (the reference's layout:
    every leaf replicated, V and the wire residual client-major); the
    leaves' shapes come from the manifest."""
    z = torch.zeros((), device=device)
    carry = {"u": z, "v": z, "dobj": z, "dres": z}
    if cfg.consensus_compress is not None:
        carry["err"] = z
    if cfg.consensus_delay:
        carry.update(pending=z, sync=z, guard=z)
    return {"carry": carry, "objective": z, "residual": z}


def _carry_to_host(layout: ShardLayout, carry) -> dict:
    """A mid-solve carry as the snapshot holds it: U (and ``pending``,
    ``sync``, ``guard``) replicated, V and ``err`` gathered client-major."""
    comm = layout.comm
    c = carry if isinstance(carry, dict) else carry._asdict()
    out = {k: c[k] for k in ("u", "pending", "sync", "guard") if k in c}
    out["v"] = comm.all_gather(c["v"][0], "data").reshape(-1, c["v"].shape[-1])
    if "err" in c:
        out["err"] = comm.all_gather(c["err"], "data").reshape(
            -1, c["err"].shape[-1])
    out["dobj"], out["dres"] = c["diag"].objective, c["diag"].residual
    return out


def _carry_from_host(layout: ShardLayout, restored: dict, wire: bool):
    """This rank's carry from a restored snapshot."""
    comm = layout.comm
    ni = layout.n_i
    c = {"u": restored["u"].contiguous(),
         "v": restored["v"][comm.client * ni:(comm.client + 1) * ni]
         .contiguous()[None],
         "diag": rt.Diag(restored["dobj"], restored["dres"])}
    if not wire:
        return _Carry(**c)
    if "err" in restored:
        m = layout.m
        c["err"] = restored["err"][comm.client * m:(comm.client + 1) * m] \
            .contiguous()
    if "pending" in restored:
        c["pending"] = restored["pending"].contiguous()
        c["sync"] = restored["sync"].to(torch.bool)
        c["guard"] = restored["guard"]
    return c


def solve_sharded_problem(problem: ShardProblem, layout: ShardLayout,
                          cfg: fz.DCFConfig,
                          run: rt.RunConfig | str | None = None, *,
                          checkpoint_dir: str | None = None,
                          resume_from: str | None = None) -> DCFResult:
    """Run this rank's solver (every rank of the mesh calls it in
    lock-step) and assemble the whole result on every rank.

    ``checkpoint_dir`` / ``resume_from`` split the fixed scan into
    segments of ``run.checkpoint_every`` rounds (scan mode only; not with
    a model axis): after each but the last, every rank holds the whole
    carry (V and the wire residual gathered client-major) and rank 0 of
    the mesh writes it with the traces so far, pinned to the mesh's shape;
    ``resume_from`` restores the latest snapshot (refusing one written on
    another mesh shape) and finishes the solve bit for bit as the
    uninterrupted one."""
    run = rt.resolve_run(run)
    solver = make_sharded_solver(cfg, layout,
                                 with_objective=run.needs_objective)
    if checkpoint_dir is None and resume_from is None:
        carry, stats = rt.run(solver, problem, cfg.outer_iters, run)
    else:
        carry, stats = _solve_sharded_checkpointed(
            solver, problem, layout, cfg, run, checkpoint_dir, resume_from)
    l, s, u, v = _assemble(layout, *solver.finalize(problem, carry))
    return DCFResult(l=l, s=s, u=u, v=v, stats=stats)


def _solve_sharded_checkpointed(solver, problem, layout, cfg, run_cfg,
                                checkpoint_dir, resume_from):
    """The segmented scan of :func:`solve_sharded_problem`: ``(carry,
    stats)`` after the last segment."""
    import torch.distributed as dist

    from repro_torch.training import checkpoint as ckpt

    if run_cfg.mode != "scan":
        raise ValueError(
            f"checkpointed solves require run mode 'scan' (the fixed "
            f"paper schedule); got mode {run_cfg.mode!r}")
    comm = layout.comm
    wire = cfg.consensus_compress is not None or bool(cfg.consensus_delay)
    total = cfg.outer_iters
    device = rt.device_of(problem)
    state = rt.single_state(solver, problem, total)
    t_done = 0
    if resume_from is not None:
        step = ckpt.latest_step(resume_from)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {resume_from}")
        restored, t_done = ckpt.restore(
            resume_from, _sharded_ckpt_template(cfg, device), step=step,
            expect_mesh=comm.shape)
        if t_done > total:
            raise ValueError(
                f"checkpoint at round {t_done} exceeds this solve's budget "
                f"of {total} rounds")
        state["carry"] = _carry_from_host(layout, restored["carry"], wire)
        state["obj"][:t_done] = restored["objective"]
        state["res"][:t_done] = restored["residual"]
        state["t"].fill_(t_done)
    if comm.model_axis is not None:
        raise ValueError(_SHARDED_SEGMENT_MODEL)
    plan = rt.segment_plan(total - t_done, run_cfg.checkpoint_every)
    if not plan:
        raise ValueError(
            f"checkpoint already covers all {total} rounds; nothing to "
            f"resume (finalize needs at least one remaining segment)")
    rounds = rt.Rounds(rt.single_body(solver, problem), state, device,
                       rt.use_graph(solver, device, False, total - t_done))
    s = rounds.state
    for seg in plan:
        rounds.advance(seg)
        t_done += seg
        if checkpoint_dir is not None and t_done < total:
            host = _carry_to_host(layout, s["carry"])
            if dist.get_rank() == int(torch.as_tensor(comm.mesh.mesh)
                                      .reshape(-1)[0]):
                ckpt.save(checkpoint_dir, t_done,
                          {"carry": host, "objective": s["obj"][:t_done],
                           "residual": s["res"][:t_done]},
                          mesh_shape=comm.shape)
    stats = rt.SolveStats(
        objective=s["obj"], residual=s["res"],
        rounds=torch.full((), total, dtype=torch.int32, device=device),
        converged=rt.scan_converged(run_cfg, s["obj"], s["res"]))
    return s["carry"], stats


def _solve_sharded(m_obs, cfg: fz.DCFConfig, mesh, *,
                   data_axes=("data",), model_axis=None, key=None, run=None,
                   warm=None, mask=None, participation=None, faults=None,
                   checkpoint_dir=None, resume_from=None,
                   device=None) -> DCFResult:
    """The sharded solve of this rank (see :func:`make_sharded_problem`
    and :func:`solve_sharded_problem`)."""
    from repro_torch.distributed import multihost as mh

    _refuse_sharded(cfg, participation, mask)  # before any group is made
    comm = mh.MeshComm(mesh, data_axes, model_axis)
    problem, layout = make_sharded_problem(
        m_obs, cfg, comm, key, warm, mask=mask, participation=participation,
        faults=faults, device=device)
    return solve_sharded_problem(problem, layout, cfg, run,
                                 checkpoint_dir=checkpoint_dir,
                                 resume_from=resume_from)


def dcf_pca_sharded(
    m_obs,
    cfg: fz.DCFConfig,
    mesh,
    *,
    data_axes: tuple[str, ...] = ("data",),
    model_axis: str | None = None,
    generator: int | torch.Generator | None = None,
    run: rt.RunConfig | str | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    mask=None,
    participation=None,
    faults=None,
    checkpoint_dir: str | None = None,
    resume_from: str | None = None,
    device: torch.device | str | None = None,
) -> DCFResult:
    """DCF-PCA over ``mesh`` (a ``torch.distributed`` ``DeviceMesh``; every
    rank calls it with the whole ``m_obs``): each rank along ``data_axes``
    is one client, rows split over ``model_axis``.  Every rank returns the
    whole ``l``, ``s`` (m, n), ``u`` (m, r) and ``v`` (n, r), and the same
    stats.  A shim over ``repro_torch.rpca.solve(...,
    method="dcf_sharded")``."""
    res = _rpca.solve(
        _rpca.RPCASpec(m_obs, mask=mask, warm=warm, key=generator, mesh=mesh,
                       data_axes=data_axes, model_axis=model_axis,
                       participation=participation, faults=faults,
                       checkpoint_dir=checkpoint_dir,
                       resume_from=resume_from),
        method="dcf_sharded", run=run, cfg=cfg, device=device)
    return DCFResult(l=res.l, s=res.s, u=res.u, v=res.v, stats=res.stats)


# ---------------------------------------------------------------------------
# Registry adapters (repro_torch.rpca front door)
# ---------------------------------------------------------------------------
#: The reference's refusals of what a batch does not take.
_BATCH_FAULTS = ("fault injection does not compose with batched solves: "
                 "pass one problem per FaultPlan")
_BATCH_CHECKPOINT = ("mid-solve checkpointing does not compose with batched "
                     "solves: checkpoint each problem separately")
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


def _record_traffic(cfg: fz.DCFConfig, m: int, num_clients: int,
                    stats: rt.SolveStats) -> None:
    """Feed the process-wide consensus traffic counters
    (``distributed.multihost.consensus_traffic``) with this solve's
    modelled wire bytes (a batch's rounds summed over its problems)."""
    from repro_torch.distributed import multihost as mh

    mh.record_consensus(m, cfg.rank, num_clients, int(stats.rounds.sum()),
                        cfg.consensus_compress)


def _registry_make(spec, cfg, run_cfg, device):
    cfg = cfg if cfg is not None else _default_cfg(spec, "dcf")
    _rpca.require_cfg_type("dcf", cfg, fz.DCFConfig)
    num_clients = _resolve_num_clients(spec)
    validate.check_fault_plan(cfg, spec.faults, num_clients)
    if spec.batched:
        if spec.faults is not None:
            raise ValueError(_BATCH_FAULTS)
        if spec.checkpoint_dir is not None or spec.resume_from is not None:
            raise ValueError(_BATCH_CHECKPOINT)
        validate.check_consensus_cfg(cfg, spec.participation)
        problem = make_batch(spec.m_obs, cfg, num_clients,
                             _rpca.default_key(spec), spec.warm,
                             mask=spec.mask,
                             participation=spec.participation, device=device)
        res = solve_problem(problem, cfg, run_cfg, n=spec.m_obs.shape[-1])
    else:
        res = dcf_pca(spec.m_obs, cfg, num_clients, _rpca.default_key(spec),
                      run=run_cfg, warm=spec.warm, mask=spec.mask,
                      participation=spec.participation, faults=spec.faults,
                      checkpoint_dir=spec.checkpoint_dir,
                      resume_from=spec.resume_from, device=device)
    _record_traffic(cfg, spec.m_obs.shape[-2], num_clients, res.stats)
    return res.l, res.s, res.u, res.v, res.stats


def _registry_make_sharded(spec, cfg, run_cfg, device):
    cfg = cfg if cfg is not None else _default_cfg(spec, "dcf_sharded")
    _rpca.require_cfg_type("dcf_sharded", cfg, fz.DCFConfig)
    res = _solve_sharded(
        spec.m_obs, cfg, spec.mesh, data_axes=tuple(spec.data_axes),
        model_axis=spec.model_axis, key=_rpca.default_key(spec),
        run=run_cfg, warm=spec.warm, mask=spec.mask,
        participation=spec.participation, faults=spec.faults,
        checkpoint_dir=spec.checkpoint_dir, resume_from=spec.resume_from,
        device=device)
    num_clients = 1
    names = tuple(spec.mesh.mesh_dim_names)
    shape = torch.as_tensor(spec.mesh.mesh).shape
    for a in spec.data_axes:
        num_clients *= int(shape[names.index(a)])
    _record_traffic(cfg, spec.m_obs.shape[0], num_clients, res.stats)
    return res.l, res.s, res.u, res.v, res.stats


_rpca.register_solver(
    "dcf",
    _rpca.SolverCaps(supports_mask=True, supports_factors=True,
                     supports_clients=True, supports_participation=True,
                     batchable=True, needs_rank=True, supports_lowp=True,
                     supports_robust_agg=True, supports_checkpoint=True),
    _registry_make,
)

_rpca.register_solver(
    "dcf_sharded",
    _rpca.SolverCaps(supports_mask=True, supports_factors=True,
                     supports_participation=True, supports_sharding=True,
                     batchable=False, needs_rank=True, supports_lowp=True,
                     supports_multiprocess=True, supports_robust_agg=True,
                     supports_checkpoint=True),
    _registry_make_sharded,
)
