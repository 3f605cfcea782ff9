"""Solver runtime: one driver for every solver (counterpart of
``repro.core.runtime``).

A :class:`Solver` is four plain functions over a ``problem`` (a named tuple
of tensors)::

    init(problem)               -> carry
    step(problem, carry, t)     -> carry    (t: 0-d int32 device tensor)
    diagnostics(problem, carry) -> Diag
    finalize(problem, carry)    -> solver output

and :func:`run` drives it in one of three modes (:class:`RunConfig.mode`):

``scan``   a fixed Python loop over ``max_iters`` rounds with no host sync:
           the round index, the diagnostics and the stats stay on the
           device until the caller reads them.
``while``  stop once the criterion holds; the host reads the predicate once
           a round (one device sync per round).
``chunk``  rounds in chunks of ``chunk_size``; the predicate is read once a
           chunk, so a chunk's launches queue without a sync.

:func:`solve_batch` drives B problems at once: the problem's leaves carry
a leading problem axis and the solver's functions take it natively (one
kernel launch a sweep for the whole batch).  Finished problems freeze
(:func:`tree_where`) while the others go on.

The diagnostics contract is the reference's: ``residual`` is a relative
quantity and ``objective`` an inf for rounds where nothing was measured.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Literal, NamedTuple

import torch

Tensor = torch.Tensor


class Diag(NamedTuple):
    """Per-iteration diagnostics: tracked objective and relative residual."""

    objective: Tensor
    residual: Tensor


class SolveStats(NamedTuple):
    """``objective``/``residual`` are (max_iters,) traces, zero past
    ``rounds`` in the early-exit modes; ``rounds`` is 0-d int32 and
    ``converged`` 0-d bool."""

    objective: Tensor
    residual: Tensor
    rounds: Tensor
    converged: Tensor


class Solver(NamedTuple):
    init: Callable[[Any], Any]
    step: Callable[[Any, Any, Tensor], Any]
    diagnostics: Callable[[Any, Any], Diag]
    finalize: Callable[[Any, Any], Any]


@dataclass(frozen=True)
class RunConfig:
    """Execution mode: ``tol`` applies to ``criterion`` (``rel_residual``
    stops when the residual is <= tol; ``obj_plateau`` when the objective
    changes by <= tol * max(1, |obj|)); ``min_iters`` suppresses exits
    before the diagnostics settle."""

    mode: Literal["scan", "while", "chunk"] = "scan"
    tol: float = 1e-6
    criterion: Literal["rel_residual", "obj_plateau"] = "rel_residual"
    chunk_size: int = 8
    min_iters: int = 2
    #: Rounds between the mid-solve snapshots of :func:`run_segmented`
    #: (0: one segment, no snapshot before the end); scan mode only.
    checkpoint_every: int = 0

    @property
    def needs_objective(self) -> bool:
        return self.criterion == "obj_plateau"


#: Fixed schedule, no early exit.
FIXED = RunConfig(mode="scan")
#: Convergence-controlled early exit.
EARLY = RunConfig(mode="while")
#: Chunked loop, convergence read once per chunk.
CHUNKED = RunConfig(mode="chunk")

RUN_PRESETS: dict[str, RunConfig] = {
    "fixed": FIXED,
    "early": EARLY,
    "chunk": CHUNKED,
}


def resolve_run(run: "RunConfig | str | None") -> RunConfig:
    """``None`` -> :data:`FIXED`, a string names a preset, a
    :class:`RunConfig` passes through."""
    if run is None:
        return FIXED
    if isinstance(run, str):
        try:
            return RUN_PRESETS[run]
        except KeyError:
            raise ValueError(
                f"unknown run preset {run!r}; expected one of "
                f"{sorted(RUN_PRESETS)} or a RunConfig"
            ) from None
    if isinstance(run, RunConfig):
        return run
    raise ValueError(
        f"run must be a RunConfig, a preset name, or None; got "
        f"{type(run).__name__}"
    )


def _bcast(pred: Tensor, leaf: Tensor) -> Tensor:
    """A ()- or (B,)-shaped predicate shaped to broadcast against a leaf."""
    return pred.reshape(pred.shape + (1,) * (leaf.ndim - pred.ndim))


def tree_where(pred: Tensor, new: Any, old: Any) -> Any:
    """``torch.where(pred, new, old)`` leaf by leaf over matching trees
    (named tuples, tuples, lists, dicts, ``None``); ``pred`` is a scalar or
    a leading-axis mask (the batch's freeze mask)."""
    if new is None:
        return None
    if isinstance(new, dict):
        return {k: tree_where(pred, new[k], old[k]) for k in new}
    if isinstance(new, tuple) and hasattr(new, "_fields"):
        return type(new)(*(tree_where(pred, a, b) for a, b in zip(new, old)))
    if isinstance(new, (tuple, list)):
        return type(new)(tree_where(pred, a, b) for a, b in zip(new, old))
    return torch.where(_bcast(pred, new), new, old)


def _converged(run: RunConfig, diag: Diag, prev_obj: Tensor) -> Tensor:
    if run.criterion == "rel_residual":
        return diag.residual <= run.tol
    # A plateau needs two finite measurements (inf marks "not measured").
    delta_ok = (prev_obj - diag.objective).abs() <= run.tol * torch.clamp_min(
        prev_obj.abs(), 1.0)
    return delta_ok & torch.isfinite(prev_obj) & torch.isfinite(diag.objective)


def scan_converged(run_cfg: RunConfig, obuf: Tensor, rbuf: Tensor) -> Tensor:
    """The fixed scan's convergence verdict from whole diagnostics traces
    (:func:`run`'s in scan mode), so an interrupted and resumed
    :func:`run_segmented` solve reports the same flag."""
    inf = torch.full((), float("inf"), device=obuf.device)
    prev_obj = obuf[..., -2] if obuf.shape[-1] > 1 else inf
    return _converged(run_cfg, Diag(obuf[..., -1], rbuf[..., -1]), prev_obj)


def segment_plan(max_iters: int, checkpoint_every: int) -> list[int]:
    """``max_iters`` rounds as checkpoint segments: one segment when
    ``checkpoint_every <= 0`` (or covers them all), else equal segments of
    that length and a ragged tail."""
    if checkpoint_every <= 0 or checkpoint_every >= max_iters:
        return [max_iters] if max_iters > 0 else []
    full, tail = divmod(max_iters, checkpoint_every)
    return [checkpoint_every] * full + ([tail] if tail else [])


def run_segmented(solver: Solver, problem: Any, max_iters: int,
                  run_cfg: RunConfig = FIXED, *,
                  checkpoint_dir: str | None = None,
                  resume_from: str | None = None,
                  save_extra: Callable[[int, Any], None] | None = None
                  ) -> tuple[Any, SolveStats]:
    """:func:`run` in scan mode, split into segments of
    ``run_cfg.checkpoint_every`` rounds over the global round indices: the
    same steps, so the same bits as one scan, boundaries included.

    After every segment but the last, the whole carry and the diagnostics
    traces so far are saved (``training.checkpoint``) under
    ``checkpoint_dir``; ``resume_from`` restores the latest snapshot there
    and finishes the remaining rounds, giving the uninterrupted solve's
    bits.  ``save_extra(t, carry)`` runs after each save."""
    if run_cfg.mode != "scan":
        raise ValueError(
            f"checkpointed solves require run mode 'scan' (the fixed "
            f"paper schedule); got mode {run_cfg.mode!r}"
        )
    from repro_torch.training import checkpoint as ckpt

    device = _device(problem)
    t_done = 0
    obuf = torch.zeros(0, device=device)
    rbuf = torch.zeros(0, device=device)
    carry = solver.init(problem)
    if resume_from is not None:
        template = {"carry": carry, "objective": obuf, "residual": rbuf}
        restored, t_done = ckpt.restore(resume_from, template)
        carry = restored["carry"]
        obuf, rbuf = restored["objective"], restored["residual"]
        if t_done > max_iters:
            raise ValueError(
                f"checkpoint at round {t_done} exceeds this solve's "
                f"budget of {max_iters} rounds"
            )
    for seg in segment_plan(max_iters - t_done, run_cfg.checkpoint_every):
        ts = torch.arange(t_done, t_done + seg, dtype=torch.int32,
                          device=device)
        objs, resids = [], []
        for g in range(seg):
            carry = solver.step(problem, carry, ts[g])
            d = solver.diagnostics(problem, carry)
            objs.append(d.objective.to(torch.float32))
            resids.append(d.residual.to(torch.float32))
        t_done += seg
        obuf = torch.cat([obuf, torch.stack(objs)])
        rbuf = torch.cat([rbuf, torch.stack(resids)])
        if checkpoint_dir is not None and t_done < max_iters:
            ckpt.save(checkpoint_dir, t_done,
                      {"carry": carry, "objective": obuf, "residual": rbuf})
            if save_extra is not None:
                save_extra(t_done, carry)
    stats = SolveStats(
        objective=obuf, residual=rbuf,
        rounds=torch.full((), max_iters, dtype=torch.int32, device=device),
        converged=scan_converged(run_cfg, obuf, rbuf),
    )
    return carry, stats


def _device(problem: Any) -> torch.device:
    return next(x.device for x in problem if isinstance(x, Tensor))


def driver(solver: Solver, max_iters: int, run_cfg: RunConfig = FIXED
           ) -> Callable[[Any], tuple[Any, SolveStats]]:
    """``(solver, budget, run mode)`` closed into ``drive(problem) ->
    (final_carry, stats)``, the same as ``run(solver, problem, max_iters,
    run_cfg)`` (the reference's unit of its compile cache)."""

    def drive(problem: Any) -> tuple[Any, SolveStats]:
        return run(solver, problem, max_iters, run_cfg)

    return drive


def run(solver: Solver, problem: Any, max_iters: int,
        run_cfg: RunConfig = FIXED) -> tuple[Any, SolveStats]:
    """Drive ``solver`` on one problem; returns ``(final_carry, stats)``."""
    if run_cfg.mode not in ("scan", "while", "chunk"):
        raise ValueError(f"unknown mode {run_cfg.mode!r}")
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    device = _device(problem)
    ts = torch.arange(max_iters, dtype=torch.int32, device=device)
    inf = torch.full((), float("inf"), device=device)
    carry = solver.init(problem)
    objs: list[Tensor] = []
    resids: list[Tensor] = []
    last, prev_obj = Diag(inf, inf), inf
    chunk = {"scan": max_iters, "while": 1,
             "chunk": max(1, run_cfg.chunk_size)}[run_cfg.mode]
    t = 0
    while t < max_iters:
        if run_cfg.mode != "scan" and t >= run_cfg.min_iters and bool(
                _converged(run_cfg, last, prev_obj)):
            break
        for g in range(t, min(t + chunk, max_iters)):
            carry = solver.step(problem, carry, ts[g])
            d = solver.diagnostics(problem, carry)
            objs.append(d.objective.to(torch.float32))
            resids.append(d.residual.to(torch.float32))
        if run_cfg.mode == "chunk":  # compared chunk end to chunk end
            prev_obj, last = last.objective, d
        else:
            prev_obj, last = (objs[-2] if len(objs) > 1 else inf), d
        t = g + 1
    pad = torch.zeros(max_iters - t, device=device)
    stats = SolveStats(
        objective=torch.cat([torch.stack(objs), pad]),
        residual=torch.cat([torch.stack(resids), pad]),
        rounds=torch.full((), t, dtype=torch.int32, device=device),
        converged=_converged(run_cfg, last, prev_obj),
    )
    return carry, stats


def stack_problems(problems: list) -> Any:
    """Problems of one shape (named tuples) stacked on a leading problem
    axis, field by field (``None`` fields stay ``None``): the batch that
    :func:`solve_batch` takes."""
    first = problems[0]
    return type(first)(*(
        None if x is None else torch.stack([getattr(q, f) for q in problems])
        for f, x in zip(first._fields, first)))


def solve_batch(solver: Solver, problems: Any, max_iters: int,
                run_cfg: RunConfig = FIXED) -> tuple[Any, Any, SolveStats]:
    """Solve a batch of problems in lock-step (the reference's
    ``solve_batch``); returns ``(solver.finalize output, final_carry,
    stats)``, every stats field with a leading batch axis.

    ``problems`` is the solver's problem with a leading problem axis on
    every leaf, and the solver's functions take that axis natively, so a
    round is one set of launches for the whole batch.  In ``while`` and
    ``chunk`` mode each problem that meets the criterion freezes: its
    carry, diagnostics and ``rounds`` stop, its traces are zero past its
    exit, and the loop ends once all are done.  The done mask is updated
    every round on the device; the host reads ``all(done)`` once a round
    (``while``) or once a chunk of ``chunk_size`` rounds (``chunk``), which
    gives the same results since a frozen problem does not change.
    ``scan`` runs the whole budget (nothing freezes) and computes
    ``converged`` from the last two trace entries, as :func:`run`."""
    if run_cfg.mode not in ("scan", "while", "chunk"):
        raise ValueError(f"unknown mode {run_cfg.mode!r}")
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")
    leaf = next((x for x in problems if isinstance(x, Tensor)), None)
    if leaf is None:
        raise ValueError("solve_batch needs a non-empty problem")
    batch, device = leaf.shape[0], leaf.device
    check = run_cfg.mode != "scan"
    ts = torch.arange(max_iters, dtype=torch.int32, device=device)
    carry = solver.init(problems)
    inf = torch.full((batch,), float("inf"), device=device)
    done = torch.zeros(batch, dtype=torch.bool, device=device)
    rounds = torch.zeros(batch, dtype=torch.int32, device=device)
    last, prev_obj = Diag(inf, inf), inf
    obuf = torch.zeros(batch, max_iters, device=device)
    rbuf = torch.zeros(batch, max_iters, device=device)
    period = {"scan": max_iters, "while": 1,
              "chunk": max(1, run_cfg.chunk_size)}[run_cfg.mode]
    t = 0
    while t < max_iters:
        for g in range(t, min(t + period, max_iters)):
            new = solver.step(problems, carry, ts[g])
            # Nothing freezes in scan mode: skip the copy of every leaf.
            carry = tree_where(~done, new, carry) if check else new
            d = solver.diagnostics(problems, carry)
            d = Diag(torch.where(done, last.objective,
                                 d.objective.to(torch.float32)),
                     torch.where(done, last.residual,
                                 d.residual.to(torch.float32)))
            active = ~done
            obuf[:, g] = torch.where(active, d.objective, 0.0)
            rbuf[:, g] = torch.where(active, d.residual, 0.0)
            rounds = rounds + active.to(torch.int32)
            if check:
                hit = _converged(run_cfg, d, prev_obj) & (
                    rounds >= run_cfg.min_iters)
                done = done | (active & hit)
            prev_obj = torch.where(active, d.objective, prev_obj)
            last = d
        t = g + 1
        if check and bool(done.all()):
            break
    if not check:
        done = scan_converged(run_cfg, obuf, rbuf)
    stats = SolveStats(objective=obuf, residual=rbuf, rounds=rounds,
                       converged=done)
    return solver.finalize(problems, carry), carry, stats
