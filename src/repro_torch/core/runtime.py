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


def _converged(run: RunConfig, diag: Diag, prev_obj: Tensor) -> Tensor:
    if run.criterion == "rel_residual":
        return diag.residual <= run.tol
    # A plateau needs two finite measurements (inf marks "not measured").
    delta_ok = (prev_obj - diag.objective).abs() <= run.tol * torch.clamp_min(
        prev_obj.abs(), 1.0)
    return delta_ok & torch.isfinite(prev_obj) & torch.isfinite(diag.objective)


def _device(problem: Any) -> torch.device:
    return next(x.device for x in problem if isinstance(x, Tensor))


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
