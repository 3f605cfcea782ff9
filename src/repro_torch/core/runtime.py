"""Solver runtime: one driver for every solver (counterpart of
``repro.core.runtime``).

A :class:`Solver` is four plain functions over a ``problem`` (a named tuple
of tensors)::

    init(problem)               -> carry
    step(problem, carry, t)     -> carry    (t: 0-d int32 device tensor)
    diagnostics(problem, carry) -> Diag
    finalize(problem, carry)    -> solver output

and :func:`run` drives it in one of three modes (:class:`RunConfig.mode`):

``scan``   a fixed loop over ``max_iters`` rounds with no host sync: the
           round index, the diagnostics and the stats stay on the device
           until the caller reads them.
``while``  stop once the criterion holds; the host reads the predicate once
           a round (one device sync per round).
``chunk``  rounds in chunks of ``chunk_size``; the predicate is read once a
           chunk, so a chunk's rounds queue without a sync.

:func:`solve_batch` drives B problems at once: the problem's leaves carry
a leading problem axis and the solver's functions take it natively (one
kernel launch a sweep for the whole batch).  Finished problems freeze
(:func:`tree_where`) while the others go on.  :func:`slot_body` is the
round of a service's slot table (``serving.rpca_service``): each slot at
its own schedule position, with its own done, converged and quarantine
flags, all on the device.

On a CUDA device a solver whose ``capturable`` flag is set runs its rounds
as one CUDA graph, the counterpart of the reference's compiled ``lax.scan``
/ ``while_loop``.  The flag is a static property of the solver: the
factorized solvers set it; the convex ones cannot (their SVD reads
cuSOLVER's status on the host every iteration) and run eagerly.  The first
round runs eagerly, as the warm-up (library handles, workspaces, kernel
attributes); the round is then captured once over static buffers: the
carry, the round index as a 0-d device tensor that the graph reads and
advances, and the diagnostics traces, written at that index on the device.
The new carry is copied into the static one at the round's end.  Every
later round is one replay: ``scan`` replays ``max_iters - 1`` times and
reads nothing back, ``while`` reads the predicate once a round and
``chunk`` once a chunk, as eagerly.  A capture that fails raises; nothing
falls back to eager rounds.  A budget under :data:`MIN_GRAPH_ROUNDS`
rounds runs eagerly (a capture would not pay).  The host-side counters
(:mod:`repro_torch.counters`: kernel launches, collective calls and bytes)
move only when a wrapper runs, so a replay adds the captured round's
counts to them.  ``eager=True`` runs every round eagerly on the card (the
tests and ``chip_smoke.py`` hold the replay against it; the front door
has no such option).

The diagnostics contract is the reference's: ``residual`` is a relative
quantity and ``objective`` an inf for rounds where nothing was measured.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Literal, NamedTuple

import torch

from repro_torch import counters, debug
from repro_torch.core import graph_nodes
from repro_torch.kernels import ops

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
    #: Whether a round (``step`` and ``diagnostics``) can be captured in a
    #: CUDA graph: no host read, no host-to-device copy and no CPU
    #: generator draw inside it.
    capturable: bool = False
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


# ---------------------------------------------------------------------------
# Rounds over static buffers, eagerly or as one captured CUDA graph
# ---------------------------------------------------------------------------
#: Round graphs captured and replayed in this process, the seconds spent
#: capturing and instantiating them and reading their kernel nodes, and the
#: ``cudaMalloc`` calls made while capturing (the port's own counters: a
#: repeat bucket of the compile cache captures nothing).
graph_counts: dict[str, float] = {
    "captures": 0, "replays": 0, "capture_s": 0.0, "instantiate_s": 0.0,
    "nodes_s": 0.0, "capture_mallocs": 0}


#: What the replays since :func:`reset_graph_counts` launched of the port's
#: RPCA kernels, by family: ``"nodes"``, the graphs' kernel nodes (what the
#: device ran), and ``"counted"``, what the same replays added to the launch
#: counters.  A launch window holds ``counters == nodes + eager``, with the
#: eager launches the counters less ``"counted"``.
replayed_kernels: dict[str, dict[str, int]] = {"nodes": {}, "counted": {}}


def reset_graph_counts() -> None:
    for name in graph_counts:
        graph_counts[name] = 0.0 if name.endswith("_s") else 0
    for tally in replayed_kernels.values():
        tally.clear()


def leaves(tree: Any) -> list:
    """The leaves of a tree of named tuples, tuples, lists and dicts (by
    sorted keys), ``None`` as no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in leaves(item)]
    return [tree]


def tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` of every leaf, in a tree of the same structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    return fn(tree)


def copy_into(dst: Any, src: Any) -> None:
    """Copy every leaf of ``src`` into the matching leaf of ``dst`` (same
    structure, shapes and types).  A source leaf that is its own
    destination is skipped; one that shares storage with another
    destination (a carry field passed on to another field, as APGM's
    ``l_prev = l``) is cloned before anything is written."""
    pairs = list(zip(leaves(dst), leaves(src), strict=True))
    owned = {d.untyped_storage().data_ptr() for d, _ in pairs}
    moves = []
    for d, s in pairs:
        if s is d:
            continue
        if s.shape != d.shape or s.dtype != d.dtype:
            raise ValueError(
                f"a round changed a carry leaf from {tuple(d.shape)} "
                f"{d.dtype} to {tuple(s.shape)} {s.dtype}")
        if s.untyped_storage().data_ptr() in owned:
            s = s.clone()
        moves.append((d, s))
    for d, s in moves:
        d.copy_(s)


_CAPTURE_STREAMS: dict[int, torch.cuda.Stream] = {}
_POOL_ANCHORS: dict[int, tuple] = {}


def _device_index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _capture_stream(device: torch.device) -> torch.cuda.Stream:
    index = _device_index(device)
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(device=index)
    return _CAPTURE_STREAMS[index]


def _graph_pool(device: torch.device, side: torch.cuda.Stream) -> tuple:
    """The memory pool that every round graph of the device captures into.

    A graph's temporaries are freed when its capture ends, so the next
    capture reuses them and allocates nothing: with a pool of its own,
    each capture of a Fig. 1 round made 3-9 ``cudaMalloc`` calls and took
    7-226 ms to record against 3-5 ms, and the dead graphs' pools stayed
    reserved (``launch/graph_costs.py``; PERF_ARCHIVE.md, PR 20).  A pool
    lives while a graph uses it, so a graph of one kernel, never replayed,
    holds it for the process.  Sharing asks two things of the graphs: they do
    not replay concurrently (every replay here runs on the current stream,
    in order), and no capture keeps alive a tensor it allocated, whose
    memory may be an earlier graph's temporary (:class:`CapturedRound`
    checks it)."""
    index = _device_index(device)
    if index not in _POOL_ANCHORS:
        anchor = torch.cuda.CUDAGraph()
        flag = torch.zeros(1, device=index)
        with torch.cuda.stream(side):
            anchor.capture_begin()
            flag.add_(1)
            anchor.capture_end()
        _POOL_ANCHORS[index] = (anchor, flag)
    return _POOL_ANCHORS[index][0].pool()


class CapturedRound:
    """``fn`` (one round over static buffers) run once eagerly, as the
    warm-up, then captured once in a CUDA graph on a side stream, into the
    device's shared pool (:func:`_graph_pool`); :meth:`replay` launches
    the graph on the current stream.

    The host-side counters (:mod:`repro_torch.counters`: the kernels'
    launches, the collectives' calls and bytes) move when a wrapper runs,
    not when a kernel does: the capture's counts (work that has not run)
    are taken back, and every replay adds them again.  The graph is kept
    after its capture long enough to read its kernel nodes
    (:mod:`.graph_nodes`): :attr:`kernel_nodes` holds the port's RPCA
    kernels among them by family (``kernels.ops.KERNEL_FAMILIES``), what
    each replay launches on the device whatever the counters say; every
    replay adds them and the counters' share of the same families to
    :data:`replayed_kernels`."""

    def __init__(self, fn: Callable[[], None], device: torch.device):
        side = _capture_stream(device)
        current = torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn()
        pool = _graph_pool(device, side)
        before = counters.snapshot()
        held = torch.cuda.memory_allocated(device)
        mallocs = torch.cuda.memory_stats(device).get("num_device_alloc", 0)
        # Kept after capture_end (which then does not instantiate), so its
        # nodes can be read; instantiated below, inside the timed window.
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        # capture_begin/end rather than torch.cuda.graph, which also
        # synchronises the device, collects garbage and empties the
        # allocator's cache before every capture (tens to hundreds of ms
        # in a long-lived process, and every later allocation pays
        # cudaMalloc again).
        with torch.cuda.stream(side):
            t0 = time.perf_counter()
            self.graph.capture_begin(pool=pool)
            try:
                fn()
            except BaseException:
                # End the capture (it is invalid) and raise the cause.
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass
                raise
            t1 = time.perf_counter()
            self.graph.capture_end()
            self.graph.instantiate()
            t2 = time.perf_counter()
        current.wait_stream(side)
        kept = torch.cuda.memory_allocated(device) - held
        if kept:
            raise RuntimeError(
                f"a captured round kept {kept} bytes it allocated alive; "
                f"the graphs' shared pool needs every capture to free "
                f"what it allocates")
        #: What one replay counts, by registry and counter name.
        self.counts = counters.since(before)
        counters.add(self.counts, -1)
        #: The port's RPCA kernels among the graph's kernel nodes, by
        #: family (host work at capture only; a replay reads nothing).
        t3 = time.perf_counter()
        self.kernel_nodes = ops.kernels_by_family(
            graph_nodes.kernel_nodes(self.graph.raw_cuda_graph()))
        graph_counts["nodes_s"] += time.perf_counter() - t3
        self._counted = ops.family_launches(self.counts.get("launches", {}))
        graph_counts["captures"] += 1
        graph_counts["capture_s"] += t1 - t0
        graph_counts["instantiate_s"] += t2 - t1
        graph_counts["capture_mallocs"] += torch.cuda.memory_stats(
            device).get("num_device_alloc", 0) - mallocs

    def replay(self) -> None:
        self.graph.replay()
        counters.add(self.counts)
        graph_counts["replays"] += 1
        for key, per_replay in (("nodes", self.kernel_nodes),
                                ("counted", self._counted)):
            tally = replayed_kernels[key]
            for fam, n in per_replay.items():
                tally[fam] = tally.get(fam, 0) + n


class Rounds:
    """The rounds of one solve (or batch) over a state dict.

    ``body(state)`` runs one round and returns the entries it replaces;
    the diagnostics traces it writes in place.  Eagerly (``graph=False``)
    the state takes the new entries as they are.  With ``graph=True`` the
    state is static (cloned once here) and each round copies the new
    entries into it, so the first :meth:`advance` runs one round eagerly,
    captures the round (:class:`CapturedRound`) and replays it for the
    rest; later calls only replay."""

    def __init__(self, body: Callable[[dict], dict], state: dict,
                 device: torch.device, graph: bool):
        self.body = body
        self.device = device
        self.graph = graph
        self.state = tree_map(torch.clone, state) if graph else state
        self.captured: CapturedRound | None = None
        #: Rounds run so far (the host's count).
        self.rounds_run = 0

    def _round(self) -> None:
        new = self.body(self.state)
        if self.graph:
            copy_into({k: self.state[k] for k in new}, new)
        else:
            self.state.update(new)

    def advance(self, rounds: int) -> None:
        """Run ``rounds`` more rounds.  Under the sanitizer
        (:mod:`repro_torch.debug`) an eager round whose carry holds a NaN
        raises ``FloatingPointError`` naming it; the captured path checks
        once after its replays."""
        if rounds <= 0:
            return
        first = self.rounds_run + 1
        self.rounds_run += rounds
        if not self.graph:
            for k in range(first, self.rounds_run + 1):
                self._round()
                debug.check_nan(self.state.get("carry"), f"after round {k}")
            return
        if self.captured is None:
            self.captured = CapturedRound(self._round, self.device)
            rounds -= 1
        for _ in range(rounds):
            self.captured.replay()
        debug.check_nan(self.state.get("carry"),
                        f"after rounds {first}-{self.rounds_run} (replayed)")


#: The fewest rounds for which a captured round pays: the first runs
#: eagerly and the capture records another without running it, so with two
#: rounds one replay would save what the capture costs.
MIN_GRAPH_ROUNDS = 3


def use_graph(solver: Solver, device: torch.device, eager: bool,
              rounds: int) -> bool:
    """Whether :func:`run` and :func:`solve_batch` replay a captured round
    over a budget of ``rounds``: on a CUDA device, for a capturable solver,
    at :data:`MIN_GRAPH_ROUNDS` rounds or more, unless ``eager``."""
    return (device.type == "cuda" and solver.capturable and not eager
            and rounds >= MIN_GRAPH_ROUNDS)


def device_of(problem: Any) -> torch.device:
    return next(x.device for x in problem if isinstance(x, Tensor))


def _check_budget(run_cfg: RunConfig, max_iters: int) -> None:
    if run_cfg.mode not in ("scan", "while", "chunk"):
        raise ValueError(f"unknown mode {run_cfg.mode!r}")
    if max_iters < 1:
        raise ValueError(f"max_iters must be >= 1, got {max_iters}")


def single_state(solver: Solver, problem: Any, max_iters: int) -> dict:
    """The state of one solve before its first round: the initial carry,
    the round index and zeroed (max_iters,) traces."""
    device = device_of(problem)
    return {
        "carry": solver.init(problem),
        "t": torch.zeros((), dtype=torch.int32, device=device),
        "obj": torch.zeros(max_iters, device=device),
        "res": torch.zeros(max_iters, device=device),
    }


def single_body(solver: Solver, problem: Any) -> Callable[[dict], dict]:
    """One round of one solve: step, diagnostics, the traces written at the
    round index (on the device), the index advanced."""

    def body(s: dict) -> dict:
        t = s["t"]
        carry = solver.step(problem, s["carry"], t)
        d = solver.diagnostics(problem, carry)
        i = t.reshape(1).to(torch.int64)
        s["obj"].index_copy_(0, i, d.objective.to(torch.float32).reshape(1))
        s["res"].index_copy_(0, i, d.residual.to(torch.float32).reshape(1))
        return {"carry": carry, "t": t + 1}

    return body


#: The per-slot state of a slot table beside the carry (``serving.
#: rpca_service``): the schedule position, the done and converged flags,
#: the rounds spent and the quarantine flag.
SLOT_COUNTERS = ("t", "done", "rounds", "hit", "dived")


def slot_counters(slots: int, device: torch.device) -> dict:
    """Zeroed :data:`SLOT_COUNTERS` of ``slots`` slots."""
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return {"t": torch.zeros(slots, **i32), "done": torch.zeros(slots, **b),
            "rounds": torch.zeros(slots, **i32),
            "hit": torch.zeros(slots, **b), "dived": torch.zeros(slots, **b)}


def slot_body(solver: Solver, problems: Any, tol: float, min_rounds: int,
              max_rounds: int) -> Callable[[dict], dict]:
    """One lock-step round of a slot table (the reference service's tick
    body): ``problems`` carries a leading slot axis, and the state holds
    the batched carry, the :data:`SLOT_COUNTERS` and ``active``, the slots
    this lane owns.  A slot advances when it is active and not done: its
    carry steps at its own schedule position ``t`` (a (slots,) int32; the
    solver adds the problem's ``t0``), ``t`` and ``rounds`` grow by one;
    a non-finite residual quarantines it (``dived`` and ``done``), a
    residual within ``tol`` after ``min_rounds`` rounds converges it
    (``hit``), and ``max_rounds`` ends it.  Every slot computes every
    round; the others keep their state through ``torch.where``
    (:func:`tree_where`), so a quarantined slot's NaNs reach no
    neighbour.  Nothing is read on the host: the round is capturable
    where the solver is."""

    def body(s: dict) -> dict:
        done, rounds = s["done"], s["rounds"]
        adv = s["active"] & ~done
        carry = tree_where(adv, solver.step(problems, s["carry"], s["t"]),
                           s["carry"])
        d = solver.diagnostics(problems, carry)
        inc = adv.to(torch.int32)
        rounds = rounds + inc
        bad = adv & ~torch.isfinite(d.residual)
        hit_now = (d.residual <= tol) & (rounds >= min_rounds)
        return {"carry": carry, "t": s["t"] + inc, "rounds": rounds,
                "hit": s["hit"] | (adv & hit_now),
                "dived": s["dived"] | bad,
                "done": done | bad | (adv & (hit_now
                                             | (rounds >= max_rounds)))}

    return body


def drive(rounds: Rounds, run_cfg: RunConfig, max_iters: int
          ) -> tuple[Any, SolveStats]:
    """Run ``rounds`` (one solve, from round 0) in ``run_cfg``'s mode;
    returns ``(final_carry, stats)``, both on the state's buffers."""
    s = rounds.state
    inf = torch.full((), float("inf"), device=rounds.device)
    last, prev_obj = Diag(inf, inf), inf
    chunk = {"scan": max_iters, "while": 1,
             "chunk": max(1, run_cfg.chunk_size)}[run_cfg.mode]
    t = 0
    while t < max_iters:
        if run_cfg.mode != "scan" and t >= run_cfg.min_iters and bool(
                _converged(run_cfg, last, prev_obj)):
            break
        n = min(chunk, max_iters - t)
        rounds.advance(n)
        t += n
        d = Diag(s["obj"][t - 1], s["res"][t - 1])
        if run_cfg.mode == "chunk":  # compared chunk end to chunk end
            prev_obj, last = last.objective, d
        else:
            prev_obj, last = (s["obj"][t - 2] if t > 1 else inf), d
    stats = SolveStats(
        objective=s["obj"], residual=s["res"],
        rounds=torch.full((), t, dtype=torch.int32, device=rounds.device),
        converged=_converged(run_cfg, last, prev_obj),
    )
    return s["carry"], stats


def run_segmented(solver: Solver, problem: Any, max_iters: int,
                  run_cfg: RunConfig = FIXED, *,
                  checkpoint_dir: str | None = None,
                  resume_from: str | None = None,
                  save_extra: Callable[[int, Any], None] | None = None
                  ) -> tuple[Any, SolveStats]:
    """:func:`run` in scan mode, split into segments of
    ``run_cfg.checkpoint_every`` rounds over the global round indices: the
    same steps, so the same bits as one scan, boundaries included (on the
    card, the same captured round replayed between the snapshots).

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

    device = device_of(problem)
    state = single_state(solver, problem, max_iters)
    t_done = 0
    if resume_from is not None:
        empty = torch.zeros(0, device=device)
        template = {"carry": state["carry"], "objective": empty,
                    "residual": empty}
        restored, t_done = ckpt.restore(resume_from, template)
        if t_done > max_iters:
            raise ValueError(
                f"checkpoint at round {t_done} exceeds this solve's "
                f"budget of {max_iters} rounds"
            )
        state["carry"] = restored["carry"]
        state["obj"][:t_done] = restored["objective"]
        state["res"][:t_done] = restored["residual"]
        state["t"].fill_(t_done)
    rounds = Rounds(single_body(solver, problem), state, device,
                    use_graph(solver, device, False, max_iters - t_done))
    s = rounds.state
    for seg in segment_plan(max_iters - t_done, run_cfg.checkpoint_every):
        rounds.advance(seg)
        t_done += seg
        if checkpoint_dir is not None and t_done < max_iters:
            ckpt.save(checkpoint_dir, t_done,
                      {"carry": s["carry"], "objective": s["obj"][:t_done],
                       "residual": s["res"][:t_done]})
            if save_extra is not None:
                save_extra(t_done, s["carry"])
    stats = SolveStats(
        objective=s["obj"], residual=s["res"],
        rounds=torch.full((), max_iters, dtype=torch.int32, device=device),
        converged=scan_converged(run_cfg, s["obj"], s["res"]),
    )
    return s["carry"], stats


def driver(solver: Solver, max_iters: int, run_cfg: RunConfig = FIXED
           ) -> Callable[[Any], tuple[Any, SolveStats]]:
    """``(solver, budget, run mode)`` closed into ``drive(problem) ->
    (final_carry, stats)``, the same as ``run(solver, problem, max_iters,
    run_cfg)`` (the reference's unit of its compile cache)."""

    def drive_problem(problem: Any) -> tuple[Any, SolveStats]:
        return run(solver, problem, max_iters, run_cfg)

    return drive_problem


def run(solver: Solver, problem: Any, max_iters: int,
        run_cfg: RunConfig = FIXED, *, eager: bool = False
        ) -> tuple[Any, SolveStats]:
    """Drive ``solver`` on one problem; returns ``(final_carry, stats)``.
    On the card a capturable solver replays one captured round (``eager``
    runs every round eagerly instead)."""
    _check_budget(run_cfg, max_iters)
    device = device_of(problem)
    rounds = Rounds(single_body(solver, problem),
                    single_state(solver, problem, max_iters), device,
                    use_graph(solver, device, eager, max_iters))
    return drive(rounds, run_cfg, max_iters)


def stack_problems(problems: list) -> Any:
    """Problems of one shape (named tuples) stacked on a leading problem
    axis, field by field (``None`` fields stay ``None``): the batch that
    :func:`solve_batch` takes."""
    first = problems[0]
    return type(first)(*(
        None if x is None else torch.stack([getattr(q, f) for q in problems])
        for f, x in zip(first._fields, first)))


def solve_batch(solver: Solver, problems: Any, max_iters: int,
                run_cfg: RunConfig = FIXED, *, eager: bool = False
                ) -> tuple[Any, Any, SolveStats]:
    """Solve a batch of problems in lock-step (the reference's
    ``solve_batch``); returns ``(solver.finalize output, final_carry,
    stats)``, every stats field with a leading batch axis.

    ``problems`` is the solver's problem with a leading problem axis on
    every leaf, and the solver's functions take that axis natively, so a
    round is one set of launches for the whole batch.  In ``while`` and
    ``chunk`` mode each problem that meets the criterion freezes: its
    carry, diagnostics and ``rounds`` stop, its traces are zero past its
    exit, and the loop ends once all are done.  The done mask and the
    freeze are part of the round (inside the captured graph on the card);
    the host reads ``all(done)`` once a round (``while``) or once a chunk
    of ``chunk_size`` rounds (``chunk``), which gives the same results
    since a frozen problem does not change.  ``scan`` runs the whole budget
    (nothing freezes) and computes ``converged`` from the last two trace
    entries, as :func:`run`."""
    _check_budget(run_cfg, max_iters)
    leaf = next((x for x in problems if isinstance(x, Tensor)), None)
    if leaf is None:
        raise ValueError("solve_batch needs a non-empty problem")
    batch, device = leaf.shape[0], leaf.device
    check = run_cfg.mode != "scan"
    inf = torch.full((batch,), float("inf"), device=device)
    state = {
        "carry": solver.init(problems),
        "t": torch.zeros((), dtype=torch.int32, device=device),
        "obj": torch.zeros(batch, max_iters, device=device),
        "res": torch.zeros(batch, max_iters, device=device),
        "done": torch.zeros(batch, dtype=torch.bool, device=device),
        "rounds": torch.zeros(batch, dtype=torch.int32, device=device),
        "last": Diag(inf, inf),
        "prev": inf,
    }

    def body(s: dict) -> dict:
        t, done, last = s["t"], s["done"], s["last"]
        new = solver.step(problems, s["carry"], t)
        # Nothing freezes in scan mode: skip the copy of every leaf.
        carry = tree_where(~done, new, s["carry"]) if check else new
        d = solver.diagnostics(problems, carry)
        d = Diag(torch.where(done, last.objective,
                             d.objective.to(torch.float32)),
                 torch.where(done, last.residual,
                             d.residual.to(torch.float32)))
        active = ~done
        i = t.reshape(1).to(torch.int64)
        s["obj"].index_copy_(
            1, i, torch.where(active, d.objective, 0.0)[:, None])
        s["res"].index_copy_(
            1, i, torch.where(active, d.residual, 0.0)[:, None])
        rounds = s["rounds"] + active.to(torch.int32)
        out = {"carry": carry, "t": t + 1, "rounds": rounds, "last": d,
               "prev": torch.where(active, d.objective, s["prev"])}
        if check:
            hit = _converged(run_cfg, d, s["prev"]) & (
                rounds >= run_cfg.min_iters)
            out["done"] = done | (active & hit)
        return out

    rounds = Rounds(body, state, device,
                    use_graph(solver, device, eager, max_iters))
    s = rounds.state
    period = {"scan": max_iters, "while": 1,
              "chunk": max(1, run_cfg.chunk_size)}[run_cfg.mode]
    t = 0
    while t < max_iters:
        n = min(period, max_iters - t)
        rounds.advance(n)
        t += n
        if check and bool(s["done"].all()):
            break
    done = s["done"] if check else scan_converged(run_cfg, s["obj"], s["res"])
    stats = SolveStats(objective=s["obj"], residual=s["res"],
                       rounds=s["rounds"], converged=done)
    return solver.finalize(problems, s["carry"]), s["carry"], stats
