"""The front door for the ported solvers (counterpart of ``repro.rpca``).

A problem is an :class:`RPCASpec`, solved through one :func:`solve` call
and returned as one :class:`RPCAResult` whichever solver ran:

    from repro_torch import rpca
    res = rpca.solve(m_obs)                          # auto: ialm here
    res = rpca.solve(m_obs, method="dcf", cfg=DCFConfig.tuned(150),
                     num_clients=10)                 # on the card
    res = rpca.solve(m_obs, method="cf", rank=8, device="cpu")

Dispatch goes through the :data:`SOLVERS` registry, as in the reference:
each solver module registers itself (:func:`register_solver`) with a
:class:`SolverCaps` record, so a feature a method lacks is refused before
any solve starts, with the reference's words.  ``"cf"``, ``"dcf"``,
``"ialm"``, ``"apgm"`` and ``"dcf_sharded"`` solve.

A solve runs on the CUDA card unless ``device="cpu"`` is passed; with no
card and no device named it raises.  ``dtype=torch.bfloat16`` stores M as
the compact bf16 plane for the factorized methods (results stay fp32).
``"dcf"`` takes participation schedules, fault plans, the robust
aggregators and mid-solve checkpoints::

    res = rpca.solve(m_obs, method="dcf", num_clients=10,
                     participation=0.5, faults=FaultPlan.byzantine(
                         100, 10, (1, 5), kind="nan"),
                     cfg=DCFConfig.tuned(150, aggregator="coordinate_median"),
                     checkpoint_dir="ckpt", run=RunConfig(checkpoint_every=25))

A batch is a (B, m, n) ``m_obs`` (masks (B, m, n), warm pairs with a
leading B): every registered method but ``"dcf_sharded"`` solves it in
lock-step, one kernel launch a sweep for the whole batch, and a finished
problem freezes under the early-exit modes (``core.runtime.solve_batch``)::

    res = rpca.solve(rpca.RPCASpec(m_batch, num_clients=8), method="dcf",
                     cfg=DCFConfig.tuned(8), run="early")
    res.l.shape, res.stats.rounds   # (B, m, n), (B,)

``"dcf"`` also runs the wire consensus: ``DCFConfig(...,
consensus_compress=CompressConfig(topk_frac=0.1), consensus_delay=1)``
(``distributed.grad_compress``), its modelled traffic in
``distributed.multihost.consensus_traffic()``.

``"dcf_sharded"`` runs one client a ``torch.distributed`` rank: every
rank of a ``DeviceMesh`` (``distributed.multihost.multihost_mesh``) calls
``solve`` with the whole matrix, holds its own column block (its row block
too, with ``model_axis``) and gets the whole result back::

    mesh = multihost_mesh(("data", "model"), (2, 2), device="cpu")
    res = rpca.solve(rpca.RPCASpec(m_obs, mesh=mesh, model_axis="model"),
                     method="dcf_sharded", cfg=DCFConfig.tuned(8),
                     device="cpu")

``compile_policy="aot"`` (or a ``CompilePolicy``) solves through the
shape-bucketed compile cache (``core.compile_cache``): the problem is
zero-padded into its shape bucket behind the mask, and every problem of a
bucket replays the bucket's one captured round on the card::

    res = rpca.solve(m_obs, method="cf", rank=8, compile_policy="aot")
    res.cache_stats   # hits, misses, compiles, evictions

Specs the cache cannot express (batched, simulated clients,
participation, a mesh) and methods without AOT hooks take the regular
path, with ``cache_stats`` ``None``.

A method registered with :class:`ServiceHooks` (``"cf"``, ``"ialm"``,
``"apgm"``) backs the slots of ``serving.RPCAService`` and the gateway in
front of it.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import TYPE_CHECKING, Any, Callable, Sequence

import torch

from repro_torch.device import resolve_device

if TYPE_CHECKING:  # annotations only: see the import note below
    from repro_torch.core import runtime as rt

# This module imports nothing of repro_torch.core at module level: the solver
# modules there register themselves here when they are imported, so this
# module must be whole before repro_torch.core's package init pulls them in
# (the reference's rule, repro/rpca.py).  Runtime and validation helpers are
# imported inside the functions that need them.


def _rt():
    from repro_torch.core import runtime as rt

    return rt


def _val():
    from repro_torch.core import validate as val

    return val


#: One SVD of an (m, n) problem costs about m n min(m, n) flops; past this,
#: ``method="auto"`` picks the SVD-free ``"cf"`` when a rank is known (the
#: reference's ``repro.rpca.SVD_COST_THRESHOLD``).
SVD_COST_THRESHOLD = 1 << 26


# ---------------------------------------------------------------------------
# Problem spec and uniform result
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class RPCASpec:
    """One RPCA problem: ``m_obs`` (m, n), an optional 0/1 ``mask``, the
    target ``rank`` (factorized methods, when no cfg is passed), the client
    count ``num_clients`` for ``"dcf"``, a warm pair (``(L, S)`` for the
    convex methods, ``(U, V)`` for the factorized ones), and ``key``, the
    seed (or ``torch.Generator``) of the random factor init (default 0; a
    batch's keys: :func:`default_key`).
    ``dtype`` casts ``m_obs`` (fp32 or bf16).  ``participation`` is a
    (T, E) 0/1 round schedule or a Bernoulli rate, ``faults`` a
    ``distributed.faults.FaultPlan`` or its (T_f, E) code table (both for
    ``"dcf"``); ``checkpoint_dir`` takes a snapshot of the solve every
    ``RunConfig.checkpoint_every`` rounds and ``resume_from`` finishes the
    solve from the latest one there, bit-exact with an uninterrupted run.
    ``mesh`` / ``data_axes`` / ``model_axis`` place the problem on a
    ``torch.distributed`` ``DeviceMesh`` for ``"dcf_sharded"``: one client a
    rank along ``data_axes``, rows split over ``model_axis``; a mesh makes
    ``method="auto"`` pick ``"dcf_sharded"``."""

    m_obs: Any
    mask: Any = None
    rank: int | None = None
    num_clients: int | None = None
    participation: Any = None
    warm: tuple[Any, Any] | None = None
    key: int | torch.Generator | None = None
    mesh: Any = None
    data_axes: tuple[str, ...] = ("data",)
    model_axis: str | None = None
    dtype: torch.dtype | None = None
    faults: Any = None
    checkpoint_dir: str | None = None
    resume_from: str | None = None

    @property
    def batched(self) -> bool:
        return len(self.m_obs.shape) == 3

    @property
    def shape(self) -> tuple[int, int]:
        """The per-problem ``(m, n)`` shape (batch axis stripped)."""
        return tuple(self.m_obs.shape[-2:])

    def validate(self) -> None:
        val = _val()
        nd = len(self.m_obs.shape)
        if nd not in (2, 3):
            raise ValueError(
                f"m_obs must be (m, n) or (B, m, n); got ndim={nd}"
            )
        val.check_mask(self.mask, tuple(self.m_obs.shape))
        if self.warm is not None:
            val.check_warm_pair(self.warm)


@dataclass(frozen=True)
class RPCAResult:
    """Uniform solve result: components, factors (``None`` for the convex
    methods), stats, the method that ran, the spec, and the compile cache's
    counters after a cached solve (``None`` otherwise)."""

    l: torch.Tensor
    s: torch.Tensor
    u: torch.Tensor | None
    v: torch.Tensor | None
    stats: rt.SolveStats
    method: str
    spec: RPCASpec = field(repr=False)
    cache_stats: Any = None

    @property
    def factors(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        return None if self.u is None else (self.u, self.v)

    @property
    def history(self) -> torch.Tensor:
        """The per-iteration objective trace."""
        return self.stats.objective


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SolverCaps:
    """What a registered solver supports; ``solve`` validates against this.
    The fields and defaults of ``repro.rpca.SolverCaps`` (see there for
    each flag)."""

    supports_mask: bool = True
    supports_factors: bool = False
    supports_clients: bool = False
    supports_participation: bool = False
    supports_sharding: bool = False
    batchable: bool = True
    needs_rank: bool = False
    supports_service: bool = False
    supports_lowp: bool = False
    supports_multiprocess: bool = False
    supports_robust_agg: bool = False
    supports_checkpoint: bool = False


@dataclass(frozen=True)
class AOTHooks:
    """How a solver plugs into the compile cache (``core.compile_cache``;
    the reference's ``AOTHooks``, field for field).

    ``resolve_cfg``  ``(cfg_or_None, spec) -> cfg``: the concrete, hashable
                     config that keys the entry, resolved against the
                     *true* spec (before the bucket padding).
    ``program``      ``(cfg, run_cfg) -> (solver, rounds, make_problem)``:
                     the runtime solver, its round budget, and
                     ``make_problem(m_obs, key, mask, warm, lam0)``, which
                     builds one problem from the bucket-shaped device
                     planes at every admission (eagerly, into the entry's
                     static buffers; ``mask`` is always a dense 0/1 plane,
                     the padding mask-zero, ``lam0`` the true-shape convex
                     threshold).  The solver's finalize returns ``(l, s,
                     u, v)`` or ``(l, s)``.  Where the reference traces
                     ``program`` into one executable, the port captures
                     one round of it in a CUDA graph (a capturable solver)
                     or runs it eagerly on the bucket's static buffers.
    ``warm_shapes``  ``(cfg, m, n) ->`` per-factor ``(name, shape, desc)``
                     records, at the true shape to validate and at the
                     bucket shape to pad into.
    """

    resolve_cfg: Callable[[Any, RPCASpec], Any]
    program: Callable[[Any, Any], tuple]
    warm_shapes: Callable[[Any, int, int], tuple]


@dataclass(frozen=True)
class ServiceHooks:
    """How a solver plugs into ``serving.RPCAService``'s slot lanes (the
    reference's ``ServiceHooks``, field for field; the two builders also
    take the lane's device).

    ``make_solver``     cfg -> runtime ``core.runtime.Solver``.
    ``empty_problems``  (cfg, slots, m, n, device) -> zeroed batched problem
                        (homogeneous across slots: always carries a mask
                        plane; all-ones = numerically the unmasked path).
    ``make_problem``    (m_obs, cfg, key, warm, mask, device) -> one problem
                        slot-compatible with ``empty_problems``.
    ``unpack``          finalize output -> ``(l, s, u-or-None, v-or-None)``.
    ``warm_layout``     (cfg, m, n_req) -> sequence of
                        ``(name, expected_shape, desc, pad_axis)`` records
                        used to validate and ragged-pad ``warm=`` factors
                        (``pad_axis=None`` = never padded).
    ``default_cfg``     zero-arg cfg factory for lanes created without an
                        explicit config (``None`` = config required).
    ``cfg_type``        expected config class; the service validates lane
                        configs against it eagerly (``None`` = unchecked).
    """

    make_solver: Callable[[Any], Any]
    empty_problems: Callable[[Any, int, int, int, torch.device], Any]
    make_problem: Callable[..., Any]
    unpack: Callable[[Any], tuple]
    warm_layout: Callable[[Any, int, int], Sequence[tuple]]
    default_cfg: Callable[[], Any] | None = None
    cfg_type: type | None = None


@dataclass(frozen=True)
class SolverEntry:
    """A registered solver.  ``make(spec, cfg, run_cfg, device)`` runs the
    solve and returns ``(l, s, u, v, stats)``; ``aot`` opts it into the
    compile cache (:class:`AOTHooks`); ``service`` into the slot service
    (:class:`ServiceHooks`)."""

    name: str
    caps: SolverCaps
    make: Callable[[RPCASpec, Any, Any, torch.device], tuple]
    service: ServiceHooks | None = None
    aot: AOTHooks | None = None


#: The solver registry: filled by the solver modules when imported.
SOLVERS: dict[str, SolverEntry] = {}


def register_solver(name: str, caps: SolverCaps,
                    make: Callable[[RPCASpec, Any, Any, torch.device], tuple],
                    service: ServiceHooks | None = None,
                    aot: AOTHooks | None = None) -> None:
    """Register (or re-register) a solver under ``name``.  ``cfg`` reaches
    ``make`` as ``None`` when the caller passed none (the adapter picks its
    default); ``service`` opts the method into the slot service
    (``serving.RPCAService``), ``aot`` into the compile cache
    (``solve(..., compile_policy=...)``)."""
    SOLVERS[name] = SolverEntry(name=name, caps=caps, make=make,
                                service=service, aot=aot)


def _ensure_registered() -> None:
    """Import the solver modules (idempotent; they register themselves)."""
    from repro_torch.core import apgm, cf_pca, dcf_pca, ialm  # noqa: F401


def get_solver(name: str) -> SolverEntry:
    """Resolve a registry entry; unknown names list the known methods."""
    _ensure_registered()
    try:
        return SOLVERS[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; registered methods: "
            f"{', '.join(sorted(SOLVERS))}"
        ) from None


def methods_with(feature: str) -> list[str]:
    """Names of registered methods whose caps have ``feature`` True."""
    _ensure_registered()
    return sorted(
        n for n, e in SOLVERS.items() if getattr(e.caps, feature)
    )


def _unsupported(name: str, feature: str, flag: str) -> ValueError:
    return ValueError(
        f"method {name!r} does not support {feature}; methods with "
        f"{feature}: {', '.join(methods_with(flag)) or '(none)'}"
    )


def _is_lowp(dtype: Any) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def _check_caps(entry: SolverEntry, spec: RPCASpec,
                cfg: Any = None) -> None:
    """Eager feature x method validation with the reference's messages
    (``repro.rpca._check_caps``), in its order."""
    caps = entry.caps
    # getattr: the specs may be partial (as the reference's tests drive it).
    if (getattr(spec, "faults", None) is not None
            and not caps.supports_robust_agg):
        raise _unsupported(
            entry.name, "fault injection (no consensus boundary)",
            "supports_robust_agg",
        )
    if cfg is not None and not caps.supports_robust_agg:
        if (getattr(cfg, "aggregator", "weighted_mean") != "weighted_mean"
                or getattr(cfg, "divergence_screen", None) is not None):
            raise _unsupported(
                entry.name, "robust consensus aggregation",
                "supports_robust_agg",
            )
    if ((getattr(spec, "checkpoint_dir", None) is not None
         or getattr(spec, "resume_from", None) is not None)
            and not caps.supports_checkpoint):
        raise _unsupported(
            entry.name, "mid-solve checkpoint/resume",
            "supports_checkpoint",
        )
    if _is_lowp(spec.m_obs.dtype) and not caps.supports_lowp:
        raise _unsupported(
            entry.name, "low-precision (bf16/f16) data planes",
            "supports_lowp",
        )
    if spec.mask is not None and not caps.supports_mask:
        raise _unsupported(entry.name, "observation masks", "supports_mask")
    if spec.num_clients is not None and not caps.supports_clients:
        raise _unsupported(
            entry.name, "simulated client topologies (num_clients)",
            "supports_clients",
        )
    if spec.participation is not None and not caps.supports_participation:
        raise _unsupported(
            entry.name, "participation schedules", "supports_participation"
        )
    mesh = getattr(spec, "mesh", None)
    if mesh is not None and not caps.supports_sharding:
        raise _unsupported(entry.name, "device meshes", "supports_sharding")
    if mesh is not None and not caps.supports_multiprocess:
        # A mesh spanning OS processes: only solvers whose collectives run
        # in lock-step may run there.
        from repro_torch.distributed import multihost as mh

        if mh.is_multiprocess_mesh(mesh):
            raise _unsupported(
                entry.name, "multi-process meshes (torch.distributed)",
                "supports_multiprocess",
            )
    if spec.batched and not caps.batchable:
        raise _unsupported(
            entry.name, "batched problems (leading problem axis)",
            "batchable",
        )
    if caps.supports_sharding and mesh is None:
        raise ValueError(
            f"method {entry.name!r} requires a device mesh: set "
            f"RPCASpec.mesh"
        )


# ---------------------------------------------------------------------------
# method="auto"
# ---------------------------------------------------------------------------
def auto_method(spec: RPCASpec, cfg: Any = None) -> str:
    """The method ``method="auto"`` picks, by the reference's rules
    (``repro.rpca.auto_method``), in its order:

    1. a device mesh -> ``"dcf_sharded"``;
    2. a participation schedule or ``num_clients`` -> ``"dcf"``;
    3. a cfg that carries a rank -> ``"cf"``;
    4. a low-precision data plane -> ``"cf"`` (a rank is then required);
    5. a known rank and one SVD costlier than :data:`SVD_COST_THRESHOLD`
       flops -> ``"cf"``;
    6. otherwise ``"ialm"``."""
    if getattr(spec, "mesh", None) is not None:
        return "dcf_sharded"
    if spec.participation is not None or spec.num_clients is not None:
        return "dcf"
    if cfg is not None and getattr(cfg, "rank", None) is not None:
        return "cf"
    if _is_lowp(spec.m_obs.dtype):
        if spec.rank is None:
            raise ValueError(
                "a low-precision (bf16/f16) data plane needs a factorized "
                "method: set RPCASpec.rank (auto then picks 'cf') or cast "
                "m_obs to float32 for the convex solvers"
            )
        return "cf"
    m, n = spec.shape
    if spec.rank is not None and m * n * min(m, n) > SVD_COST_THRESHOLD:
        return "cf"
    return "ialm"


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------
def solve(spec_or_matrix: RPCASpec | Any, method: str = "auto", *,
          run: rt.RunConfig | str | None = None, cfg: Any = None,
          compile_policy: Any = None,
          device: torch.device | str | None = None,
          **spec_kwargs: Any) -> RPCAResult:
    """Solve one RPCA problem through the registry on ``device`` (the card
    unless ``"cpu"``): ``method`` is a registered name or ``"auto"``
    (:func:`auto_method`); ``run`` a ``RunConfig``, a preset name or
    ``None`` (the fixed schedule); ``cfg`` the method's config
    (``DCFConfig``, ``IALMConfig`` or ``APGMConfig``; ``None`` picks the
    method's default).  A batched spec (``m_obs`` (B, m, n)) solves its B
    problems together (``core.runtime.solve_batch``; every result field
    gets a leading B), each problem's factors drawn from its own seed
    (:func:`default_key`).  ``compile_policy`` (``"aot"``, a
    ``CompilePolicy``, or ``None`` / ``"off"``) takes the shape-bucketed
    compile cache where the spec and method allow it (the reference's
    bypasses take the regular path, ``cache_stats`` then ``None``)."""
    if isinstance(spec_or_matrix, RPCASpec):
        if spec_kwargs:
            raise ValueError(
                "pass spec fields either in the RPCASpec or as keywords, "
                f"not both: {sorted(spec_kwargs)}"
            )
        spec = spec_or_matrix
    else:
        spec = RPCASpec(spec_or_matrix, **spec_kwargs)
    if spec.dtype is not None and spec.m_obs.dtype != spec.dtype:
        spec = replace(spec, m_obs=torch.as_tensor(spec.m_obs).to(spec.dtype))
    spec.validate()
    device = resolve_device(device)
    run_cfg = _rt().resolve_run(run)
    if method == "auto":
        method = auto_method(spec, cfg)
    entry = get_solver(method)
    _check_caps(entry, spec, cfg)
    if compile_policy is not None:
        from repro_torch.core import compile_cache as cc

        policy = cc.resolve_policy(compile_policy)
        if policy is not None:
            out = cc.solve_cached(entry, spec, cfg, run_cfg, policy,
                                  device=device)
            if out is not None:
                l, s, u, v, stats, cstats = out
                return RPCAResult(l=l, s=s, u=u, v=v, stats=stats,
                                  method=entry.name, spec=spec,
                                  cache_stats=cstats)
    l, s, u, v, stats = entry.make(spec, cfg, run_cfg, device)
    return RPCAResult(l=l, s=s, u=u, v=v, stats=stats, method=entry.name,
                      spec=spec)


# ---------------------------------------------------------------------------
# Adapter helpers shared by the solver modules
# ---------------------------------------------------------------------------
def require_cfg_type(name: str, cfg: Any, cfg_type: type) -> None:
    """Uniform config-type error for the registry adapters."""
    if not isinstance(cfg, cfg_type):
        raise ValueError(
            f"method {name!r} takes a {cfg_type.__name__}, got "
            f"{type(cfg).__name__}"
        )


def require_rank(name: str, spec: RPCASpec) -> int:
    """Factorized methods need a rank when no cfg was passed."""
    if spec.rank is None:
        raise ValueError(
            f"method {name!r} needs a target rank: set RPCASpec.rank or "
            f"pass cfg=DCFConfig(...)"
        )
    return spec.rank


def default_key(spec: RPCASpec):
    """The seed (or generator) of the factor init: the spec's ``key``, 0 if
    unset (``jax.random`` keys do not carry across).  For a batch of B
    problems, a list of B, one a problem (:func:`batch_keys`)."""
    if spec.batched:
        return batch_keys(spec.key, spec.m_obs.shape[0])
    return 0 if spec.key is None else spec.key


def batch_keys(key, batch: int) -> list:
    """One seed or generator a problem of a batch: ``None`` gives seeds
    ``0 .. B-1`` and an int ``k`` seeds ``k .. k+B-1`` (problem b draws its
    factors, and its participation schedule, as a serial solve with seed
    ``k + b`` would); a sequence of B seeds or generators is taken as it
    is; one ``torch.Generator`` serves every problem, in batch order."""
    if key is None:
        key = 0
    if isinstance(key, torch.Generator):
        return [key] * batch
    if isinstance(key, int) or (isinstance(key, torch.Tensor)
                                and key.ndim == 0):
        return [int(key) + b for b in range(batch)]
    keys = list(key)
    if len(keys) != batch:
        raise ValueError(
            f"a batch of {batch} problems needs {batch} keys, got "
            f"{len(keys)}")
    return keys


def __getattr__(name: str) -> Any:
    # CompilePolicy lives in repro_torch.core (not imported here at module
    # level: see the note at the top) but belongs on the front door beside
    # ``solve(..., compile_policy=...)``, as in the reference.
    if name == "CompilePolicy":
        from repro_torch.core.compile_cache import CompilePolicy

        return CompilePolicy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "AOTHooks",
    "CompilePolicy",
    "RPCAResult",
    "RPCASpec",
    "SOLVERS",
    "ServiceHooks",
    "SolverCaps",
    "SolverEntry",
    "SVD_COST_THRESHOLD",
    "auto_method",
    "get_solver",
    "methods_with",
    "register_solver",
    "solve",
]
