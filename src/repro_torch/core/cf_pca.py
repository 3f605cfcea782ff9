"""CF-PCA: the centralized consensus-factorization baseline (Fig. 1), the
counterpart of ``repro.core.cf_pca`` for a single problem.

The same math as DCF-PCA with one client: each round is K iterations of
{inner (V, S) solve, U gradient step} on the whole matrix, run through the
batched kernels with E = 1.  A batch of B problems (:func:`cf_pca_batch`)
is the kernels' leading axis: one launch a sweep for all B.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import rpca as _rpca
from repro_torch.core import factorized as fz
from repro_torch.core import ops as core_ops
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core import validate
from repro_torch.device import resolve_device
from repro_torch.kernels import bitmask

Tensor = torch.Tensor


class CFResult(NamedTuple):
    l: Tensor  # recovered low-rank matrix (m, n)
    s: Tensor  # recovered sparse matrix (m, n)
    u: Tensor  # left factor (m, r)
    v: Tensor  # right factor (n, r)
    stats: rt.SolveStats


class CFProblem(NamedTuple):
    """Data, initial factors, threshold and schedule offset, on one device;
    a batch has a leading problem axis B on every field (m_obs (B, m, n),
    lam0 and t0 (B,))."""

    m_obs: Tensor  # (m, n), contiguous fp32 or bf16
    u_init: Tensor  # (m, r)
    v_init: Tensor  # (n, r)
    lam0: Tensor  # () base threshold
    t0: Tensor  # () int32 schedule offset
    mask: Tensor | None = None  # (m, n) 0/1 fp32, or packed uint8


class _Carry(NamedTuple):
    u: Tensor
    v: Tensor
    diag: rt.Diag


def make_solver(cfg: fz.DCFConfig, *, with_objective: bool = False) -> rt.Solver:
    """The runtime Solver for centralized CF-PCA under ``cfg``."""
    track = cfg.track_objective or with_objective

    def init(p: CFProblem) -> _Carry:
        inf = torch.full(p.lam0.shape, float("inf"), device=p.m_obs.device)
        return _Carry(u=p.u_init, v=p.v_init, diag=rt.Diag(inf, inf))

    def step(p: CFProblem, c: _Carry, t: Tensor) -> _Carry:
        t = t + p.t0
        lam_t = cfg.lam_at(p.lam0, t)
        if p.m_obs.ndim == 3:  # a batch: the kernels' leading axis
            u, v, diag = fz.local_round(c.u, c.v, p.m_obs, cfg=cfg,
                                        lam=lam_t, n_frac=1.0,
                                        eta=cfg.lr(t), w=p.mask)
        else:
            u, v, diag = fz.local_round(
                c.u, c.v[None], p.m_obs[None], cfg=cfg, lam=lam_t[None],
                n_frac=1.0, eta=cfg.lr(t),
                w=None if p.mask is None else p.mask[None],
            )
            u, v = u[0], v[0]
            diag = None if diag is None else (diag[0][0], diag[1][0])
        if not track:
            obj = torch.zeros(p.lam0.shape, device=u.device)
        elif diag is not None:
            obj = diag[0] + fz.reg_terms(u, v, cfg.rho, 1.0)
        else:
            obj = fz.local_objective(u, v, p.m_obs, cfg.rho, lam_t, 1.0,
                                     w=p.mask)
        resid = core_ops.fro(u - c.u) / (core_ops.fro(c.u) + 1e-30)
        return _Carry(u=u, v=v, diag=rt.Diag(obj, resid))

    def diagnostics(p: CFProblem, c: _Carry) -> rt.Diag:
        return c.diag

    def finalize(p: CFProblem, c: _Carry):
        lam = cfg.final_lam(p.lam0)
        if p.m_obs.ndim == 3:
            l, s = fz.finalize(c.u, c.v, p.m_obs, lam.contiguous(),
                               cfg.impl, w=p.mask)
            return l, s, c.u, c.v
        w = None if p.mask is None else p.mask[None]
        l, s = fz.finalize(c.u[None], c.v[None], p.m_obs[None], lam[None],
                           cfg.impl, w=w)
        return l[0], s[0], c.u, c.v

    return rt.Solver(init, step, diagnostics, finalize, capturable=True)


def _float_on(x, device: torch.device) -> Tensor:
    return torch.as_tensor(x).to(device=device,
                                 dtype=torch.float32).contiguous()


def _data_on(x, device: torch.device) -> Tensor:
    """The data plane on ``device``: bf16 stays bf16 (the compact plane);
    float16, float32 and float64 become fp32 (every float16 value is exact
    in fp32, and the reference computes a float16 plane in fp32)."""
    x = torch.as_tensor(x)
    if x.dtype == torch.bfloat16:
        return x.to(device=device).contiguous()
    if x.dtype not in (torch.float16, torch.float32, torch.float64):
        raise TypeError(
            f"data of dtype {x.dtype}: the solvers take float16, bfloat16, "
            f"float32 or float64 data")
    return _float_on(x, device)


def prepare_data(m_obs, cfg: fz.DCFConfig, mask, device: torch.device):
    """Shared set-up of both engines: checks, the data (fp32 or bf16) and
    the dense fp32 mask on ``device`` (hidden entries zero-filled in fp32
    and cast back) and the calibrated ``lam0`` (on the unpadded data,
    ``cfg.lam_sample`` entries at most).  Packing the mask is the engine's
    step: after its column split."""
    fz.check_supported(cfg, device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise ValueError(
            "TF32 matmuls are on (torch.backends.cuda.matmul.allow_tf32); "
            "the solvers need full fp32 products to meet their recovery "
            "bar: set it to False")
    m_obs = _data_on(m_obs, device)
    if mask is not None:
        validate.check_mask(mask, tuple(m_obs.shape))
        mask = _float_on(mask, device)
        m_obs = (mask * m_obs.to(torch.float32)).to(m_obs.dtype)
    if cfg.lam is not None:
        lam0 = torch.full((), float(cfg.lam), device=device)
    else:
        lam0 = fz.robust_lam(m_obs, mask=mask, sample=cfg.lam_sample)
    return m_obs, mask, lam0


def make_problem(
    m_obs,
    cfg: fz.DCFConfig,
    generator: int | torch.Generator | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    t0: int | None = None,
    mask=None,
    *,
    device: torch.device | str | None = None,
) -> CFProblem:
    """Assemble the problem on ``device`` (the card unless ``"cpu"``): random
    factors from ``generator`` (a seed, default 0) or ``warm=(U, V)``;
    ``t0`` offsets the schedules (a warm start continues them).  A bf16
    ``m_obs`` stays bf16; ``cfg.pack_mask`` stores the mask bit-packed."""
    device = resolve_device(device)
    m_obs, mask, lam0 = prepare_data(m_obs, cfg, mask, device)
    if mask is not None and cfg.pack_mask:
        mask = bitmask.pack_mask(mask)
    m, n = m_obs.shape
    fz.check_grid(cfg, 1, m, device)
    if warm is None:
        state = fz.init_state(prob.generator(generator), m, n, cfg.rank,
                              device)
        u0, v0 = state.u, state.v
    else:
        u0, v0 = validate.check_warm_shapes(
            warm, ("U", "V"), ((m, cfg.rank), (n, cfg.rank)),
            ("(m, rank)", "(n, rank)"),
        )
        u0, v0 = _float_on(u0, device), _float_on(v0, device)
    if t0 is None:
        t0 = 0 if warm is None else cfg.outer_iters
    return CFProblem(
        m_obs=m_obs, u_init=u0, v_init=v0, lam0=lam0,
        t0=torch.full((), t0, dtype=torch.int32, device=device), mask=mask,
    )


def make_batch(m_batch, cfg: fz.DCFConfig, generators=None,
               warm: tuple[Tensor, Tensor] | None = None, mask=None, *,
               device: torch.device | str | None = None) -> CFProblem:
    """A batch of B problems (``m_batch`` (B, m, n)) on ``device``: problem
    b is :func:`make_problem` of ``m_batch[b]`` with its own seed or
    generator (``rpca.batch_keys``), mask and warm slices ((B, m, r),
    (B, n, r)), stacked on a leading problem axis.  The kernels' grids must
    hold B clients (checked first)."""
    device = resolve_device(device)
    b = m_batch.shape[0]
    fz.check_supported(cfg, device)
    fz.check_grid(cfg, b, m_batch.shape[-2], device)
    keys = _rpca.batch_keys(generators, b)
    return rt.stack_problems([
        make_problem(m_batch[i], cfg, keys[i],
                     None if warm is None else (warm[0][i], warm[1][i]),
                     mask=None if mask is None else mask[i], device=device)
        for i in range(b)])


def solve_problem(problem: CFProblem, cfg: fz.DCFConfig,
                  run: rt.RunConfig | str | None = None) -> CFResult:
    """Run the solver on an assembled problem (or a batch:
    ``runtime.solve_batch``) and finalize."""
    run = rt.resolve_run(run)
    solver = make_solver(cfg, with_objective=run.needs_objective)
    if problem.m_obs.ndim == 3:
        (l, s, u, v), _, stats = rt.solve_batch(solver, problem,
                                                cfg.outer_iters, run)
        return CFResult(l=l, s=s, u=u, v=v, stats=stats)
    carry, stats = rt.run(solver, problem, cfg.outer_iters, run)
    l, s, u, v = solver.finalize(problem, carry)
    return CFResult(l=l, s=s, u=u, v=v, stats=stats)


def cf_pca(
    m_obs,
    cfg: fz.DCFConfig,
    generator: int | torch.Generator | None = None,
    *,
    run: rt.RunConfig | str | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    mask=None,
    device: torch.device | str | None = None,
) -> CFResult:
    """Centralized CF-PCA for ``cfg.outer_iters`` rounds on ``device`` (the
    card unless ``"cpu"``); ``mask`` restricts the residual to observed
    entries.  ``m_obs`` may be bf16; L, S and the factors are fp32."""
    problem = make_problem(m_obs, cfg, generator, warm, mask=mask,
                           device=device)
    return solve_problem(problem, cfg, run)


def cf_pca_batch(
    m_batch,
    cfg: fz.DCFConfig,
    keys=None,
    *,
    run: rt.RunConfig | str | None = None,
    warm: tuple[Tensor, Tensor] | None = None,
    mask=None,
    device: torch.device | str | None = None,
) -> CFResult:
    """Solve a stack of problems (``m_batch`` (B, m, n)) together; under
    the early-exit modes a finished problem freezes.  ``keys``: one seed
    or generator a problem (``rpca.batch_keys``).  A shim over
    ``repro_torch.rpca.solve`` (the leading axis selects the batch)."""
    res = _rpca.solve(_rpca.RPCASpec(m_batch, mask=mask, warm=warm,
                                     key=keys),
                      method="cf", run=run, cfg=cfg, device=device)
    return CFResult(l=res.l, s=res.s, u=res.u, v=res.v, stats=res.stats)


# ---------------------------------------------------------------------------
# Registry adapter (repro_torch.rpca front door)
# ---------------------------------------------------------------------------
def _default_cfg(spec) -> fz.DCFConfig:
    rank = _rpca.require_rank("cf", spec)
    if spec.mask is not None:
        return fz.DCFConfig.masked(rank)
    return fz.DCFConfig.tuned(rank)


def _registry_make(spec, cfg, run_cfg, device):
    cfg = cfg if cfg is not None else _default_cfg(spec)
    _rpca.require_cfg_type("cf", cfg, fz.DCFConfig)
    if spec.batched:
        problem = make_batch(spec.m_obs, cfg, _rpca.default_key(spec),
                             spec.warm, mask=spec.mask, device=device)
        res = solve_problem(problem, cfg, run_cfg)
    else:
        res = cf_pca(spec.m_obs, cfg, _rpca.default_key(spec), run=run_cfg,
                     warm=spec.warm, mask=spec.mask, device=device)
    return res.l, res.s, res.u, res.v, res.stats


def _service_empty(cfg: fz.DCFConfig, slots: int, m: int, n: int,
                   device: torch.device) -> CFProblem:
    """An empty slot table: zero data, factors, ``lam0`` and ``t0``, and an
    all-ones mask plane (packed under ``cfg.pack_mask``).  The kernels'
    grids must hold the slots as clients (checked here)."""
    device = torch.device(device)
    fz.check_grid(cfg, slots, m, device)

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return CFProblem(
        m_obs=zeros(slots, m, n), u_init=zeros(slots, m, cfg.rank),
        v_init=zeros(slots, n, cfg.rank), lam0=zeros(slots),
        t0=zeros(slots, dtype=torch.int32),
        mask=(bitmask.packed_ones((slots, m, n), device) if cfg.pack_mask
              else torch.ones(slots, m, n, device=device)))


def _service_problem(m_obs, cfg: fz.DCFConfig, key, warm, mask,
                     device: torch.device) -> CFProblem:
    """One slot's problem.  A maskless submission calibrates ``lam`` on the
    unmasked path (plain medians, no masked sort), then takes the all-ones
    plane that the homogeneous slot table needs: numerically the same."""
    if mask is None:
        problem = make_problem(m_obs, cfg, key, warm, device=device)
        shape = tuple(problem.m_obs.shape)
        return problem._replace(
            mask=(bitmask.packed_ones(shape, device) if cfg.pack_mask
                  else torch.ones(shape, device=device)))
    return make_problem(m_obs, cfg, key, warm, mask=mask, device=device)


def _service_warm_layout(cfg: fz.DCFConfig, m: int, n_req: int):
    return (
        ("U", (m, cfg.rank), "(m, rank)", None),
        ("V", (n_req, cfg.rank), "(n, rank)", 0),
    )


def _aot_resolve_cfg(cfg, spec) -> fz.DCFConfig:
    cfg = cfg if cfg is not None else _default_cfg(spec)
    _rpca.require_cfg_type("cf", cfg, fz.DCFConfig)
    return cfg


def _aot_program(cfg: fz.DCFConfig, run_cfg: rt.RunConfig):
    """The compile cache's bucket program (the reference's
    ``_aot_program``): the mask is always there (the padding rides it),
    ``lam0`` is calibrated on the device over the mask (the masked medians
    ignore the mask-zero tail, so it is the unpadded value), and a cold
    start draws its factors at the bucket shape; the padded factor rows
    never reach the true block.  The round is captured on the card."""
    solver = make_solver(cfg, with_objective=run_cfg.needs_objective)

    def problem(m_obs, key, mask, warm, lam0) -> CFProblem:
        del lam0  # calibrated on the device (robust_lam over the mask)
        return make_problem(m_obs, cfg, key, warm, mask=mask,
                            device=m_obs.device)

    return solver, cfg.outer_iters, problem


def _aot_warm_shapes(cfg: fz.DCFConfig, m: int, n: int):
    return (("U", (m, cfg.rank), "(m, rank)"),
            ("V", (n, cfg.rank), "(n, rank)"))


_rpca.register_solver(
    "cf",
    _rpca.SolverCaps(supports_mask=True, supports_factors=True,
                     batchable=True, needs_rank=True,
                     supports_service=True, supports_lowp=True),
    _registry_make,
    service=_rpca.ServiceHooks(
        make_solver=make_solver,
        empty_problems=_service_empty,
        make_problem=_service_problem,
        unpack=lambda fin: fin,
        warm_layout=_service_warm_layout,
        cfg_type=fz.DCFConfig,
    ),
    aot=_rpca.AOTHooks(resolve_cfg=_aot_resolve_cfg, program=_aot_program,
                       warm_shapes=_aot_warm_shapes),
)
