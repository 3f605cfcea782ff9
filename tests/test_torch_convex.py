"""The convex baselines (IALM, APGM), the registry front door and paper
Table 1's metrics of the port against the JAX reference, on the CPU.

Problems come from the reference (its generator and its ``_problem``) and
cross through ``repro_torch.convert``.  Tolerances:
- L and S of a solve within 1e-5 relative (Frobenius) of the reference's:
  one LAPACK SVD an iteration on each side, fp32, both converged to the
  same point;
- recovery (Eq. 30) under the reference's own bars, 1e-6 for IALM and 1e-5
  for APGM (tests/test_rpca_core.py:38-45);
- ``svt``, ``singular_value_error`` and ``rank_gap`` on the same L within
  1e-5 relative (one fp32 SVD each; ``rank_gap`` also 1e-6 absolute, its
  sigma_{r+1} being noise-level);
- Table 1 at n = 200: the port's singular-value error within 1e-4 of the
  reference's (100 rounds of fp32 arithmetic in another order);
- refusal messages identical, character for character.
"""
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro
from repro import rpca as jrpca
from repro.core import APGMConfig as JAPGMConfig
from repro.core import DCFConfig as JDCFConfig
from repro.core import IALMConfig as JIALMConfig
from repro.core import generate_problem as jgenerate
from repro.core import metrics as jmetrics
from repro.core import ops as jops
from repro.core import runtime as jrt
import repro_torch
from repro_torch import convert, rpca
from repro_torch.core import (
    APGMConfig, DCFConfig, IALMConfig, RunConfig, apgm, ialm, metrics,
)
from repro_torch.core import ops as core_ops

# The modules, not the functions of the same names that the packages
# export.
papgm = importlib.import_module("repro_torch.core.apgm")
pdcf = importlib.import_module("repro_torch.core.dcf_pca")
pialm = importlib.import_module("repro_torch.core.ialm")
jcore = importlib.import_module("repro.core")
jialm = importlib.import_module("repro.core.ialm")
japgm = importlib.import_module("repro.core.apgm")
jdcf = importlib.import_module("repro.core.dcf_pca")

M, RANK, SPARSITY = 160, 8, 0.05
SOLVE_TOL = 1e-5
BARS = {"ialm": 1e-6, "apgm": 1e-5}
MODULES = {"ialm": (jialm, pialm, JIALMConfig, IALMConfig, 60),
           "apgm": (japgm, papgm, JAPGMConfig, APGMConfig, 200)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while this file runs: its small SVDs gain nothing
    from more, and beside JAX's CPU threads more made the solves up to 25x
    slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    return jgenerate(jax.random.PRNGKey(7), M, M, RANK, SPARSITY)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b) -> float:
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return (torch.linalg.norm(a - b) / torch.linalg.norm(b)).item()


def _both(method, m_obs, warm=None, mask=None, lam0=None, run=None,
          iters=None):
    """The reference's and the port's solve of the same reference problem:
    (L, S, stats) each."""
    jmod, pmod, jcfg_t, pcfg_t, default_iters = MODULES[method]
    iters = iters or default_iters
    jproblem = jmod._problem(m_obs, warm, mask, lam0)
    jrun = jrt.resolve_run(None if run is None else jrt.RunConfig(**run))
    solver = jmod.make_solver(jcfg_t(iters=iters))
    carry, jstats = jrt.run(solver, jproblem, iters, jrun)
    jl, js = solver.finalize(jproblem, carry)
    port = pmod.solve_problem(convert.problem_from_reference(jproblem, "cpu"),
                              pcfg_t(iters=iters),
                              None if run is None else RunConfig(**run))
    return (jl, js, jstats), (port.l, port.s, port.stats)


_FULL: dict = {}


def _port_full(method, problem):
    """The port's fixed-schedule solve (60 IALM / 200 APGM iterations) of
    the reference's problem, once a module."""
    if method not in _FULL:
        jmod, pmod, _, pcfg_t, iters = MODULES[method]
        port = convert.problem_from_reference(
            jmod._problem(problem.m_obs, None), "cpu")
        _FULL[method] = pmod.solve_problem(port, pcfg_t(iters=iters))
    return _FULL[method]


#: Iterations of the parity runs against the reference (fewer than the
#: recovery runs: the two trajectories are compared step for step).
PARITY_ITERS = 30


@pytest.mark.parametrize("case", ["plain", "warm", "lam0"])
@pytest.mark.parametrize("method", ["ialm", "apgm"])
def test_convex_solvers_match_the_reference(problem, method, case):
    """IALM and APGM from the reference's problem, cold, from a warm
    (L, S) and with a ``lam0`` operand: L, S and the objective trace of
    30 iterations within 1e-5 of the reference's."""
    warm = lam0 = None
    if case == "warm":
        warm = (0.5 * problem.l0, jnp.zeros_like(problem.m_obs))
    elif case == "lam0":
        lam0 = jnp.asarray(0.07, jnp.float32)
    (jl, js, jstats), (pl, ps, pstats) = _both(
        method, problem.m_obs, warm=warm, lam0=lam0, iters=PARITY_ITERS)
    assert _rel(pl, jl) <= SOLVE_TOL and _rel(ps, js) <= SOLVE_TOL
    np.testing.assert_allclose(pstats.objective.numpy(),
                               np.asarray(jstats.objective), rtol=SOLVE_TOL)


@pytest.mark.parametrize("method", ["ialm", "apgm"])
def test_convex_solvers_meet_the_reference_bars(problem, method):
    """IALM (60 iterations) and APGM (200) on the reference's problem meet
    the reference's recovery bars (tests/test_rpca_core.py:38-45)."""
    res = _port_full(method, problem)
    err = metrics.relative_error(res.l, res.s, _t(problem.l0), _t(problem.s0))
    assert float(err) < BARS[method]


def test_front_door_solves_match_the_legacy_entry_points(problem):
    """rpca.solve(method=...) and the ialm()/apgm() shims give the same
    bits, and the registry's adapters take fp32 data on the CPU."""
    m = _t(problem.m_obs)
    for method, fn, cfg in (("ialm", ialm, IALMConfig(iters=30)),
                            ("apgm", apgm, APGMConfig(iters=30))):
        res = rpca.solve(m, method=method, cfg=cfg, device="cpu")
        legacy = fn(m, cfg, device="cpu")
        assert res.method == method and res.factors is None
        assert torch.equal(res.l, legacy.l) and torch.equal(res.s, legacy.s)
        assert torch.equal(res.history, legacy.history)


def test_masked_apgm_completion():
    """tests/test_masked.py::test_masked_apgm_completion on the port: the
    reference's problem, observed completion error < 5e-2, and the
    reference's L within 1e-5."""
    p = jgenerate(jax.random.PRNGKey(3), 80, 80, 3, 0.05, observed_frac=0.8)
    (jl, js, _), (pl, ps, _) = _both("apgm", p.m_obs, mask=p.mask,
                                     iters=150)
    err = metrics.completion_errors(pl, _t(p.l0), _t(p.mask))
    assert float(err.observed) < 5e-2
    assert _rel(pl, jl) <= SOLVE_TOL and _rel(ps, js) <= SOLVE_TOL


def test_ialm_mask_constrains_observed_only():
    """tests/test_masked.py::test_ialm_mask_constrains_observed_only on the
    port: the constraint residual on Omega < 1e-5 of ||M||, S exactly 0 off
    the mask, and the reference's L and S within 1e-5."""
    p = jgenerate(jax.random.PRNGKey(4), 64, 64, 3, 0.05, observed_frac=0.7)
    (jl, js, _), (pl, ps, _) = _both("ialm", p.m_obs, mask=p.mask, iters=40)
    m_obs, mask = _t(p.m_obs), _t(p.mask)
    resid = mask * (m_obs - pl - ps)
    assert (torch.linalg.norm(resid) / torch.linalg.norm(m_obs)).item() < 1e-5
    assert ((1.0 - mask) * ps).abs().max().item() == 0.0
    assert _rel(pl, jl) <= SOLVE_TOL and _rel(ps, js) <= SOLVE_TOL
    # The front door zero-fills hidden entries, whatever the caller stored.
    dirty = torch.where(mask > 0, m_obs, torch.full_like(m_obs, 1e6))
    res = rpca.solve(dirty, method="ialm", cfg=IALMConfig(iters=40),
                     mask=mask, device="cpu")
    assert torch.equal(res.l, pl) and torch.equal(res.s, ps)


@pytest.mark.parametrize("method,run", [
    ("ialm", dict(mode="while", tol=1e-7)),
    ("apgm", dict(mode="chunk", tol=1e-7, chunk_size=16)),
])
def test_early_modes_match_fixed(problem, method, run):
    """tests/test_runtime.py:56-80 on the port: while (IALM) and chunk
    (APGM) stop early, converged, at the fixed run's quality, and their
    objective trace is the fixed run's, bit for bit, up to the stop (zero
    after).  (The fixed trace itself is held to the reference's by
    test_convex_solvers_match_the_reference.)"""
    _, pmod, _, pcfg_t, iters = MODULES[method]
    jproblem = MODULES[method][0]._problem(problem.m_obs, None)
    early = pmod.solve_problem(convert.problem_from_reference(jproblem,
                                                              "cpu"),
                               pcfg_t(iters=iters), RunConfig(**run))
    fixed = _port_full(method, problem)
    rounds = int(early.stats.rounds)
    assert rounds < iters and bool(early.stats.converged)
    l0, s0 = _t(problem.l0), _t(problem.s0)
    e_early = float(metrics.relative_error(early.l, early.s, l0, s0))
    e_fixed = float(metrics.relative_error(fixed.l, fixed.s, l0, s0))
    assert e_early < (1e-10 if method == "ialm" else 1e-8)
    if method == "ialm":
        assert abs(e_early - e_fixed) < 1e-10
    assert torch.equal(early.stats.objective[:rounds],
                       fixed.stats.objective[:rounds])
    assert (early.stats.objective[rounds:] == 0).all()


def test_apgm_full_relaxed_objective(problem):
    """tests/test_runtime.py:83-101 on the port: the last objective is
    mu_bar (||L||_* + lam ||S||_1) + 1/2 ||L + S - M||^2, and it fell."""
    cfg = APGMConfig(iters=200)
    m = _t(problem.m_obs)
    r = _port_full("apgm", problem)
    mu_bar = cfg.mu_bar_scale * cfg.mu_scale * torch.linalg.matrix_norm(
        m, ord=2)
    lam = 1.0 / M ** 0.5
    sv = torch.linalg.svdvals(r.l)
    want = mu_bar * (sv.sum() + lam * r.s.abs().sum()) + 0.5 * (
        (r.l + r.s - m) ** 2).sum()
    np.testing.assert_allclose(float(r.stats.objective[-1]), float(want),
                               rtol=1e-4)
    assert float(r.stats.objective[-1]) < float(r.stats.objective[0])


def test_ialm_zero_matrix_stays_finite():
    """The zero-matrix guard: an all-zero M solves to L = S = 0, no NaN."""
    res = rpca.solve(torch.zeros(12, 10), method="ialm",
                     cfg=IALMConfig(iters=5), device="cpu")
    assert torch.equal(res.l, torch.zeros(12, 10))
    assert torch.equal(res.s, torch.zeros(12, 10))


def test_svt_and_table1_metrics_match_the_reference(problem):
    """svt, singular_value_error and rank_gap on the same L."""
    x = np.asarray(problem.m_obs)
    want, sv_want = jops.svt(jnp.asarray(x), 40.0)
    got, sv = core_ops.svt(torch.from_numpy(x), 40.0)
    assert _rel(got, want) <= 1e-5 and _rel(sv, sv_want) <= 1e-5
    noisy = np.asarray(problem.l0) + 1e-3 * np.asarray(
        jax.random.normal(jax.random.PRNGKey(1), problem.l0.shape))
    l, l0 = torch.from_numpy(noisy), _t(problem.l0)
    for port, ref in (
            (metrics.singular_value_error(l, l0, RANK),
             jmetrics.singular_value_error(jnp.asarray(noisy), problem.l0,
                                           RANK)),
            (metrics.rank_gap(l, RANK),
             jmetrics.rank_gap(jnp.asarray(noisy), RANK))):
        # sigma_{r+1} is noise-level: fp32 resolves it to ~eps sigma_1.
        np.testing.assert_allclose(float(port), float(ref), rtol=1e-5,
                                   atol=1e-6)


def test_table1_n200_matches_the_reference():
    """benchmarks/table1_upper_rank.py at n = 200 (r = 10, p = 20, E = 10):
    the port's DCF solve from the reference's problem (factors included)
    gives a singular-value error within 1e-4 of the reference's."""
    n, r, clients = 200, 10, 10
    p = jgenerate(jax.random.PRNGKey(0), n, n, r, 0.05)
    cfg = JDCFConfig.tuned(2 * r)
    jproblem = jdcf.make_problem(p.m_obs, cfg, clients,
                                 jax.random.PRNGKey(0))
    want = jcore.dcf_pca(p.m_obs, cfg, num_clients=clients)
    port = pdcf.solve_problem(convert.problem_from_reference(jproblem, "cpu"),
                              convert.config_from_reference(cfg), n=n)
    got = float(metrics.singular_value_error(port.l, _t(p.l0), r))
    ref = float(jmetrics.singular_value_error(want.l, p.l0, r))
    assert abs(got - ref) <= 1e-4, (got, ref)
    np.testing.assert_allclose(float(metrics.rank_gap(port.l, r)),
                               float(jmetrics.rank_gap(want.l, r)),
                               rtol=1e-2, atol=1e-6)


# ---------------------------------------------------------------------------
# The registry and its refusals
# ---------------------------------------------------------------------------
CAPS = [f for f in jrpca.SolverCaps.__dataclass_fields__]


@pytest.mark.parametrize("flag", CAPS)
def test_methods_with_matches_the_reference(flag):
    assert rpca.methods_with(flag) == jrpca.methods_with(flag)


def test_registry_caps_match_the_reference():
    assert sorted(rpca.SOLVERS) == sorted(jrpca.SOLVERS)
    for name in jrpca.SOLVERS:
        want = jrpca.get_solver(name).caps
        got = rpca.get_solver(name).caps
        assert {f: getattr(got, f) for f in CAPS} == \
            {f: getattr(want, f) for f in CAPS}
        # The slot service's and the compile cache's hooks where the
        # reference registers them.
        assert (rpca.get_solver(name).service is None) == \
            (jrpca.get_solver(name).service is None)
        assert (rpca.get_solver(name).aot is None) == \
            (jrpca.get_solver(name).aot is None)


class _Mesh:
    """A stand-in device mesh: the refusals only ask whether there is one
    (and, for a sharded method, on how many processes it lives)."""

    devices = np.array([type("D", (), {"process_index": 0})()])


REFUSALS = {
    # name: (method, spec kwargs, cfg maker or None)
    "apgm_participation": ("apgm", {"participation": 0.5}, None),
    "ialm_clients": ("ialm", {"num_clients": 8}, None),
    "ialm_mesh": ("ialm", {"mesh": _Mesh()}, None),
    "ialm_faults": ("ialm", {"faults": np.zeros((3, 2), np.int32)}, None),
    "apgm_bf16": ("apgm", {"dtype": "bf16"}, None),
    "ialm_robust_agg": ("ialm", {}, "trimmed"),
    "dcf_sharded_no_mesh": ("dcf_sharded", {"rank": 3}, None),
    "unknown": ("svd3000", {}, None),
    "dcf_no_clients": ("dcf", {"rank": 3}, None),
    "cf_no_rank": ("cf", {}, None),
    "dcf_no_rank": ("dcf", {"num_clients": 2}, None),
    "cf_wrong_cfg": ("cf", {}, "apgm"),
    "apgm_wrong_cfg": ("apgm", {}, "ialm"),
    "ialm_wrong_cfg": ("ialm", {}, "dcf"),
    "cf_clients": ("cf", {"num_clients": 2}, "dcf"),
    "apgm_warm_shape": ("apgm", {"warm": "bad"}, None),
    "ialm_warm_pair": ("ialm", {"warm": "single"}, None),
}


def _cfgs(which):
    return {
        None: (None, None),
        "apgm": (JAPGMConfig(), APGMConfig()),
        "ialm": (JIALMConfig(), IALMConfig()),
        "dcf": (JDCFConfig.tuned(3), DCFConfig.tuned(3)),
        "trimmed": (JDCFConfig.tuned(3, aggregator="trimmed_mean"),
                    DCFConfig.tuned(3, aggregator="trimmed_mean")),
    }[which]


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_read_as_the_reference(case):
    """Every _check_caps refusal and require_* message of
    tests/test_api.py:195-247 that the port can reach, word for word."""
    method, kw, which = REFUSALS[case]
    jcfg, pcfg = _cfgs(which)
    m = np.zeros((12, 10), np.float32)
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("dtype") == "bf16":
        jkw["dtype"], pkw["dtype"] = jnp.bfloat16, torch.bfloat16
    if kw.get("warm") == "bad":
        jkw["warm"] = (jnp.zeros((12, 9)), jnp.zeros((12, 9)))
        pkw["warm"] = (torch.zeros(12, 9), torch.zeros(12, 9))
    if kw.get("warm") == "single":
        jkw["warm"], pkw["warm"] = jnp.zeros((12, 10)), torch.zeros(12, 10)
    if "mesh" in kw:
        jkw["mesh"] = jax.sharding.Mesh(np.array(jax.devices()[:1]),
                                        ("data",))
    with pytest.raises(ValueError) as want:
        jrpca.solve(jnp.asarray(m), method=method, cfg=jcfg, **jkw)
    with pytest.raises(ValueError) as got:
        rpca.solve(torch.from_numpy(m), method=method, cfg=pcfg,
                   device="cpu", **pkw)
    assert str(got.value) == str(want.value)


def test_dcf_sharded_waits_for_its_slice():
    """The sharded engine has landed (tests/test_torch_sharded.py): with a
    mesh, auto picks "dcf_sharded" as the reference does, and the engine
    refuses what it does not take before any process group is touched (a
    bit-packed mask, in the reference's words)."""
    spec = rpca.RPCASpec(torch.zeros(12, 10), rank=3, mesh=_Mesh(),
                         mask=torch.ones(12, 10))
    assert rpca.auto_method(spec) == "dcf_sharded"
    with pytest.raises(ValueError, match="cfg.pack_mask is not supported "
                       "by the sharded engine"):
        rpca.solve(spec, cfg=DCFConfig.masked(3, pack_mask=True),
                   device="cpu")


def test_compile_policy_waits_for_its_slice():
    """The compile cache has landed: ``compile_policy="aot"`` solves
    through it (cache counters on the result) instead of raising."""
    res = rpca.solve(torch.zeros(12, 10), method="ialm",
                     compile_policy="aot", device="cpu")
    assert res.cache_stats is not None and res.l.shape == (12, 10)
    assert bool(torch.isfinite(res.l).all())


def test_solve_with_no_rank_runs_ialm(problem):
    """tests/test_api.py::test_auto_small_problem_is_convex on the port:
    solve(m) picks "ialm", as the reference does, and recovers."""
    m = _t(problem.m_obs)
    assert rpca.auto_method(rpca.RPCASpec(m)) == "ialm"
    res = rpca.solve(m, device="cpu")
    assert res.method == "ialm" and res.u is None
    err = metrics.relative_error(res.l, res.s, _t(problem.l0),
                                 _t(problem.s0))
    assert float(err) < BARS["ialm"]


#: The reference's exports that the port does not have yet, each named in
#: ROADMAP.md's Queue 1 (none since the sharded engine landed).
UNPORTED = {
    "repro": set(),
    "repro.core": set(),
    "repro.rpca": set(),
}


@pytest.mark.parametrize("ref,port", [(repro, repro_torch),
                                      (jcore, importlib.import_module(
                                          "repro_torch.core")),
                                      (jrpca, rpca)],
                         ids=["repro", "repro.core", "repro.rpca"])
def test_exports_are_the_reference_minus_the_unported(ref, port):
    unported = UNPORTED[ref.__name__]
    assert set(port.__all__) == set(ref.__all__) - unported
    for name in port.__all__:
        assert hasattr(port, name), name
    roadmap = (Path(__file__).resolve().parent.parent
               / "ROADMAP.md").read_text()
    for name in unported:
        assert name in roadmap, name


# ---------------------------------------------------------------------------
# core/validate.py and core/ops.py helpers against the reference
# ---------------------------------------------------------------------------
def _ns(**kw):
    from types import SimpleNamespace

    return SimpleNamespace(**kw)


VALIDATE_CASES = {
    "solver_diverged": ("solver_diverged", ("tenant 3", 12)),
    "solver_diverged_no_rounds": ("solver_diverged", ("lane 0",)),
    "service_at_capacity": ("service_at_capacity", (8,)),
    "gateway_queue_full": ("gateway_queue_full", (5, 5)),
    "gateway_pool_full": ("gateway_queue_full", (1, 2, "staging pool")),
    "warm_lowrank_sparse": ("check_warm_lowrank_sparse",
                            ((np.zeros((4, 3)), np.zeros((4, 3))), (4, 5))),
    "policy_bucket_min": ("check_compile_policy", (0, 2.0, 1, None)),
    "policy_ratio": ("check_compile_policy", (1, 1.0, 1, None)),
    "policy_entries": ("check_compile_policy", (1, 2.0, 0, None)),
    "policy_bytes": ("check_compile_policy", (1, 2.0, 1, 0)),
    "unknown_policy": ("unknown_compile_policy", ("fast",)),
    "compress_no_frac": ("check_consensus_cfg", (_ns(
        consensus_compress=_ns(topk_frac=None)),)),
    "compress_frac": ("check_consensus_cfg", (_ns(
        consensus_compress=_ns(topk_frac=2.0)),)),
    "delay": ("check_consensus_cfg", (_ns(consensus_delay=2),)),
    "delay_participation": ("check_consensus_cfg",
                            (_ns(consensus_delay=1), 0.5)),
    "stale_guard": ("check_consensus_cfg",
                    (_ns(consensus_delay=1, stale_guard=0.5),)),
    "aggregator": ("check_consensus_cfg", (_ns(aggregator="vote"),)),
    "trim_frac": ("check_consensus_cfg",
                  (_ns(aggregator="trimmed_mean", trim_frac=0.6),)),
    "screen": ("check_consensus_cfg", (_ns(divergence_screen=0.5),)),
    "screen_compress": ("check_consensus_cfg", (_ns(
        divergence_screen=2.0, consensus_compress=_ns(topk_frac=0.5)),)),
    "fault_shape": ("check_fault_plan",
                    (_ns(), np.zeros((3, 2), np.int32), 4)),
    "fault_delay_crash": ("check_fault_plan",
                          (_ns(consensus_delay=1),
                           np.array([[0, 1], [0, 0]], np.int32), 2)),
    "service_rows": ("check_service_problem", (np.zeros((3, 4)), 5, 8)),
    "service_ndim": ("check_service_problem", (np.zeros(5), 5, 8)),
    "service_width": ("check_service_problem", (np.zeros((5, 9)), 5, 8)),
}


def _outcome(fn, args):
    """(exception class name, message) of a call that raises, or of a
    returned exception; the return value otherwise."""
    try:
        out = fn(*args)
    except Exception as exc:  # the message under test
        return type(exc).__name__, str(exc)
    if isinstance(out, Exception):
        return type(out).__name__, str(out)
    return out


@pytest.mark.parametrize("case", sorted(VALIDATE_CASES))
def test_validate_helpers_read_as_the_reference(case):
    """Each ported core/validate.py helper raises (or returns) the
    reference's exception class with its message, word for word."""
    from repro.core import validate as jval
    from repro_torch.core import validate as pval

    name, args = VALIDATE_CASES[case]
    want = _outcome(getattr(jval, name), args)
    assert isinstance(want, tuple), want
    assert _outcome(getattr(pval, name), args) == want


def test_validate_helpers_pass_what_the_reference_passes():
    from repro.core import validate as jval
    from repro_torch.core import validate as pval

    for mod in (jval, pval):
        mod.check_compile_policy(8, 1.5, 4, None)
        mod.check_consensus_cfg(_ns(aggregator="trimmed_mean",
                                    trim_frac=0.25))
        mod.check_fault_plan(_ns(), np.zeros((3, 2), np.int32), 2)
        assert mod.check_service_problem(np.zeros((5, 3)), 5, 8) == 3
    assert issubclass(pval.QueueFull, pval.CapacityError)
    assert issubclass(pval.CapacityError, RuntimeError)
    assert issubclass(pval.SolverDiverged, RuntimeError)
    assert not issubclass(pval.SolverDiverged, (ValueError,
                                                pval.CapacityError))


def test_spectral_norm_ub_matches_the_reference():
    u = np.random.default_rng(0).standard_normal((50, 6)).astype(np.float32)
    np.testing.assert_allclose(
        float(core_ops.spectral_norm_ub(torch.from_numpy(u))),
        float(jops.spectral_norm_ub(jnp.asarray(u))), rtol=1e-5)


def reference_numbers(n: int = 1000) -> dict:
    """Not a test: the JAX reference's own numbers at n = 1000 that
    chip_smoke.py's table1 and convex phases are held against (the
    reference's generator and seed 0): Table 1's singular-value error at
    p = 2r (benchmarks/table1_upper_rank.py), and IALM's and APGM's
    recovery errors with Fig. 1's problem (r = n / 20, 5%).  Run this file
    as a script (a few minutes on the CPU):

        PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_convex.py
    """
    import json
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmarks.table1_upper_rank import run

    p = jgenerate(jax.random.PRNGKey(0), n, n, n // 20, 0.05)
    out = {"table1": run(sizes=(n,))}
    for name, fn, cfg in (("ialm", jcore.ialm, JIALMConfig(iters=60)),
                          ("apgm", jcore.apgm, JAPGMConfig(iters=200))):
        r = fn(p.m_obs, cfg)
        out[name] = float(jcore.relative_error(r.l, r.s, p.l0, p.s0))
    return json.loads(json.dumps(out))


if __name__ == "__main__":
    print(reference_numbers())
