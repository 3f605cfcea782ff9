"""Whole solves of the port against the JAX reference, on the CPU, and the
rules of the port.

The problem is the reference's 160 x 160, rank-8, 5%-corruption instance
(tests/test_rpca_core.py:18-26); the reference builds each solver problem
(initial factors included) and ``repro_torch.convert`` carries it across,
because ``jax.random`` and ``torch.Generator`` give different numbers.
Bars: relative error (Eq. 30) < 1e-4, as tests/test_rpca_core.py:58; the
consensus U after 5 rounds within 1e-4 relative of the reference's (fp32
arithmetic in another order, compounded over 5 rounds).
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import DCFConfig as JConfig
from repro.core import generate_problem as jgenerate
from repro.core import runtime as jrt
from repro_torch import convert, rpca
from repro_torch.core import cf_pca, dcf_pca, metrics
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig

jcf = importlib.import_module("repro.core.cf_pca")
jdcf = importlib.import_module("repro.core.dcf_pca")

ROOT = Path(__file__).resolve().parent.parent
M, RANK, SPARSITY = 160, 8, 0.05


@pytest.fixture(scope="module")
def problem():
    return jgenerate(jax.random.PRNGKey(7), M, M, RANK, SPARSITY)


def _err(res, p, n=M):
    l0 = torch.from_numpy(np.array(p.l0[:, :n]))
    s0 = torch.from_numpy(np.array(p.s0[:, :n]))
    return float(metrics.relative_error(res.l, res.s, l0, s0))


def _ref_problem(p, cfg, clients, n=M):
    m_obs = p.m_obs[:, :n]
    if clients is None:
        return jcf.make_problem(m_obs, cfg, jax.random.PRNGKey(0))
    return jdcf.make_problem(m_obs, cfg, clients, jax.random.PRNGKey(0))


@pytest.mark.parametrize("clients,n", [(None, 160), (8, 160), (8, 157)])
def test_solve_recovers_from_reference_factors(problem, clients, n):
    """cf_pca, dcf_pca (E=8) and ragged dcf_pca (n=157) reach < 1e-4."""
    cfg = JConfig.tuned(RANK)
    port = convert.problem_from_reference(
        _ref_problem(problem, cfg, clients, n), "cpu")
    module = cf_pca if clients is None else dcf_pca
    kw = {} if clients is None else {"n": n}
    res = module.solve_problem(port, convert.config_from_reference(cfg), **kw)
    assert res.l.shape == (M, n) and res.s.shape == (M, n)
    assert _err(res, problem, n) < 1e-4


@pytest.mark.parametrize("clients", [None, 8])
def test_five_rounds_track_the_reference(problem, clients):
    cfg = JConfig.tuned(RANK, outer_iters=5)
    ref_problem = _ref_problem(problem, cfg, clients)
    module = jcf if clients is None else jdcf
    carry, _ = jrt.run(module.make_solver(cfg), ref_problem, 5)
    port = convert.problem_from_reference(ref_problem, "cpu")
    mine = (cf_pca if clients is None else dcf_pca).solve_problem(
        port, convert.config_from_reference(cfg))
    want = np.asarray(carry.u)
    diff = np.linalg.norm(mine.u.numpy() - want) / np.linalg.norm(want)
    assert diff < 1e-4


@pytest.mark.parametrize("run", [jrt.RunConfig(mode="while", tol=1e-3),
                                 jrt.RunConfig(mode="chunk", tol=1e-3,
                                               chunk_size=4),
                                 jrt.RunConfig(mode="scan",
                                               criterion="obj_plateau")])
def test_run_modes_and_objective_match_reference(problem, run):
    """Early exit stops at the reference's round, and the tracked objective
    (from the U-step epilogue) follows the reference's trace (rtol 1e-4:
    a sum over every entry, 40 rounds of fp32 drift)."""
    cfg = JConfig.tuned(RANK, outer_iters=40, track_objective=True)
    ref_problem = _ref_problem(problem, cfg, 8)
    _, want = jrt.run(jdcf.make_solver(cfg), ref_problem, cfg.outer_iters,
                      run)
    port_run = rt.RunConfig(**{f: getattr(run, f) for f in
                               ("mode", "tol", "criterion", "chunk_size",
                                "min_iters")})
    got = dcf_pca.solve_problem(
        convert.problem_from_reference(ref_problem, "cpu"),
        convert.config_from_reference(cfg), port_run).stats
    assert int(got.rounds) == int(want.rounds)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(got.objective.numpy(), np.asarray(want.objective),
                               rtol=1e-4)


def test_port_generator_statistics():
    """Sec. 4.1 generator: s m n corruptions of magnitude sqrt(m n), rank r
    (the checks of tests/test_rpca_core.py:29-35)."""
    p = prob.generate_problem(3, M, M, RANK, SPARSITY, device="cpu")
    nnz = int((p.s0 != 0).sum())
    assert abs(nnz - SPARSITY * M * M) <= 1
    mags = p.s0[p.s0 != 0].abs()
    assert torch.allclose(mags, torch.full_like(mags, float(M)))
    assert int(torch.linalg.matrix_rank(p.l0)) == RANK
    assert torch.equal(p.m_obs, p.l0 + p.s0)


def test_front_door_on_the_cpu():
    """rpca.solve with the port's own seed and generator, on the CPU."""
    p = prob.generate_problem(7, M, M, RANK, SPARSITY, device="cpu")
    res = rpca.solve(p.m_obs, method="dcf", cfg=DCFConfig.tuned(RANK),
                     num_clients=8, device="cpu")
    assert res.method == "dcf" and res.v.shape == (8, M // 8, RANK)
    assert float(metrics.relative_error(res.l, res.s, p.l0, p.s0)) < 1e-4
    auto = rpca.solve(p.m_obs, rank=RANK, device="cpu")
    assert auto.method == "cf" and auto.factors[0].shape == (M, RANK)


@pytest.mark.parametrize("what", ["participation", "faults", "dual", "pack",
                                  "compress", "trimmed", "batched", "bf16",
                                  "ialm"])
def test_later_slices_raise_before_solving(what):
    m = torch.zeros(8, 8)
    cfg = DCFConfig.tuned(2)
    kw = {"num_clients": 2}
    if what == "participation":
        kw["participation"] = 0.5
    elif what == "faults":
        kw["faults"] = np.zeros((3, 2), np.int32)
    elif what == "dual":
        cfg = DCFConfig.tuned(2, fused="dual")
    elif what == "pack":
        cfg = DCFConfig.tuned(2, pack_mask=True)
    elif what == "compress":
        cfg = DCFConfig.tuned(2, consensus_delay=1)
    elif what == "trimmed":
        cfg = DCFConfig.tuned(2, aggregator="trimmed_mean")
    elif what == "batched":
        m = torch.zeros(2, 8, 8)
    elif what == "bf16":
        m = m.to(torch.bfloat16)
    method = "ialm" if what == "ialm" else "dcf"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rpca.solve(m, method=method, cfg=cfg, device="cpu", **kw)


def test_entry_points_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = torch.zeros(8, 8)
    for call in (lambda: rpca.solve(m, rank=2),
                 lambda: dcf_pca.dcf_pca(m, DCFConfig.tuned(2), 2),
                 lambda: cf_pca.cf_pca(m, DCFConfig.tuned(2)),
                 lambda: prob.generate_problem(0, 8, 8, 2, 0.05)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py's imports, load without
    JAX or the reference package."""
    names = sorted(
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name.removesuffix('.__init__'))\n"
        "import chip_smoke\n"
        "print(json.dumps(sorted(m for m in sys.modules if m == 'jax'\n"
        "    or m.startswith(('jax.', 'jaxlib')) or m == 'repro'\n"
        "    or m.startswith('repro.'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert json.loads(out.stdout) == []
    assert len(names) >= 16
