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
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DCFConfig as JConfig
from repro.core import generate_problem as jgenerate
from repro.core import completion_errors as jcompletion
from repro.core import runtime as jrt
from repro import rpca as jrpca
from repro_torch import convert, rpca
from repro_torch.core import metrics
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig

# The modules, not the functions of the same names that repro_torch.core
# exports (as repro.core does).
cf_pca = importlib.import_module("repro_torch.core.cf_pca")
dcf_pca = importlib.import_module("repro_torch.core.dcf_pca")
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


@pytest.fixture(scope="module")
def masked_problem():
    return jgenerate(jax.random.PRNGKey(7), M, M, RANK, SPARSITY,
                     observed_frac=0.8)


# name -> (clients, n, DCFConfig overrides, bf16 data): the dual round with
# a dense mask (equal and ragged blocks), the off round, and the compact
# plane (bf16 M, packed mask, sampled threshold).
MASKED_CASES = {
    "dual": (8, M, dict(fused="dual"), False),
    "dual_ragged": (8, 157, dict(fused="dual"), False),
    "off_cf": (None, M, dict(fused="off"), False),
    "compact": (8, M, dict(fused="dual", pack_mask=True, lam_sample=4096),
                True),
    "compact_cf": (None, M, dict(pack_mask=True), True),
}


@pytest.mark.parametrize("case", sorted(MASKED_CASES))
def test_masked_rounds_track_the_reference(masked_problem, case):
    """Five rounds of each masked flavour from the reference's problem
    (carried across with its bf16 blocks and packed mask as they are)
    end at the reference's consensus U within 1e-4."""
    clients, n, overrides, bf16 = MASKED_CASES[case]
    cfg = JConfig.masked(RANK, observed_frac=0.8, outer_iters=5, **overrides)
    m_obs, mask = masked_problem.m_obs[:, :n], masked_problem.mask[:, :n]
    if bf16:
        m_obs = m_obs.astype(jax.numpy.bfloat16)
    if clients is None:
        ref_problem = jcf.make_problem(m_obs, cfg, jax.random.PRNGKey(0),
                                       mask=mask)
    else:
        ref_problem = jdcf.make_problem(m_obs, cfg, clients,
                                        jax.random.PRNGKey(0), mask=mask)
    module = jcf if clients is None else jdcf
    carry, _ = jrt.run(module.make_solver(cfg), ref_problem, 5)
    port = convert.problem_from_reference(ref_problem, "cpu")
    data = port.m_obs if clients is None else port.blocks
    assert data.dtype == (torch.bfloat16 if bf16 else torch.float32)
    assert port.mask.dtype == (torch.uint8 if cfg.pack_mask
                               else torch.float32)
    mine = (cf_pca if clients is None else dcf_pca).solve_problem(
        port, convert.config_from_reference(cfg),
        **({} if clients is None else {"n": n}))
    want = np.asarray(carry.u)
    diff = np.linalg.norm(mine.u.numpy() - want) / np.linalg.norm(want)
    assert diff < 1e-4
    assert mine.l.dtype == torch.float32 and mine.l.shape == (M, n)


# name -> (clients, n, masked, DCFConfig overrides): a float16 plane through
# cf and dcf, unmasked and masked (equal and ragged blocks, dense and
# bit-packed masks).
F16_CASES = {
    "cf": (None, M, False, {}),
    "dcf": (8, M, False, {}),
    "cf_masked": (None, M, True, {}),
    "dcf_masked": (8, M, True, dict(fused="dual")),
    "dcf_ragged_packed": (8, 157, True, dict(fused="dual", pack_mask=True,
                                             lam_sample=4096)),
}


@pytest.mark.parametrize("case", sorted(F16_CASES))
def test_float16_rounds_track_the_reference(problem, masked_problem, case):
    """Five rounds from the reference's problem of a float16 plane (the
    reference stores it as given and computes in fp32; the port carries
    it as fp32, where every float16 value is exact) end at the
    reference's consensus U within 1e-4."""
    clients, n, masked, overrides = F16_CASES[case]
    p = masked_problem if masked else problem
    cfg = (JConfig.masked(RANK, observed_frac=0.8, outer_iters=5,
                          **overrides) if masked
           else JConfig.tuned(RANK, outer_iters=5, **overrides))
    m_obs = p.m_obs[:, :n].astype(jnp.float16)
    mask = p.mask[:, :n] if masked else None
    if clients is None:
        ref_problem = jcf.make_problem(m_obs, cfg, jax.random.PRNGKey(0),
                                       mask=mask)
    else:
        ref_problem = jdcf.make_problem(m_obs, cfg, clients,
                                        jax.random.PRNGKey(0), mask=mask)
    ref_data = ref_problem.m_obs if clients is None else ref_problem.blocks
    assert ref_data.dtype == jnp.float16
    carry, _ = jrt.run((jcf if clients is None else jdcf).make_solver(cfg),
                       ref_problem, 5)
    port = convert.problem_from_reference(ref_problem, "cpu")
    assert (port.m_obs if clients is None else port.blocks).dtype \
        == torch.float32
    mine = (cf_pca if clients is None else dcf_pca).solve_problem(
        port, convert.config_from_reference(cfg),
        **({} if clients is None else {"n": n}))
    want = np.asarray(carry.u)
    diff = np.linalg.norm(mine.u.numpy() - want) / np.linalg.norm(want)
    assert diff < 1e-4
    assert mine.l.dtype == torch.float32 and mine.l.shape == (M, n)


@pytest.fixture(scope="module")
def float16_plane():
    """ROADMAP Queue 3's plane: 96 x 80, r = 4, 5% spikes, in float16."""
    p = jgenerate(jax.random.PRNGKey(3), 96, 80, 4, SPARSITY)
    return np.asarray(p.m_obs).astype(np.float16), np.asarray(p.l0)


@pytest.mark.parametrize("method,kw", [("cf", {}),
                                       ("dcf", {"num_clients": 4})])
def test_float16_plane_through_the_front_door(float16_plane, method, kw):
    """``solve(RPCASpec(M_f16, rank=4))`` through cf and dcf: fp32 L
    within 1e-4 (relative, Frobenius) of the reference's L from the same
    float16 plane (both recover the low-rank part to ~3e-4; the two start
    from their own generators' factors), where the port used to raise."""
    m16, l0 = float16_plane
    jres = jrpca.solve(jrpca.RPCASpec(jnp.asarray(m16), rank=4, **kw),
                       method=method)
    res = rpca.solve(rpca.RPCASpec(torch.from_numpy(m16), rank=4, **kw),
                     method=method, device="cpu")
    want = np.asarray(jres.l)
    assert res.l.dtype == torch.float32 and res.l.shape == want.shape
    got = res.l.numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-4
    err = np.linalg.norm(got - l0) / np.linalg.norm(l0)
    assert err < 2 * np.linalg.norm(want - l0) / np.linalg.norm(l0)


def test_other_data_types_are_refused_by_name():
    """Integer data raises a TypeError naming the types the solvers take;
    float16 no longer raises."""
    plane = torch.ones(16, 12, dtype=torch.int32)
    with pytest.raises(TypeError, match="float16, bfloat16, float32"):
        rpca.solve(plane, method="cf", cfg=DCFConfig.tuned(2, outer_iters=2),
                   device="cpu")


def test_dual_masked_solve_recovers_like_the_reference(masked_problem):
    """A whole fused="dual" masked DCF solve from the reference's problem:
    observed completion error under the 1e-2 bar of
    benchmarks/masked_rpca_bench.py and equal to the reference's (rtol
    1e-3: fp32 sums in another order over 150 rounds)."""
    cfg = JConfig.masked(RANK, observed_frac=0.8, fused="dual",
                         outer_iters=150)
    p = masked_problem
    ref_problem = jdcf.make_problem(p.m_obs, cfg, 8, jax.random.PRNGKey(0),
                                    mask=p.mask)
    carry, _ = jrt.run(jdcf.make_solver(cfg), ref_problem, cfg.outer_iters)
    ref_l, _, _, _ = jdcf.make_solver(cfg).finalize(ref_problem, carry)
    want = float(jcompletion(ref_l, p.l0, p.mask).observed)
    res = dcf_pca.solve_problem(
        convert.problem_from_reference(ref_problem, "cpu"),
        convert.config_from_reference(cfg))
    got = float(metrics.completion_errors(
        res.l, torch.from_numpy(np.array(p.l0)),
        torch.from_numpy(np.array(p.mask))).observed)
    assert got < 1e-2
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("clients,n", [(None, 56), (4, 56), (4, 50)])
def test_packed_mask_solve_bit_exact_vs_dense(clients, n):
    """pack_mask stores the identical Omega, so whole solves are bit for
    bit the dense-mask solves: cf, dcf and ragged dcf (the padded split
    packs its all-ones base plane too)."""
    p = prob.generate_problem(3, 60, n, 3, 0.05, observed_frac=0.7,
                              device="cpu")
    kw = {} if clients is None else {"num_clients": clients}
    method = "cf" if clients is None else "dcf"
    res = [rpca.solve(p.m_obs, method=method, mask=p.mask, device="cpu",
                      run=rt.RunConfig(criterion="obj_plateau"),
                      cfg=DCFConfig(rank=3, outer_iters=8,
                                    track_objective=True, pack_mask=packed),
                      **kw)
           for packed in (False, True)]
    assert torch.equal(res[0].l, res[1].l) and torch.equal(res[0].s, res[1].s)
    assert torch.equal(res[0].stats.objective, res[1].stats.objective)


def test_bf16_data_plane_recovery_bound():
    """bf16 M storage: recovery error within 5x of the fp32 solve (or the
    bf16 floor of 2e-2), outputs fp32 (tests/test_masked.py:428-443)."""
    p = prob.generate_problem(0, 96, 96, 4, 0.05, device="cpu")
    cfg = DCFConfig.tuned(4, outer_iters=120)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        res = rpca.solve(p.m_obs.to(dtype), method="cf", cfg=cfg,
                         device="cpu")
        assert res.l.dtype == res.s.dtype == torch.float32
        errs.append(float(metrics.relative_error(res.l, res.s, p.l0, p.s0)))
    assert errs[1] < max(5.0 * errs[0], 2e-2), errs


def test_front_door_dtype_coercion():
    p = prob.generate_problem(2, 48, 48, 3, 0.05, device="cpu")
    res = rpca.solve(rpca.RPCASpec(p.m_obs, dtype=torch.bfloat16),
                     method="cf", cfg=DCFConfig.tuned(3, outer_iters=10),
                     device="cpu")
    assert res.spec.m_obs.dtype == torch.bfloat16
    assert res.l.dtype == torch.float32


@pytest.mark.parametrize("kind", ["uniform", "columns"])
def test_port_generate_mask_statistics(kind):
    """The port's masks (tests/test_masked.py's checks): the observed share
    near p for iid masks; one cyclic burst of round((1-p) m) hidden rows in
    every column for the column kind; masked problems zero the hidden
    entries of M and S0 and keep the mask fp32 beside a bf16 plane."""
    m, n, frac = 200, 150, 0.7
    w = prob.generate_mask(5, m, n, frac, kind)
    assert w.dtype == torch.float32 and set(w.unique().tolist()) <= {0.0, 1.0}
    if kind == "uniform":
        assert abs(float(w.mean()) - frac) < 0.01
    else:
        miss = round((1 - frac) * m)
        assert torch.all(w.sum(dim=0) == m - miss)
        # One contiguous (cyclic) run: a single 1 -> 0 step per column.
        steps = (w - torch.roll(w, 1, dims=0)) < 0
        assert torch.all(steps.sum(dim=0) == 1)
    p = prob.generate_problem(5, m, n, 4, 0.05, observed_frac=frac,
                              mask_kind=kind, dtype=torch.bfloat16,
                              device="cpu")
    full = prob.generate_problem(5, m, n, 4, 0.05, device="cpu")
    assert p.m_obs.dtype == p.l0.dtype == torch.bfloat16
    assert p.mask.dtype == torch.float32
    assert torch.equal(p.m_obs.float(), (p.mask * full.m_obs).to(
        torch.bfloat16).float())
    assert torch.all(p.s0[p.mask == 0] == 0)


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
    # "auto" follows the reference: a cfg with a rank pins "cf"; the rank
    # alone, at this size, picks the convex "ialm", which solves.
    auto = rpca.solve(p.m_obs, cfg=DCFConfig.tuned(RANK), device="cpu")
    assert auto.method == "cf" and auto.factors[0].shape == (M, RANK)
    convex = rpca.solve(p.m_obs, rank=RANK, device="cpu")
    assert convex.method == "ialm" and convex.factors is None
    assert float(metrics.relative_error(convex.l, convex.s, p.l0,
                                        p.s0)) < 1e-6


STILL_REFUSED = ["compile_policy", "dcf_sharded", "vlm_lm", "encdec_lm",
                 "batch_faults", "batch_checkpoint", "batch_resume"]


@pytest.mark.parametrize("what", STILL_REFUSED)
def test_what_still_refuses_before_solving(what):
    """What the port does not run refuses before anything starts: an
    unknown ``compile_policy`` raises the reference's ValueError, word for
    word, as does a batch given to the sharded engine; a language model
    whose family reads a context (vlm, encdec) refuses a prefill without
    one, and the serve launcher (which makes none) refuses it, with a
    ValueError naming the family, before any layer runs; a batch with a fault
    plan or a checkpoint raises the reference's ValueError, word for
    word."""
    from repro_torch import configs, models

    m, cfg = torch.zeros(2, 8, 8), DCFConfig.tuned(2)
    if what == "compile_policy":
        with pytest.raises(ValueError) as got:
            rpca.solve(m[0], method="ialm", compile_policy="jit",
                       device="cpu")
        with pytest.raises(ValueError) as want:
            jrpca.solve(jnp.zeros((8, 8)), method="ialm",
                        compile_policy="jit")
        assert str(got.value) == str(want.value)
        return
    if what == "dcf_sharded":
        with pytest.raises(ValueError) as want:
            jrpca.solve(jnp.zeros((2, 8, 8)), method="dcf_sharded",
                        cfg=JConfig.tuned(2), mesh=object())
        with pytest.raises(ValueError) as got:
            rpca.solve(m, method="dcf_sharded", cfg=cfg, mesh=object(),
                       device="cpu")
        assert str(got.value) == str(want.value)
        return
    if what.endswith("_lm"):
        from repro_torch.launch import serve

        arch = {"vlm_lm": "llama-3.2-vision-11b",
                "encdec_lm": "whisper-small"}[what]
        model = models.get_model(configs.get_smoke_config(arch))
        params = model.empty_params("meta")
        family = f"'{what[:-3]}' family"
        with pytest.raises(ValueError, match=family):
            model.prefill(params, torch.zeros(1, 4, dtype=torch.int32,
                                              device="meta"))
        with pytest.raises(ValueError, match=family):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
        return
    kw = {"batch_faults": {"faults": np.zeros((3, 2), np.int32)},
          "batch_checkpoint": {"checkpoint_dir": "unused"},
          "batch_resume": {"resume_from": "unused"}}[what]
    with pytest.raises(ValueError) as want:
        jrpca.solve(jnp.zeros((2, 8, 8)), method="dcf", num_clients=2,
                    cfg=JConfig.tuned(2), **kw)
    with pytest.raises(ValueError) as got:
        rpca.solve(m, method="dcf", num_clients=2, cfg=cfg, device="cpu",
                   **kw)
    assert str(got.value) == str(want.value)
    assert "batched solves" in str(got.value)


def _auto_specs(case):
    """The same problem as a reference spec and a port spec."""
    size, dtype, kw, with_cfg = {
        "160_rank8": (160, "f32", {"rank": 8}, False),
        "160_rank8_mask": (160, "f32", {"rank": 8, "mask": True}, False),
        "160_norank": (160, "f32", {}, False),
        "3000_rank150": (3000, "f32", {"rank": 150}, False),
        "3000_norank": (3000, "f32", {}, False),
        "bf16_rank8": (160, "bf16", {"rank": 8}, False),
        "bf16_norank": (160, "bf16", {}, False),
        "clients": (160, "f32", {"rank": 8, "num_clients": 4}, False),
        "participation": (160, "f32", {"rank": 8, "participation": 0.5},
                          False),
        "cfg_rank": (160, "f32", {}, True),
        "bf16_cfg_rank": (160, "bf16", {}, True),
    }[case]
    # Broadcast views: the shape and dtype of a full plane, no memory.
    base = np.broadcast_to(np.zeros((), np.float32), (size, size))
    mask = np.broadcast_to(np.ones((), np.float32), (size, size))
    jkw = {k: (mask if k == "mask" else v) for k, v in kw.items()}
    tkw = {k: (torch.ones(()).expand(size, size) if k == "mask" else v)
           for k, v in kw.items()}
    jm, tm = base, torch.zeros(()).expand(size, size)
    if dtype == "bf16":
        jm = jnp.zeros((size, size), jnp.bfloat16)
        tm = tm.to(torch.bfloat16)
    jcfg, tcfg = (JConfig.tuned(8), DCFConfig.tuned(8)) if with_cfg \
        else (None, None)
    return jrpca.RPCASpec(jm, **jkw), jcfg, rpca.RPCASpec(tm, **tkw), tcfg


AUTO_CASES = ["160_rank8", "160_rank8_mask", "160_norank", "3000_rank150",
              "3000_norank", "bf16_rank8", "bf16_norank", "clients",
              "participation", "cfg_rank", "bf16_cfg_rank"]


@pytest.mark.parametrize("case", AUTO_CASES)
def test_auto_method_follows_the_reference(case):
    """repro_torch.rpca.auto_method picks the reference's method, or raises
    the reference's error with its text."""
    jspec, jcfg, tspec, tcfg = _auto_specs(case)
    try:
        want = jrpca.auto_method(jspec, jcfg)
    except ValueError as exc:
        with pytest.raises(ValueError) as got:
            rpca.auto_method(tspec, tcfg)
        assert str(got.value) == str(exc)
        return
    assert rpca.auto_method(tspec, tcfg) == want


def test_auto_refuses_unported_methods_before_solving(monkeypatch):
    """method="auto" with a device mesh picks "dcf_sharded", as the
    reference does; every method is ported now, and what the sharded
    engine does not take is refused before any solve starts: no rank, in
    the reference's words, and a bit-packed mask."""
    def no_solve(*a, **k):
        raise AssertionError("a solve started")

    monkeypatch.setattr(cf_pca, "cf_pca", no_solve)
    monkeypatch.setattr(dcf_pca, "dcf_pca", no_solve)
    monkeypatch.setattr(dcf_pca, "solve_sharded_problem", no_solve)
    m = torch.zeros(M, M)
    spec = rpca.RPCASpec(m, mesh=object())
    assert rpca.auto_method(spec) == "dcf_sharded"
    with pytest.raises(ValueError) as got:
        rpca.solve(spec, device="cpu")
    with pytest.raises(ValueError) as want:
        jrpca.solve(jnp.zeros((M, M)), mesh=object())
    assert str(got.value) == str(want.value)
    spec = rpca.RPCASpec(m, mesh=object(), rank=RANK, mask=torch.ones(M, M))
    assert rpca.auto_method(spec) == "dcf_sharded"
    with pytest.raises(ValueError, match="pack_mask is not supported by "
                       "the sharded engine"):
        rpca.solve(spec, cfg=DCFConfig.masked(RANK, pack_mask=True),
                   device="cpu")


@pytest.mark.parametrize("what", ["num_clients", "participation", "faults"])
def test_cf_refusals_read_as_the_reference(what):
    """Where the port and the reference refuse the same "cf" case, they say
    the same words (the reference's ``_unsupported``)."""
    value = {"num_clients": 2, "participation": 0.5,
             "faults": np.zeros((3, 2), np.int32)}[what]
    m = np.zeros((8, 8), np.float32)
    with pytest.raises(ValueError) as want:
        jrpca.solve(jnp.asarray(m), method="cf", cfg=JConfig.tuned(2),
                    **{what: value})
    with pytest.raises(ValueError) as got:
        rpca.solve(torch.zeros(8, 8), method="cf", cfg=DCFConfig.tuned(2),
                   device="cpu", **{what: value})
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg,refused", [
    (DCFConfig.tuned(257), False),
    (DCFConfig.tuned(8, impl="pallas"), True),
    (DCFConfig.tuned(256), False),
    (DCFConfig.tuned(257, impl="ref"), False),
    (DCFConfig.tuned(512), False),
    (DCFConfig.tuned(513), False),
    (DCFConfig.tuned(513, impl="ref"), False),
    (DCFConfig.tuned(600), False),
    (DCFConfig.tuned(2048), False),
    (DCFConfig.tuned(600, impl="pallas"), True),
], ids=["rank257", "pallas", "rank256", "rank257_ref", "rank512", "rank513",
        "rank513_ref", "rank600", "rank2048", "rank600_pallas"])
def test_check_supported_refuses_what_the_card_cannot_run(cfg, refused):
    """On a CUDA device (no card needed: nothing is copied) an impl the
    port does not know is refused with NotImplementedError naming
    ROADMAP.md; every rank is taken (chunks of 256 above 512), on the
    card as on the CPU's plain route."""
    from repro_torch.core import factorized as fz

    cuda = torch.device("cuda")
    if refused:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fz.check_supported(cfg, cuda)
    else:
        fz.check_supported(cfg, cuda)
    if cfg.impl != "pallas":
        fz.check_supported(cfg, torch.device("cpu"))


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


def reference_dual_error(size: int = 2048, rank: int = 64,
                         clients: int = 4) -> dict:
    """Not a test: the JAX reference's completion errors on a problem of the
    shape of chip_smoke.py's ``dual`` phase (the reference's own generator
    and seed), the bar that phase is held to.  Run this file as a script:

        PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_solve.py
    """
    import time

    from repro.core import dcf_pca as jdcf_pca

    p = jgenerate(jax.random.PRNGKey(0), size, size, rank, 0.10,
                  observed_frac=0.7)
    cfg = JConfig.masked(rank, observed_frac=0.7, fused="dual")
    t0 = time.perf_counter()
    res = jdcf_pca(p.m_obs, cfg, clients, mask=p.mask)
    errs = jcompletion(res.l, p.l0, p.mask)
    return dict(size=size, rank=rank, clients=clients, rounds=cfg.outer_iters,
                observed=float(errs.observed),
                unobserved=float(errs.unobserved),
                overall=float(errs.overall),
                host_wall_s=time.perf_counter() - t0,
                backend=jax.default_backend(), jax=jax.__version__)


if __name__ == "__main__":
    print(json.dumps(reference_dual_error()))
