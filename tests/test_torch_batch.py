"""Batched solves of the port against the JAX reference, on the CPU.

The reference builds every batch with ``jax.vmap`` of its ``make_problem``
(initial factors, schedules and masks included) and ``repro_torch.convert``
carries it across, because ``jax.random`` and ``torch.Generator`` give
different numbers; the port's plain route then solves the batch with
``runtime.solve_batch`` (one call of each kernel function a sweep for all
B·E clients).  Bars: the port's (tests/test_torch_solve.py:8-10), the
consensus U after 5 rounds within 1e-4 relative of the reference's and a
whole solve's relative error (Eq. 30) under 1e-4; a batch against the
port's own serial solves within the reference's batch tolerances
(tests/test_runtime.py:109-116, atol 1e-3 for the factorized solvers;
tests/test_masked.py:296-298, 1e-5 for the convex ones).  Each problem's
bits depend on its own data and the batch's shape only, and the port's
bit-exact pairs hold inside a batch.  chip_smoke.py's ``batch`` phases
drive the same paths on the card.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import generate_problem as jgenerate
from repro.core import runtime as jrt
from repro.core.apgm import APGMConfig as JAPGMConfig
from repro.core.factorized import DCFConfig as JConfig
from repro.core.ialm import IALMConfig as JIALMConfig
from repro_torch import convert, rpca
from repro_torch.core import APGMConfig, IALMConfig, metrics
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig

dcf_pca = importlib.import_module("repro_torch.core.dcf_pca")
cf_pca = importlib.import_module("repro_torch.core.cf_pca")
apgm = importlib.import_module("repro_torch.core.apgm")
ialm = importlib.import_module("repro_torch.core.ialm")
jdcf = importlib.import_module("repro.core.dcf_pca")
jcf = importlib.import_module("repro.core.cf_pca")
japgm = importlib.import_module("repro.core.apgm")
jialm = importlib.import_module("repro.core.ialm")

M, N, N_RAG, RANK, E, B = 48, 64, 62, 3, 4, 3
ROUNDS = 5
TRACK_TOL = 1e-4
ERR_BAR = 1e-4
SERIAL_TOL = {"dcf": 1e-3, "cf": 1e-3, "apgm": 1e-5, "ialm": 1e-5}
CONVEX_ITERS = 30  # tests/test_torch_convex.py's parity runs
CONVEX_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread beside JAX's (tests/test_torch_convex.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problems():
    """B problems of one shape, 80% observed (the unmasked cases ignore
    the masks)."""
    return [jgenerate(jax.random.PRNGKey(10 + i), M, N, RANK, 0.05,
                      observed_frac=0.8) for i in range(B)]


@pytest.fixture(scope="module")
def dense():
    """B fully observed problems of one shape and rising difficulty (2%, 5%
    and 12% corruption)."""
    return [jgenerate(jax.random.PRNGKey(20 + i), M, N, RANK, sparsity)
            for i, sparsity in enumerate((0.02, 0.05, 0.12))]


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _schedule(rounds):
    """A shared (T, E) schedule from one numpy seed: client 1 drops out of
    every other round, the others stay in."""
    part = np.ones((rounds, E), np.float32)
    part[::2, 1] = 0.0
    return part


DCF_CASES = {
    # name: (config, n, masked, shared schedule)
    "diag": (JConfig.tuned(RANK, outer_iters=ROUNDS), N, False, False),
    "dual_ragged": (JConfig.tuned(RANK, outer_iters=ROUNDS, fused="dual"),
                    N_RAG, False, False),
    "off_masked": (JConfig.masked(RANK, 0.8, outer_iters=ROUNDS,
                                  fused="off"), N, True, False),
    "packed_ragged": (JConfig.masked(RANK, 0.8, outer_iters=ROUNDS,
                                     pack_mask=True), N_RAG, True, False),
    "median_schedule": (JConfig.tuned(RANK, outer_iters=ROUNDS,
                                      aggregator="coordinate_median"),
                        N, False, True),
    "mean_schedule_ragged": (JConfig.tuned(RANK, outer_iters=ROUNDS),
                             N_RAG, True, True),
}


def _ref_dcf(problems, cfg, n, masked, sched, run=jrt.FIXED, seed=3):
    """The reference's batch (``jax.vmap`` of make_problem, as its
    ``_solve_batch``) and its ``solve_batch`` outputs, trimmed to n."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(problems))
    mb = jnp.stack([p.m_obs[:, :n] for p in problems])
    masks = (jnp.stack([p.mask[:, :n] for p in problems]) if masked
             else None)
    part = jnp.asarray(_schedule(cfg.outer_iters)) if sched else None
    batch = jax.vmap(
        lambda mo, k, om: jdcf.make_problem(mo, cfg, E, k, mask=om,
                                            participation=part),
        in_axes=(0, 0, None if masks is None else 0))(mb, keys, masks)
    (l, s, u, v), _, stats = jrt.solve_batch(
        jdcf.make_solver(cfg, with_objective=run.needs_objective), batch,
        cfg.outer_iters, run)
    return batch, (np.asarray(l)[..., :n], np.asarray(s)[..., :n],
                   np.asarray(u), stats)


@pytest.mark.parametrize("case", sorted(DCF_CASES))
def test_dcf_batch_tracks_the_references(problems, case):
    """Equal and ragged blocks, dense and packed masks, every fused mode,
    the weighted mean and the coordinate median, a shared schedule: each
    problem's U after 5 rounds within 1e-4 of the reference's batch, and
    L likewise; the batch crosses with its leading axis on every field."""
    cfg, n, masked, sched = DCF_CASES[case]
    batch, (jl, _, ju, jstats) = _ref_dcf(problems, cfg, n, masked, sched)
    port = convert.problem_from_reference(batch, "cpu")
    assert port.blocks.shape[:2] == (B, E) and port.lam0.shape == (B,)
    if sched:
        assert port.participation.shape == (B, ROUNDS, E)
    res = dcf_pca.solve_problem(port, convert.config_from_reference(cfg),
                                n=n)
    assert res.l.shape == (B, M, n) and res.u.shape == (B, M, RANK)
    assert res.stats.rounds.tolist() == [ROUNDS] * B
    for b in range(B):
        assert _rel(res.u[b].numpy(), ju[b]) < TRACK_TOL
        assert _rel(res.l[b].numpy(), jl[b]) < TRACK_TOL
    np.testing.assert_array_equal(res.stats.converged.numpy(),
                                  np.asarray(jstats.converged))


def test_dcf_batch_whole_solve_meets_the_bar(dense):
    """A whole batch (DCFConfig.tuned, 100 rounds) of fully observed
    problems from the reference: every problem under the recovery bar, as
    the reference's."""
    cfg = JConfig.tuned(RANK)
    batch, (jl, js, _, _) = _ref_dcf(dense, cfg, N, False, False)
    res = dcf_pca.solve_problem(convert.problem_from_reference(batch, "cpu"),
                                convert.config_from_reference(cfg))
    for b, p in enumerate(dense):
        mine = metrics.relative_error(res.l[b], res.s[b], _t(p.l0),
                                      _t(p.s0))
        ref = metrics.relative_error(_t(jl[b]), _t(js[b]), _t(p.l0),
                                     _t(p.s0))
        assert float(mine) < ERR_BAR and float(ref) < ERR_BAR


def test_cf_batch_tracks_the_reference(problems):
    """CF-PCA (E = 1: the batch is the kernels' leading axis), with
    per-problem masks: U after 5 rounds within 1e-4 of the reference's."""
    cfg = JConfig.masked(RANK, 0.8, outer_iters=ROUNDS)
    keys = jax.random.split(jax.random.PRNGKey(4), B)
    batch = jax.vmap(lambda mo, k, om: jcf.make_problem(mo, cfg, k, mask=om))(
        jnp.stack([p.m_obs for p in problems]), keys,
        jnp.stack([p.mask for p in problems]))
    (_, _, ju, _), _, _ = jrt.solve_batch(jcf.make_solver(cfg), batch,
                                          ROUNDS, jrt.FIXED)
    res = cf_pca.solve_problem(convert.problem_from_reference(batch, "cpu"),
                               convert.config_from_reference(cfg))
    for b in range(B):
        assert _rel(res.u[b].numpy(), np.asarray(ju)[b]) < TRACK_TOL


@pytest.mark.parametrize("method", ["apgm", "ialm"])
def test_convex_batch_tracks_the_reference(problems, method):
    """APGM and IALM batches with per-problem masks (one batched SVD an
    iteration): L and S of 30 iterations within 1e-5 of the reference's
    batch, problem by problem."""
    jmod, pmod, jcfg, pcfg = {
        "apgm": (japgm, apgm, JAPGMConfig(iters=CONVEX_ITERS),
                 APGMConfig(iters=CONVEX_ITERS)),
        "ialm": (jialm, ialm, JIALMConfig(iters=CONVEX_ITERS),
                 IALMConfig(iters=CONVEX_ITERS)),
    }[method]
    mb = jnp.stack([p.mask * p.m_obs for p in problems])
    masks = jnp.stack([p.mask for p in problems])
    batch = jax.vmap(lambda mo, om: jmod._problem(mo, None, om))(mb, masks)
    (jl, js), _, _ = jrt.solve_batch(jmod.make_solver(jcfg), batch,
                                     CONVEX_ITERS, jrt.FIXED)
    res = pmod.solve_problem(convert.problem_from_reference(batch, "cpu"),
                             pcfg)
    assert res.l.shape == (B, M, N)
    for b in range(B):
        assert _rel(res.l[b].numpy(), np.asarray(jl)[b]) <= CONVEX_TOL
        assert _rel(res.s[b].numpy(), np.asarray(js)[b]) <= CONVEX_TOL


# ---------------------------------------------------------------------------
# The port's batch against its own serial solves
# ---------------------------------------------------------------------------
def _serial_vs_batch(method, problems, n):
    m = torch.stack([_t(p.m_obs[:, :n]) for p in problems])
    w = torch.stack([_t(p.mask[:, :n]) for p in problems])
    cfg = {"dcf": DCFConfig.masked(RANK, 0.8, outer_iters=30,
                                   fused="dual"),
           "cf": DCFConfig.tuned(RANK, outer_iters=30),
           "apgm": APGMConfig(iters=CONVEX_ITERS),
           "ialm": IALMConfig(iters=CONVEX_ITERS)}[method]
    kw = {"num_clients": E} if method == "dcf" else {}
    mask = w if method != "cf" else None
    bat = rpca.solve(m, method=method, cfg=cfg, mask=mask, key=5,
                     device="cpu", **kw)
    ser = [rpca.solve(m[b], method=method, cfg=cfg, key=5 + b,
                      mask=None if mask is None else mask[b], device="cpu",
                      **kw) for b in range(B)]
    return bat, ser


@pytest.mark.parametrize("method,n", [("dcf", N_RAG), ("cf", N),
                                      ("apgm", N), ("ialm", N)])
def test_batch_matches_the_serial_solves(problems, method, n):
    """``rpca.solve`` on a (B, m, n) spec against B serial solves, problem
    b from seed ``key + b`` (``rpca.batch_keys``): L and S within the
    reference's batch tolerances, the factors' shapes with a leading B."""
    bat, ser = _serial_vs_batch(method, problems, n)
    tol = SERIAL_TOL[method]
    assert bat.method == method and bat.stats.rounds.shape == (B,)
    for b in range(B):
        for got, want in ((bat.l[b], ser[b].l), (bat.s[b], ser[b].s)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=tol,
                                       rtol=0 if method in ("dcf", "cf")
                                       else tol)
        if ser[b].u is not None:
            assert bat.u[b].shape == ser[b].u.shape


def _same(a, b, i=0):
    """Problem i of result a and problem i of b, bit for bit."""
    fields = ("l", "s", "u", "v")
    return (all(torch.equal(getattr(a, f)[i], getattr(b, f)[i])
                for f in fields)
            and torch.equal(a.stats.residual[i], b.stats.residual[i])
            and torch.equal(a.stats.objective[i], b.stats.objective[i]))


@pytest.mark.parametrize("cfg", [
    DCFConfig.tuned(RANK, outer_iters=20),
    DCFConfig.masked(RANK, 0.8, outer_iters=20, fused="dual",
                     pack_mask=True, aggregator="coordinate_median",
                     track_objective=True),
], ids=["diag", "dual_packed_median"])
def test_batch_mates_leave_a_problems_bits(problems, cfg):
    """Problem 0's L, S, U, V and traces do not change, bit for bit, when
    its batch-mates are replaced by other problems of the same shape."""
    others = [jgenerate(jax.random.PRNGKey(90 + i), M, N, RANK, 0.1,
                        observed_frac=0.6) for i in range(B)]

    def solve(ps):
        m = torch.stack([_t(p.m_obs) for p in ps])
        w = torch.stack([_t(p.mask) for p in ps])
        return rpca.solve(m, method="dcf", cfg=cfg, num_clients=E,
                          mask=w if cfg.pack_mask else None,
                          key=[7] + [8 + i for i in range(B - 1)],
                          device="cpu")

    a = solve(problems)
    b = solve(problems[:1] + others[1:])
    assert _same(a, b)
    assert not torch.equal(a.l[1], b.l[1])


@pytest.mark.parametrize("pair", ["ones_mask", "packed", "off"])
def test_bit_exact_pairs_hold_in_a_batch(problems, pair):
    """The port's pairs inside a batch: an all-ones mask gives the bits of
    no mask, a packed mask those of the dense one, and fused="off" those
    of "diag" (L and S)."""
    m = torch.stack([_t(p.m_obs) for p in problems])
    w = torch.stack([_t(p.mask) for p in problems])
    cfg = DCFConfig.tuned(RANK, outer_iters=10)

    def solve(cfg, mask=None):
        return rpca.solve(m, method="dcf", cfg=cfg, num_clients=E,
                          mask=mask, device="cpu")

    if pair == "ones_mask":
        a, b = solve(cfg), solve(cfg, torch.ones_like(m))
    elif pair == "packed":
        a = solve(cfg, w)
        b = solve(dataclasses.replace(cfg, pack_mask=True), w)
    else:
        a, b = solve(cfg), solve(dataclasses.replace(cfg, fused="off"))
    assert torch.equal(a.l, b.l) and torch.equal(a.s, b.s)


# ---------------------------------------------------------------------------
# Freeze semantics and runtime.driver
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def freeze_batch(dense):
    """tests/test_runtime.py:120-142's setting at this file's size
    (problems of rising difficulty, DCFConfig.tuned(3), while mode at tol
    5e-4), solved by the reference's solve_batch; returns (reference
    batch, outputs, config)."""
    cfg = JConfig.tuned(RANK)
    batch, out = _ref_dcf(dense, cfg, N, False, False,
                          run=jrt.RunConfig(mode="while", tol=5e-4))
    return batch, out, cfg


@pytest.mark.parametrize("mode", ["while", "chunk"])
def test_finished_problems_freeze_as_the_references(freeze_batch, mode):
    """Each problem stops at the reference's measured round (they differ),
    its traces are zero past it and its flag is the reference's; ``chunk``
    mode (the host reads the done mask once a chunk) gives the ``while``
    mode's bits."""
    batch, (_, _, _, jstats), jcfg = freeze_batch
    port = convert.problem_from_reference(batch, "cpu")
    cfg = convert.config_from_reference(jcfg)
    rounds = np.asarray(jstats.rounds)
    assert len(set(rounds.tolist())) == B
    res = dcf_pca.solve_problem(port, cfg, rt.RunConfig(mode="while",
                                                        tol=5e-4))
    assert res.stats.rounds.tolist() == rounds.tolist()
    np.testing.assert_array_equal(res.stats.converged.numpy(),
                                  np.asarray(jstats.converged))
    resid = res.stats.residual.numpy()
    for b in range(B):
        assert np.all(resid[b, rounds[b]:] == 0.0)
        assert np.all(resid[b, 1:rounds[b]] > 0.0)
        np.testing.assert_allclose(resid[b, :rounds[b]],
                                   np.asarray(jstats.residual)[b,
                                                               :rounds[b]],
                                   rtol=1e-3)
    if mode == "chunk":
        chunked = dcf_pca.solve_problem(
            port, cfg, rt.RunConfig(mode="chunk", tol=5e-4, chunk_size=10))
        for i in range(B):
            assert _same(res, chunked, i)
        assert torch.equal(res.stats.rounds, chunked.stats.rounds)


def test_driver_and_tree_where():
    """``driver`` closes (solver, budget, mode) into the serial ``run``;
    ``tree_where`` freezes the leaves of named tuples and dicts by a
    leading-axis mask."""
    p = dcf_pca.make_problem(torch.randn(24, 32), DCFConfig.tuned(2), 4, 0,
                             device="cpu")
    solver = dcf_pca.make_solver(DCFConfig.tuned(2, outer_iters=3))
    c1, s1 = rt.driver(solver, 3)(p)
    c2, s2 = rt.run(solver, p, 3)
    assert torch.equal(c1.u, c2.u) and torch.equal(s1.residual, s2.residual)
    new = {"a": rt.Diag(torch.ones(2), torch.ones(2, 3)), "b": None}
    old = {"a": rt.Diag(torch.zeros(2), torch.zeros(2, 3)), "b": None}
    got = rt.tree_where(torch.tensor([True, False]), new, old)
    assert got["a"].objective.tolist() == [1.0, 0.0]
    assert got["a"].residual.tolist() == [[1.0] * 3, [0.0] * 3]
    assert got["b"] is None


def test_batch_keys_give_each_problem_its_seed():
    """``rpca.batch_keys``: seeds 0..B-1 by default, k..k+B-1 from k, a
    list as given (its length checked), one generator shared."""
    assert rpca.batch_keys(None, 3) == [0, 1, 2]
    assert rpca.batch_keys(5, 2) == [5, 6]
    assert rpca.batch_keys([4, 1], 2) == [4, 1]
    gen = torch.Generator()
    assert rpca.batch_keys(gen, 2) == [gen, gen]
    with pytest.raises(ValueError, match="needs 3 keys"):
        rpca.batch_keys([1, 2], 3)
