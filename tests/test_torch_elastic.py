"""The fault-tolerant simulated engine of the port against the JAX reference,
on the CPU: fault plans, participation schedules, the robust consensus,
elastic and faulted solves, and mid-solve checkpoints.

Fault tables and aggregation inputs are numpy arrays from one seed, given
to both packages.  Solves start from the reference's problem (schedule and
fault table included) carried across by ``repro_torch.convert``, because
``jax.random`` and ``torch.Generator`` give different numbers.  Bars, as in
tests/test_torch_solve.py: the consensus U after a few rounds within 1e-4
relative of the reference's (fp32 in another order, compounded), and the
reference's own recovery bars (tests/test_faults.py, tests/test_elastic.py)
for whole solves.  The coordinate median is one sort and two picks, so it
is held to the reference's bits; the trimmed mean sums in another order
(1e-6 relative).  The plain versions run here; the same paths on the card
are driven by chip_smoke.py's ``elastic`` phase.
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
from repro.core.factorized import DCFConfig as JConfig
from repro.distributed import faults as jflt
from repro.distributed import grad_compress as jgc
from repro.training import checkpoint as jckpt
from repro_torch import convert, rpca
from repro_torch.core import metrics
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.distributed import faults as flt
from repro_torch.distributed import grad_compress as gc
from repro_torch.kernels import _launch
from repro_torch.kernels import huber_contract as hc
from repro_torch.training import checkpoint as ckpt

dcf_pca = importlib.import_module("repro_torch.core.dcf_pca")
jdcf = importlib.import_module("repro.core.dcf_pca")

M, N, N_RAG, RANK, E = 120, 160, 150, 6, 8
TRACK_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread: beside JAX's CPU threads, small solves ran many
    times slower (tests/test_torch_convex.py does the same)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    return jgenerate(jax.random.PRNGKey(7), M, N, RANK, 0.05)


def _t(x):
    return torch.from_numpy(np.array(x))


def _err(res, p, n=None):
    l0, s0 = _t(p.l0), _t(p.s0)
    if n is not None:
        l0, s0 = l0[:, :n], s0[:, :n]
    return float(metrics.relative_error(res.l, res.s, l0, s0))


# ---------------------------------------------------------------------------
# Fault plans
# ---------------------------------------------------------------------------
RANDOM_PLANS = [
    (7, 40, 8, {"crash": 0.1, "nan": 0.05, "stale": 0.1}),
    (8, 40, 8, {"crash": 0.1, "nan": 0.05, "stale": 0.1}),
    (11, 80, 8, {"crash": 0.05, "stale": 0.1, "corrupt": 0.05}),
    (3, 30, 2, {"crash": 0.6, "flaky": 0.4}),
]


@pytest.mark.parametrize("seed,rounds,clients,rates", RANDOM_PLANS)
def test_random_fault_plan_is_the_references(seed, rounds, clients, rates):
    """numpy's RNG from one seed: the reference's codes bit for bit, at
    least one live vote a round, and its description."""
    got = flt.FaultPlan.random(seed, rounds, clients, rates)
    want = jflt.FaultPlan.random(seed, rounds, clients, rates)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.codes.dtype == np.int32
    assert got.describe() == want.describe()
    live = (got.codes != flt.CRASH) & (got.codes != flt.FLAKY)
    assert live.any(axis=1).all()


@pytest.mark.parametrize("kind", ["nan", "corrupt", "stale", "crash",
                                  "flaky"])
def test_byzantine_and_none_plans_are_the_references(kind):
    got = flt.FaultPlan.byzantine(12, 6, (1, 4), kind=kind, start=3)
    want = jflt.FaultPlan.byzantine(12, 6, (1, 4), kind=kind, start=3)
    np.testing.assert_array_equal(got.codes, want.codes)
    assert got.meta == want.meta and got.describe() == want.describe()
    np.testing.assert_array_equal(flt.FaultPlan.none(5, 3).codes,
                                  jflt.FaultPlan.none(5, 3).codes)
    assert torch.equal(flt.resolve_faults(got),
                       _t(jflt.resolve_faults(want)))


@pytest.mark.parametrize("case", ["ndim", "codes", "kind", "range",
                                  "rates"])
def test_fault_plan_validation_reads_as_the_reference(case):
    """tests/test_faults.py:50-59: the same errors, word for word."""
    def build(mod):
        return {
            "ndim": lambda: mod.FaultPlan(np.zeros((4,), np.int32)),
            "codes": lambda: mod.FaultPlan(np.full((2, 2), 9, np.int32)),
            "kind": lambda: mod.FaultPlan.byzantine(10, 4, (0,), kind="ok"),
            "range": lambda: mod.FaultPlan.byzantine(10, 4, (4,),
                                                     kind="nan"),
            "rates": lambda: mod.FaultPlan.random(
                0, 4, 4, rates={"crash": 0.9, "nan": 0.6}),
        }[case]()

    with pytest.raises(ValueError) as want:
        build(jflt)
    with pytest.raises(ValueError) as got:
        build(flt)
    assert str(got.value) == str(want.value)


def test_payload_faults_and_masks_are_the_references():
    rng = np.random.default_rng(0)
    u_i = rng.standard_normal((6, 5, 3)).astype(np.float32)
    u_prev = rng.standard_normal((5, 3)).astype(np.float32)
    code = np.array(flt.ALL_CODES, np.int32)
    got = flt.corrupt_payload(_t(code), _t(u_i), _t(u_prev))
    want = jflt.corrupt_payload(jnp.asarray(code), jnp.asarray(u_i),
                                jnp.asarray(u_prev))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(flt.live_mask(_t(code)).numpy(),
                                  np.asarray(jflt.live_mask(code)))
    np.testing.assert_array_equal(flt.v_advance_mask(_t(code)).numpy(),
                                  np.asarray(jflt.v_advance_mask(code)))
    table = _t(np.arange(12, dtype=np.int32).reshape(4, 3))
    assert flt.round_codes(table, torch.tensor(6)).tolist() == [6, 7, 8]


# ---------------------------------------------------------------------------
# Robust consensus
# ---------------------------------------------------------------------------
def _stack(case):
    """(E, 40, 3) payloads and the active flags: all live, with NaN and
    inf rows, with inactive rows, and with nobody left."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 40, 3)).astype(np.float32)
    x[:, :5] = 0.0  # ties
    active = np.ones(8, np.float32)
    if case in ("nan", "mixed"):
        x[1, 3, 2] = np.nan
        x[6, 0, 0] = np.inf
    if case in ("inactive", "mixed"):
        active[[0, 4]] = 0.0
    if case == "nobody":
        active[:] = 0.0
    return x, (None if case == "live" else active)


STACK_CASES = ["live", "nan", "inactive", "mixed", "nobody"]


@pytest.mark.parametrize("case", STACK_CASES)
@pytest.mark.parametrize("aggregator,trim", [("coordinate_median", 0.25),
                                             ("trimmed_mean", 0.25),
                                             ("trimmed_mean", 0.4)])
def test_robust_combine_matches_the_reference(aggregator, trim, case):
    x, active = _stack(case)
    got, cnt = gc.robust_combine_stacked(
        _t(x), None if active is None else _t(active), aggregator, trim)
    want, jcnt = jgc.robust_combine_stacked(
        jnp.asarray(x), None if active is None else jnp.asarray(active),
        aggregator, trim)
    assert int(cnt) == int(jcnt)
    if aggregator == "coordinate_median":
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("case", STACK_CASES)
def test_divergence_screen_matches_the_reference(case):
    x, active = _stack(case)
    x[2] *= 64.0  # one exploding client
    act = np.ones(8, np.float32) if active is None else active
    got = gc.divergence_screen_mask(_t(x), _t(act), 4.0)
    want = jgc.divergence_screen_mask(jnp.asarray(x), jnp.asarray(act), 4.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("aggregator,screen,part", [
    ("weighted_mean", None, "some"),
    ("weighted_mean", 4.0, None),
    ("weighted_mean", 4.0, "none"),
    ("trimmed_mean", None, "some"),
    ("coordinate_median", 3.0, "some"),
    ("coordinate_median", None, "none"),
])
@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "ragged"])
def test_aggregate_stacked_matches_the_reference(aggregator, screen, part,
                                                 ragged):
    """The whole consensus dispatch: the weighted mean over the live
    clients, its wsum gate, the robust branch and the screened mean."""
    from repro.core import factorized as jfz
    from repro_torch.core import factorized as fz

    rng = np.random.default_rng(5)
    u_i = rng.standard_normal((E, 12, 3)).astype(np.float32)
    u_i[3] *= 50.0
    u_prev = rng.standard_normal((12, 3)).astype(np.float32)
    pt = {None: None, "some": np.array([1, 0, 1, 1, 0, 1, 1, 1], np.float32),
          "none": np.zeros(E, np.float32)}[part]
    cols = (np.array(prob.client_column_counts(157, E), np.float32)
            if ragged else None)
    kw = dict(aggregator=aggregator, divergence_screen=screen)
    got, wsum = fz.aggregate_stacked(
        DCFConfig(rank=3, **kw), _t(u_i), _t(u_prev),
        n_cols=None if cols is None else _t(cols),
        part=None if pt is None else _t(pt), num_clients=E)
    want, jwsum = jfz.aggregate_stacked(
        JConfig(rank=3, **kw), jnp.asarray(u_i), jnp.asarray(u_prev),
        n_cols=None if cols is None else jnp.asarray(cols),
        part=None if pt is None else jnp.asarray(pt), num_clients=E)
    assert (wsum is None) == (jwsum is None)
    if wsum is not None:
        np.testing.assert_allclose(float(wsum), float(jwsum), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Participation schedules
# ---------------------------------------------------------------------------
def test_participation_schedule_never_empty():
    """tests/test_elastic.py:75-83 on the port's generator: every round
    keeps a participant even at a 5% rate; at 0.5 it is ~Bernoulli."""
    s = prob.participation_schedule(0, 200, 8, 0.05)
    assert s.shape == (200, 8) and s.dtype == torch.float32
    assert float(s.sum(dim=1).min()) >= 1.0
    assert set(s.unique().tolist()) <= {0.0, 1.0}
    s = prob.participation_schedule(1, 500, 8, 0.5)
    assert 0.4 < float(s.mean()) < 0.6
    assert torch.equal(s, prob.participation_schedule(1, 500, 8, 0.5))


def test_schedule_shape_is_refused_as_the_reference(problem):
    cfg = JConfig.tuned(RANK, outer_iters=10)
    with pytest.raises(ValueError) as want:
        jdcf.make_problem(problem.m_obs, cfg, E, jax.random.PRNGKey(0),
                          participation=jnp.ones((10, 5)))
    with pytest.raises(ValueError) as got:
        dcf_pca.make_problem(_t(problem.m_obs),
                             convert.config_from_reference(cfg), E,
                             participation=torch.ones(10, 5), device="cpu")
    assert str(got.value) == str(want.value)
    assert "participation" in str(got.value)


def test_rate_draws_a_schedule_and_a_table_crosses_as_it_is(problem):
    cfg = DCFConfig.tuned(RANK, outer_iters=30)
    p = dcf_pca.make_problem(_t(problem.m_obs), cfg, E, 3,
                             participation=0.5, device="cpu")
    assert p.participation.shape == (30, E)
    assert float(p.participation.sum(1).min()) >= 1.0
    sched = np.ones((7, E), np.float32)
    plan = flt.FaultPlan.byzantine(9, E, (2,), kind="stale")
    p = dcf_pca.make_problem(_t(problem.m_obs), cfg, E, 3,
                             participation=sched, faults=plan, device="cpu")
    assert torch.equal(p.participation, _t(sched))
    assert p.faults.dtype == torch.int32 and p.faults.shape == (9, E)


# ---------------------------------------------------------------------------
# Elastic and faulted solves against the reference
# ---------------------------------------------------------------------------
def _track(p, cfg, clients, rounds, n=N, **kw):
    """``rounds`` rounds of the reference and of the port from the
    reference's problem (its schedule and fault table carried across);
    returns (port U, reference U, port V, reference V)."""
    ref_problem = jdcf.make_problem(p.m_obs[:, :n], cfg, clients,
                                    jax.random.PRNGKey(0), **kw)
    carry, _ = jrt.run(jdcf.make_solver(cfg), ref_problem, rounds)
    port = convert.problem_from_reference(ref_problem, "cpu")
    if kw.get("participation") is not None:
        assert torch.equal(port.participation,
                           _t(ref_problem.participation))
    mine = dcf_pca.solve_problem(port, convert.config_from_reference(cfg),
                                 n=n)
    return mine.u.numpy(), np.asarray(carry.u), mine.v, np.asarray(carry.v)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("n", [N, N_RAG], ids=["equal", "ragged"])
def test_half_participation_tracks_the_reference(problem, n):
    """DCFConfig.elastic at participation 0.5 (the reference's drawn
    schedule), equal and ragged blocks: U after 8 rounds within 1e-4."""
    cfg = JConfig.elastic(RANK, participation=0.5, outer_iters=8)
    u, ju, _, _ = _track(problem, cfg, E, 8, n=n, participation=0.5)
    assert _rel(u, ju) < TRACK_TOL


def test_never_participating_client_keeps_its_v(problem):
    """tests/test_elastic.py:158-168: a client that never participates
    keeps its V_i bit for bit; the others move as the reference's."""
    cfg = JConfig.tuned(RANK, outer_iters=6)
    sched = np.ones((6, E), np.float32)
    sched[:, 0] = 0.0
    ref_problem = jdcf.make_problem(problem.m_obs, cfg, E,
                                    jax.random.PRNGKey(0),
                                    participation=jnp.asarray(sched))
    u, ju, v, jv = _track(problem, cfg, E, 6,
                          participation=jnp.asarray(sched))
    assert torch.equal(v[0], _t(ref_problem.v_init)[0])
    assert not torch.equal(v[1], _t(ref_problem.v_init)[1])
    assert _rel(u, ju) < TRACK_TOL and _rel(v.numpy(), jv) < TRACK_TOL


@pytest.mark.parametrize("scenario", ["nan_median", "corrupt_trimmed",
                                      "corrupt_screen", "random_mixed"])
def test_faulted_rounds_track_the_reference(problem, scenario):
    """Ten rounds under each fault scenario from the reference's problem:
    the consensus U within 1e-4 of the reference's."""
    cfg, plan = {
        "nan_median": (dict(aggregator="coordinate_median"),
                       jflt.FaultPlan.byzantine(10, E, (1, 5), kind="nan")),
        "corrupt_trimmed": (dict(aggregator="trimmed_mean", trim_frac=0.25),
                            jflt.FaultPlan.byzantine(10, E, (2,),
                                                     kind="corrupt")),
        "corrupt_screen": (dict(divergence_screen=4.0),
                           jflt.FaultPlan.byzantine(10, E, (6,),
                                                    kind="corrupt")),
        "random_mixed": (dict(aggregator="trimmed_mean"),
                         jflt.FaultPlan.random(
                             11, 10, E, {"crash": 0.1, "stale": 0.1,
                                         "corrupt": 0.05, "flaky": 0.1})),
    }[scenario]
    jcfg = JConfig.tuned(RANK, outer_iters=10, **cfg)
    u, ju, v, jv = _track(problem, jcfg, E, 10, faults=plan)
    assert _rel(u, ju) < TRACK_TOL and _rel(v.numpy(), jv) < TRACK_TOL


def _port_solve(m, cfg, **kw):
    return dcf_pca.dcf_pca(m, cfg, E, 0, device="cpu", **kw)


@pytest.mark.parametrize("scenario", ["nan", "corrupt", "screen"])
def test_byzantine_solves_meet_the_references_bars(scenario):
    """tests/test_faults.py:78-133 on the port (its own solves): NaN
    payloads wreck the weighted mean and the coordinate median recovers
    within 3x the fault-free error; a 64x corrupt client wrecks the mean
    and the trimmed mean (or the divergence screen) recovers."""
    seed, size, rank = {"nan": (42, 128, 5), "corrupt": (2, 96, 4),
                        "screen": (3, 96, 4)}[scenario]
    p = jgenerate(jax.random.PRNGKey(seed), size, size, rank=rank,
                  sparsity=0.05)
    m = _t(p.m_obs)
    cfg = DCFConfig.tuned(rank, outer_iters=60)
    e0 = _err(_port_solve(m, cfg), p)
    if scenario == "nan":
        plan = flt.FaultPlan.byzantine(60, E, (1, 5), kind="nan")
        wrecked = _port_solve(m, cfg, faults=plan)
        assert not torch.isfinite(wrecked.l).all()
        robust = dataclasses.replace(cfg, aggregator="coordinate_median")
    else:
        client = 2 if scenario == "corrupt" else 6
        plan = flt.FaultPlan.byzantine(60, E, (client,), kind="corrupt")
        robust = dataclasses.replace(
            cfg, **({"aggregator": "trimmed_mean", "trim_frac": 0.25}
                    if scenario == "corrupt" else {"divergence_screen": 4.0}))
    e1 = _err(_port_solve(m, robust, faults=plan), p)
    assert np.isfinite(e1) and e1 <= 3.0 * max(e0, 1e-6), (e0, e1)
    if scenario == "corrupt":
        ew = _err(_port_solve(m, cfg, faults=plan), p)
        assert not np.isfinite(ew) or ew > 10 * e1, (ew, e1)


def test_all_dropout_round_is_not_convergence(problem):
    """tests/test_elastic.py:171-197 on the port: an all-zero schedule row
    trips neither the while-mode residual exit nor obj_plateau."""
    m = _t(problem.m_obs)
    cfg = DCFConfig.tuned(RANK, outer_iters=200)
    run = rt.RunConfig(mode="while", tol=1e-6)
    full = _port_solve(m, cfg, run=run)
    sched = torch.ones(cfg.outer_iters, E)
    sched[20] = 0.0
    r = _port_solve(m, cfg, run=run, participation=sched)
    assert int(r.stats.rounds) > 25
    err = float(metrics.low_rank_relative_error(r.l, _t(problem.l0)))
    err_full = float(metrics.low_rank_relative_error(full.l,
                                                     _t(problem.l0)))
    assert err <= max(2.0 * err_full, 1e-4), (err, err_full)
    run_obj = rt.RunConfig(mode="while", criterion="obj_plateau", tol=1e-9)
    cfg_t = DCFConfig.tuned(RANK, outer_iters=60, track_objective=True)
    full2 = _port_solve(m, cfg_t, run=run_obj)
    sched2 = torch.ones(60, E)
    sched2[20] = 0.0
    r2 = _port_solve(m, cfg_t, run=run_obj, participation=sched2)
    assert int(r2.stats.rounds) > 21, int(r2.stats.rounds)
    assert int(r2.stats.rounds) >= int(full2.stats.rounds) - 2


# ---------------------------------------------------------------------------
# Bit-exact pairs of the port
# ---------------------------------------------------------------------------
def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(
        (a.l, a.s, a.u, a.v, a.stats.objective, a.stats.residual),
        (b.l, b.s, b.u, b.v, b.stats.objective, b.stats.residual)))


@pytest.mark.parametrize("pair", ["weighted_mean", "all_ones"])
def test_explicit_defaults_keep_the_bits(problem, pair):
    """aggregator="weighted_mean" spelled out, and an all-ones schedule at
    E = 8 (a power of two: the weights are exactly 1/8), give the default
    solve's bits."""
    m = _t(problem.m_obs)
    cfg = DCFConfig.tuned(RANK, outer_iters=20)
    base = _port_solve(m, cfg)
    if pair == "weighted_mean":
        other = _port_solve(m, dataclasses.replace(
            cfg, aggregator="weighted_mean"))
    else:
        other = _port_solve(m, cfg, participation=torch.ones(20, E))
    assert _same(base, other)


@pytest.mark.parametrize("case", ["plain", "masked_warm"])
def test_resumed_solve_is_the_uninterrupted_one(problem, tmp_path,
                                                monkeypatch, case):
    """tests/test_faults.py:263-307 on the port: a segmented solve killed
    after its first snapshot and resumed gives the uninterrupted segmented
    solve's L, S, U, V and both traces, bit for bit; and the segmented
    solve is the single scan's."""
    m = _t(problem.m_obs)
    kw = {}
    cfg = DCFConfig.tuned(RANK, outer_iters=20, track_objective=True)
    if case == "masked_warm":
        mask = (torch.rand(M, N, generator=torch.Generator().manual_seed(1))
                < 0.8).to(torch.float32)
        first = _port_solve(m, cfg, mask=mask)
        kw = dict(mask=mask, warm=(first.u, first.v),
                  participation=prob.participation_schedule(2, 20, E, 0.7))
    run = rt.RunConfig(mode="scan", checkpoint_every=6)
    single = _port_solve(m, cfg, **kw)
    whole = _port_solve(m, cfg, run=run, checkpoint_dir=str(tmp_path / "a"),
                        **kw)
    assert _same(single, whole)
    assert ckpt.latest_step(str(tmp_path / "a")) == 18

    class Killed(Exception):
        pass

    def killed(t, carry):
        raise Killed

    saved = rt.run_segmented
    with monkeypatch.context() as patch:
        patch.setattr(rt, "run_segmented",
                      lambda *a, **k: saved(*a, save_extra=killed, **k))
        with pytest.raises(Killed):
            _port_solve(m, cfg, run=run, checkpoint_dir=str(tmp_path / "b"),
                        **kw)
    assert ckpt.latest_step(str(tmp_path / "b")) == 6
    resumed = _port_solve(m, cfg, run=run, resume_from=str(tmp_path / "b"),
                          **kw)
    assert _same(whole, resumed)
    assert torch.equal(resumed.stats.converged, whole.stats.converged)


def test_reference_snapshot_resumes_in_the_port(problem, tmp_path):
    """A snapshot the reference's segmented driver wrote (here after round
    12 of 20) restores into the port's carry, and the port finishes the
    solve within 1e-4 of the reference's uninterrupted factors."""
    jcfg = JConfig.tuned(RANK, outer_iters=20)
    ref_problem = jdcf.make_problem(problem.m_obs, jcfg, E,
                                    jax.random.PRNGKey(0))
    solver = jdcf.make_solver(jcfg)
    jcarry, jstats = jrt.run_segmented(
        solver, ref_problem, 20, jrt.RunConfig(checkpoint_every=12),
        checkpoint_dir=str(tmp_path))
    assert jckpt.latest_step(str(tmp_path)) == 12
    port = convert.problem_from_reference(ref_problem, "cpu")
    res = dcf_pca.solve_problem(port, convert.config_from_reference(jcfg),
                                resume_from=str(tmp_path))
    assert res.stats.objective.shape == (20,)
    np.testing.assert_array_equal(res.stats.residual[:12].numpy(),
                                  np.asarray(jstats.residual)[:12])
    assert _rel(res.u.numpy(), np.asarray(jcarry.u)) < TRACK_TOL
    assert _rel(res.v.numpy(), np.asarray(jcarry.v)) < TRACK_TOL


def test_port_snapshot_restores_in_the_reference(tmp_path):
    """The layout is the reference's: the port's snapshot (fp32, int32 and
    bf16 leaves, a named tuple in a dict) restores with
    repro.training.checkpoint, and back."""
    tree = {"b": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "a": rt.Diag(torch.tensor(1.5), torch.linspace(0, 1, 4)),
            "c": torch.tensor([1.0, -2.5]).to(torch.bfloat16)}
    ckpt.save(str(tmp_path), 4, tree, mesh_shape=(1,))
    like = {"b": jnp.zeros((2, 3), jnp.int32),
            "a": jrt.Diag(jnp.zeros(()), jnp.zeros(4)),
            "c": jnp.zeros(2, jnp.bfloat16)}
    got, step = jckpt.restore(str(tmp_path), like)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(got["b"]), tree["b"].numpy())
    np.testing.assert_array_equal(np.asarray(got["a"].residual),
                                  tree["a"].residual.numpy())
    assert np.asarray(got["c"], np.float32).tolist() == [1.0, -2.5]
    back, _ = ckpt.restore(str(tmp_path), tree)
    for x, y in zip(ckpt._flatten(back), ckpt._flatten(tree)):
        assert x[0] == y[0] and torch.equal(x[1], y[1])


def test_checkpoint_keeps_the_last_and_refuses_another_mesh(tmp_path):
    tree = {"x": torch.zeros(3)}
    for step in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), step, tree, mesh_shape=(2,), keep_last=2)
    (tmp_path / "step_00000009.tmp").mkdir()
    ckpt._gc(str(tmp_path), 2)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "LATEST", "step_00000004", "step_00000005"]
    assert ckpt.latest_step(str(tmp_path)) == 5
    with pytest.raises(ValueError) as got:
        ckpt.restore(str(tmp_path), tree, expect_mesh=(4,))
    with pytest.raises(ValueError) as want:
        jckpt.restore(str(tmp_path), {"x": jnp.zeros(3)}, expect_mesh=(4,))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), {"x": tree["x"], "y": tree["x"]})
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), tree)


@pytest.mark.parametrize("case", ["mode", "budget"])
def test_segmented_driver_refusals_read_as_the_reference(problem, tmp_path,
                                                          case):
    cfg = DCFConfig.tuned(RANK, outer_iters=8)
    port = dcf_pca.make_problem(_t(problem.m_obs), cfg, E, device="cpu")
    solver = dcf_pca.make_solver(cfg)
    if case == "mode":
        with pytest.raises(ValueError) as got:
            rt.run_segmented(solver, port, 8, rt.RunConfig(mode="while"))
        with pytest.raises(ValueError) as want:
            jrt.run_segmented(None, None, 8, jrt.RunConfig(mode="while"))
        assert str(got.value) == str(want.value)
        return
    rt.run_segmented(solver, port, 8, rt.RunConfig(checkpoint_every=6),
                     checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="exceeds this solve's budget"):
        rt.run_segmented(solver, port, 5, rt.FIXED,
                         resume_from=str(tmp_path))


@pytest.mark.parametrize("every,total", [(0, 10), (4, 10), (5, 10),
                                         (12, 10), (3, 0)])
def test_segment_plan_is_the_references(every, total):
    assert rt.segment_plan(total, every) == jrt.segment_plan(total, every)


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------
def test_front_door_solves_a_faulted_checkpointed_elastic_problem(
        problem, tmp_path):
    """participation, faults, a robust aggregator and checkpoint_dir through
    repro_torch.rpca.solve(method="dcf"), and a resume from it."""
    m = _t(problem.m_obs)
    plan = flt.FaultPlan.random(5, 30, E, {"crash": 0.1, "nan": 0.1})
    cfg = DCFConfig.tuned(RANK, outer_iters=30,
                          aggregator="coordinate_median")
    run = rt.RunConfig(checkpoint_every=10)
    kw = dict(method="dcf", cfg=cfg, run=run, num_clients=E,
              participation=0.8, faults=plan, device="cpu")
    res = rpca.solve(m, checkpoint_dir=str(tmp_path), **kw)
    assert torch.isfinite(res.l).all() and res.l.shape == (M, N)
    assert ckpt.latest_step(str(tmp_path)) == 20
    again = rpca.solve(m, resume_from=str(tmp_path), **kw)
    assert torch.equal(again.l, res.l) and torch.equal(again.v, res.v)


def test_default_cfg_with_a_schedule_is_the_elastic_preset():
    """method="dcf" with no cfg and a schedule picks the reference's
    elastic preset at the schedule's mean rate."""
    from repro import rpca as jrpca

    sched = np.ones((4, 2), np.float32)
    sched[0, 0] = 0.0
    jspec = jrpca.RPCASpec(jnp.zeros((8, 8)), rank=2, num_clients=2,
                           participation=jnp.asarray(sched))
    spec = rpca.RPCASpec(torch.zeros(8, 8), rank=2, num_clients=2,
                         participation=_t(sched))
    assert dataclasses.asdict(dcf_pca._default_cfg(spec, "dcf")) == \
        dataclasses.asdict(jdcf._default_cfg(jspec, "dcf"))


# ---------------------------------------------------------------------------
# Ranks above 512 on the card: the plain functions behind the kernels' grid
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("r,chunks,route", [(1, 1, "base"), (256, 1, "base"),
                                            (257, 2, "stream"),
                                            (512, 2, "stream"),
                                            (513, 3, "stream"),
                                            (600, 3, "stream"),
                                            (1024, 4, "stream"),
                                            (1025, 5, "stream")])
def test_rank_chunks(r, chunks, route):
    from repro_torch.kernels import shrinkage

    assert _launch.rank_chunks(r) == chunks
    assert shrinkage.shrink_plan(10, 4000, 400, r, 132).route == route


def test_grid_limits_are_plain_functions():
    assert _launch.grid_limit_error(10, 4000, 600) is None
    assert _launch.grid_limit_error(40000, 64, 600) is None  # chunks on x
    assert _launch.grid_limit_error(40000, 64, 300) is None  # slices on x
    assert "z axis" in _launch.grid_limit_error(70000, 64, 300)
    assert _launch.grid_limit_error(40000, 64, 200) is None
    assert "y axis" in _launch.grid_limit_error(1, 64 * 65536, 64)
    # above r = 256 the shrink's y axis counts 128-row tiles
    assert _launch.grid_limit_error(1, 64 * 65536, 300) is None
    assert "y axis" in _launch.grid_limit_error(1, 128 * 65536, 300)
    from repro_torch.core import factorized as fz

    cuda = torch.device("cuda")
    fz.check_grid(DCFConfig.tuned(300), 10, 4000, cuda)
    with pytest.raises(ValueError, match="cannot take this problem"):
        fz.check_grid(DCFConfig.tuned(300), 70000, 64, cuda)
    fz.check_grid(DCFConfig.tuned(300, impl="ref"), 70000, 64, cuda)
    fz.check_grid(DCFConfig.tuned(300), 70000, 64, torch.device("cpu"))


def test_splits_at_three_chunks_fill_the_card():
    """At the t6 shapes (E=10, m=4000, n_i=400, r=600) the grids hold 3x
    the blocks of one pass, one an SM: v_splits / u_splits cost them so,
    and keep r <= 512's choices."""
    assert hc.v_splits(10, 5000, 500, 132, 2) == hc.v_splits(
        10, 5000, 500, 132, _launch.rank_chunks(500))
    splits, rows = hc.v_splits(10, 4000, 400, 132, 3)
    assert splits * rows >= 4000 and rows % 64 == 0
    splits, cols = hc.u_splits(10, 4000, 400, 132, 3)
    assert splits * cols >= 400 and cols % 64 == 0
    assert hc.dual_plan(10, 4000, 400, 600) is None  # two passes there
