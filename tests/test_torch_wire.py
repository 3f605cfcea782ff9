"""The wire consensus of the port against the JAX reference, on the CPU:
the top-k payload and its reconstruction, the traffic model, and the wire
solver (top-k deltas with error feedback, one-round stale application,
both, with the robust aggregators and faults), alone and in a batch, with
its carries through a checkpoint.

Solves start from the reference's problem, carried across by
``repro_torch.convert``.  Bars: the consensus U within 1e-4 relative of
the reference's after the whole solve (tests/test_torch_solve.py:8-10's
tracking bar; on these problems the two agree to ~1e-6, so no top-k choice
flips), and the reference's own bars on the port's solves
(tests/test_multihost.py:101-135: compressed within 2x of the dense
error, ``topk_frac=1.0`` within 1e-4 of dense; tests/test_faults.py:
148-166: the composed solve finite and under 0.5).  ``topk_k`` and the
traffic model are held to the reference's numbers exactly, and a resumed
wire solve to the uninterrupted one's bits.  chip_smoke.py's ``wire``
phase drives the same on the card.
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
from repro.distributed import multihost as jmh
from repro_torch import convert, rpca
from repro_torch.core import metrics
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.distributed import grad_compress as gc
from repro_torch.distributed import multihost as mh
from repro_torch.training import checkpoint as ckpt

dcf_pca = importlib.import_module("repro_torch.core.dcf_pca")
jdcf = importlib.import_module("repro.core.dcf_pca")

TRACK_TOL = 1e-4
E = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread beside JAX's (tests/test_torch_convex.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def problem():
    """tests/test_multihost.py:101-103's problem (64^2, rank 3, 5%)."""
    return jgenerate(jax.random.PRNGKey(0), 64, 64, 3, 0.05)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# The payload and the traffic model
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,frac", [(1, 0.5), (10, 0.04), (300, 0.1),
                                    (450000, 0.1), (450000, 1.0),
                                    (1025, 0.0005), (7, 0.999)])
def test_topk_k_is_the_references(d, frac):
    assert mh.topk_k(d, frac) == jmh.topk_k(d, frac)


@pytest.mark.parametrize("m,rank,clients,frac", [
    (64, 3, 4, None), (64, 3, 4, 0.1), (3000, 150, 10, 0.1),
    (3000, 150, 10, 1.0), (96, 4, 8, 0.5)])
def test_wire_model_is_the_references(m, rank, clients, frac):
    ccfg = (None, None) if frac is None else (
        gc.CompressConfig(topk_frac=frac), jgc.CompressConfig(topk_frac=frac))
    assert mh.consensus_wire_model(m, rank, clients, ccfg[0]) == \
        jmh.consensus_wire_model(m, rank, clients, ccfg[1])


def test_compress_config_is_the_references():
    assert [f.name for f in dataclasses.fields(gc.CompressConfig)] == \
        [f.name for f in dataclasses.fields(jgc.CompressConfig)]
    assert dataclasses.asdict(gc.CompressConfig()) == \
        dataclasses.asdict(jgc.CompressConfig())


@pytest.mark.parametrize("shape,k", [((8,), 2), ((3, 4096), 700),
                                     ((10, 4500), 450)])
def test_topk_ties_break_as_the_reference(shape, k):
    """Integer-valued rows (many nonzero magnitudes tie, and they tie at
    the k-th): the same indices in the same order as ``jax.lax.top_k``
    (magnitude descending, the lower index first among ties), and the same
    values, row by row."""
    if shape == (8,):
        rows = np.array([1, 3, -2, 2, 3, -3, 2, 0.5], np.float32)
    else:
        rng = np.random.default_rng(k)
        rows = rng.integers(-6, 7, shape).astype(np.float32)
    vals, idx = gc.topk_sparsify(_t(rows), k)
    flat = rows.reshape(-1, rows.shape[-1])
    for i, row in enumerate(flat):
        jv, ji = jgc.topk_sparsify(jnp.asarray(row), k)
        assert idx.reshape(-1, k)[i].tolist() == np.asarray(ji).tolist()
        assert vals.reshape(-1, k)[i].tolist() == np.asarray(jv).tolist()
    if shape == (8,):
        assert idx.tolist() == [1, 4]


@pytest.mark.parametrize("k", [7, 192])
def test_topk_payload_and_reconstruction_are_the_references(k):
    """Distinct magnitudes (no ties): the same entries, values and
    reconstruction as the reference; stacked rows give one payload a
    row, and their fixed-order sum is the reference's scatter-add of the
    concatenated payloads."""
    rng = np.random.default_rng(k)
    rows = rng.standard_normal((E, 192)).astype(np.float32)
    vals, idx = gc.topk_sparsify(_t(rows), k)
    assert vals.shape == (E, k) and idx.dtype == torch.int32
    for i in range(E):
        jv, ji = jgc.topk_sparsify(jnp.asarray(rows[i]), k)
        order = np.argsort(np.asarray(ji))
        assert sorted(idx[i].tolist()) == np.asarray(ji)[order].tolist()
        one_v, one_i = gc.topk_sparsify(_t(rows[i]), k)
        assert torch.equal(gc.topk_reconstruct(one_v, one_i, 192),
                           _t(jgc.topk_reconstruct(jv, ji, 192)))
    jv, ji = jax.vmap(lambda x: jgc.topk_sparsify(x, k))(jnp.asarray(rows))
    want = jgc.topk_reconstruct(jv, ji, 192)
    got = gc.topk_reconstruct(vals, idx, 192).sum(0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# The wire solver against the reference
# ---------------------------------------------------------------------------
WIRE = {
    "delay": dict(consensus_delay=1),
    "topk": dict(consensus_compress=0.1),
    "topk_delay": dict(consensus_compress=0.1, consensus_delay=1),
    "full_k": dict(consensus_compress=1.0),
    "delay_off": dict(consensus_delay=1, fused="off"),
    "topk_median": dict(consensus_compress=0.25,
                        aggregator="coordinate_median"),
    "screen_mean": dict(consensus_delay=1, divergence_screen=3.0),
}


def _cfgs(kw, rounds=40, rank=4):
    """(reference config, port config) of one wire case."""
    kw = dict(kw)
    frac = kw.pop("consensus_compress", None)
    jcfg = JConfig.tuned(rank, outer_iters=rounds, **kw, consensus_compress=(
        None if frac is None else jgc.CompressConfig(topk_frac=frac)))
    return jcfg, convert.config_from_reference(jcfg)


def _ref_solve(m, jcfg, clients, key, **kw):
    """The reference's problem and its solve (carry, finalize)."""
    p = jdcf.make_problem(m, jcfg, clients, key, **kw)
    solver = jdcf.make_solver(jcfg)
    carry, _ = jrt.run(solver, p, jcfg.outer_iters)
    return p, carry, solver.finalize(p, carry)


@pytest.mark.parametrize("case", sorted(WIRE))
def test_wire_solves_track_the_reference(problem, case):
    """tests/test_multihost.py's problem (E = 4, 40 rounds, the
    reference's key 1): every wire variant's U and L within 1e-4 of the
    reference's, and its wire carries: the error-feedback residuals and
    the pending delta (a round's small deltas: within 1e-4 of U's norm),
    the guard scalar (1e-4 relative) and its trip."""
    jcfg, cfg = _cfgs(WIRE[case])
    p, jcarry, (jl, _, ju, _) = _ref_solve(problem.m_obs, jcfg, E,
                                           jax.random.PRNGKey(1))
    port = convert.problem_from_reference(p, "cpu")
    solver = dcf_pca.make_solver(cfg)
    carry, _ = rt.run(solver, port, cfg.outer_iters)
    l, _, u, _ = solver.finalize(port, carry)
    assert _rel(u.numpy(), ju) < TRACK_TOL
    assert _rel(l.numpy(), jl) < TRACK_TOL
    assert sorted(carry) == sorted(jcarry)
    scale = np.linalg.norm(np.asarray(ju))
    for key in ("err", "pending"):
        if key in carry:
            diff = carry[key].numpy() - np.asarray(jcarry[key])
            assert np.linalg.norm(diff) / scale < TRACK_TOL, key
    if "pending" in carry:
        assert bool(carry["sync"]) == bool(jcarry["sync"])
        assert carry["sync"].shape == () and carry["sync"].dtype == torch.bool
        np.testing.assert_allclose(float(carry["guard"]),
                                   float(jcarry["guard"]), rtol=TRACK_TOL)


def test_composed_wire_tracks_the_reference():
    """tests/test_faults.py:148-166: the trimmed mean x top-k compression
    x a participation schedule x crash / stale / corrupt faults (96^2,
    rank 4, E = 8, 80 rounds): U within 1e-4 of the reference's, and the
    port's solve finite and under the reference's 0.5."""
    p = jgenerate(jax.random.PRNGKey(5), 96, 96, rank=4, sparsity=0.05)
    jcfg = dataclasses.replace(
        JConfig.tuned(4, outer_iters=80), aggregator="trimmed_mean",
        trim_frac=0.25, consensus_compress=jgc.CompressConfig(topk_frac=0.5))
    rng = np.random.default_rng(0)
    part = (rng.random((80, 8)) < 0.9).astype(np.float32)
    part[:, 0] = 1.0
    plan = jflt.FaultPlan.random(
        11, 80, 8, rates={"crash": 0.05, "stale": 0.1, "corrupt": 0.05})
    ref_p, _, (_, _, ju, _) = _ref_solve(
        p.m_obs, jcfg, 8, jax.random.PRNGKey(6), participation=part,
        faults=plan)
    port = convert.problem_from_reference(ref_p, "cpu")
    res = dcf_pca.solve_problem(port, convert.config_from_reference(jcfg))
    assert _rel(res.u.numpy(), ju) < TRACK_TOL
    err = float(metrics.relative_error(res.l, res.s, _t(p.l0), _t(p.s0)))
    assert np.isfinite(err) and err < 0.5


def _port_solve(m, cfg, **kw):
    return rpca.solve(m, method="dcf", cfg=cfg, num_clients=E, key=1,
                      device="cpu", **kw)


def _l0_err(res, p):
    return _rel(res.l.numpy(), np.asarray(p.l0))


def test_wire_meets_the_references_bars(problem):
    """tests/test_multihost.py:111-135 on the port's own solves: the dense
    wire under 1e-2, top-k at 0.1 within 2x of it, ``topk_frac=1.0``
    within 1e-4 of the dense L; the modelled traffic of each solve is
    recorded (rounds x bytes a round, the reference's model)."""
    m = _t(problem.m_obs)
    mh.consensus_traffic(reset=True)
    dense = _port_solve(m, DCFConfig.tuned(4, outer_iters=40))
    comp = _port_solve(m, _cfgs(WIRE["topk"])[1])
    full = _port_solve(m, _cfgs(WIRE["full_k"])[1])
    e_d, e_c = _l0_err(dense, problem), _l0_err(comp, problem)
    assert e_d < 1e-2 and e_c <= 2.0 * e_d
    np.testing.assert_allclose(full.l.numpy(), dense.l.numpy(), atol=1e-4)
    traffic = mh.consensus_traffic(reset=True)
    d = 64 * 4
    dense_b = 2 * d * 4
    topk_b = 8 * mh.topk_k(d, 0.1) * E
    assert traffic["solves"] == 3 and traffic["rounds"] == 120
    assert traffic["shipped_bytes"] == 40 * (dense_b + topk_b + 8 * d * E)
    assert traffic["achieved_ratio"] == 3 * 40 * dense_b / \
        traffic["shipped_bytes"]


def test_compressed_runs_are_bit_identical(problem):
    """No atomics: two compressed (and stale) solves give the same bits."""
    m = _t(problem.m_obs)
    cfg = _cfgs(WIRE["topk_delay"])[1]
    a, b = _port_solve(m, cfg), _port_solve(m, cfg)
    for x, y in ((a.l, b.l), (a.s, b.s), (a.u, b.u), (a.v, b.v),
                 (a.stats.residual, b.stats.residual)):
        assert torch.equal(x, y)


def test_stale_guard_trips_on_a_nan_scalar(problem):
    """A NaN in one client's data makes the epilogue's ||Psi||_F^2 NaN:
    the guard trips at once (NaN compares False, so growth alone would
    not) and stays tripped."""
    m = _t(problem.m_obs).clone()
    cfg = DCFConfig.tuned(4, outer_iters=3, consensus_delay=1)
    p = dcf_pca.make_problem(m, cfg, E, 1, device="cpu")
    p = p._replace(blocks=p.blocks.clone())
    p.blocks[2, 5, 3] = float("nan")
    solver = dcf_pca.make_solver(cfg)
    c = solver.init(p)
    for t in range(3):
        c = solver.step(p, c, torch.tensor(t, dtype=torch.int32))
        assert bool(c["sync"]) and not torch.isfinite(c["guard"])
    clean = dcf_pca.make_problem(_t(problem.m_obs), cfg, E, 1, device="cpu")
    c = solver.step(clean, solver.init(clean), torch.tensor(0))
    assert not bool(c["sync"]) and torch.isfinite(c["guard"])


@pytest.mark.parametrize("case", ["topk_delay", "topk_median"])
def test_wire_batch_matches_the_serial_solves(problem, case):
    """A wire batch (its carries with a leading problem axis, frozen by
    ``tree_where`` in while mode) against the port's serial solves: the
    reference's batch tolerance (1e-3) and the same exit rounds."""
    _, cfg = _cfgs(WIRE[case], rounds=20)
    ms = [problem.m_obs, jgenerate(jax.random.PRNGKey(2), 64, 64, 3,
                                   0.05).m_obs]
    mb = torch.stack([_t(x) for x in ms])
    own = rpca.solve(mb, method="dcf", cfg=cfg, num_clients=E, key=4,
                     run="early", device="cpu")
    for b in range(2):
        ser = rpca.solve(mb[b], method="dcf", cfg=cfg, num_clients=E,
                         key=4 + b, run="early", device="cpu")
        np.testing.assert_allclose(own.l[b].numpy(), ser.l.numpy(),
                                   atol=1e-3, rtol=0)
        assert int(own.stats.rounds[b]) == int(ser.stats.rounds)


def _wire_cfgs():
    """tests/test_faults.py:250-261's configurations."""
    base = DCFConfig.tuned(3, outer_iters=20)
    comp = gc.CompressConfig(topk_frac=0.5)
    return {"dense": base,
            "compress_ef": dataclasses.replace(base, consensus_compress=comp),
            "compress_delay": dataclasses.replace(
                base, consensus_compress=comp, consensus_delay=1)}


@pytest.mark.parametrize("wire", sorted(_wire_cfgs()))
def test_wire_carries_resume_bit_exact(tmp_path, monkeypatch, wire):
    """tests/test_faults.py:263-282 on the port: a segmented wire solve
    killed after its first snapshot and resumed gives the uninterrupted
    solve's L, S, U, V and traces bit for bit, the error-feedback
    residuals, the pending delta, the 0-d bool ``sync`` and an ``inf``
    guard included."""
    cfg = _wire_cfgs()[wire]
    p = jgenerate(jax.random.PRNGKey(7), 64, 64, rank=3, sparsity=0.05)
    m = _t(p.m_obs)
    run = rt.RunConfig(mode="scan", checkpoint_every=7)
    full = _port_solve(m, cfg, run=run, checkpoint_dir=str(tmp_path / "a"))

    class Killed(Exception):
        pass

    def killed(t, carry):
        if "guard" in carry:
            assert carry["sync"].dtype == torch.bool
        raise Killed

    saved = rt.run_segmented
    with monkeypatch.context() as patch:
        patch.setattr(rt, "run_segmented",
                      lambda *a, **k: saved(*a, save_extra=killed, **k))
        with pytest.raises(Killed):
            _port_solve(m, cfg, run=run, checkpoint_dir=str(tmp_path / "b"))
    assert ckpt.latest_step(str(tmp_path / "b")) == 7
    res = _port_solve(m, cfg, run=run, resume_from=str(tmp_path / "b"))
    for name in ("l", "s", "u", "v"):
        assert torch.equal(getattr(full, name), getattr(res, name)), name
    assert torch.equal(full.stats.objective, res.stats.objective)
    assert torch.equal(full.stats.residual, res.stats.residual)


def test_wire_carry_with_an_inf_guard_round_trips(tmp_path):
    """The stale carry right after init (guard inf, sync False, pending
    zero) saves and restores leaf for leaf: the dict by sorted keys, the
    0-d bool and the inf kept."""
    cfg = DCFConfig.tuned(3, outer_iters=4, consensus_delay=1,
                          consensus_compress=gc.CompressConfig(topk_frac=0.5))
    p = dcf_pca.make_problem(torch.randn(16, 16), cfg, E, 0, device="cpu")
    carry = dcf_pca.make_solver(cfg).init(p)
    ckpt.save(str(tmp_path), 1, {"carry": carry})
    back, _ = ckpt.restore(str(tmp_path), {"carry": carry})
    for key in carry:
        for x, y in zip(ckpt._flatten(back["carry"][key]),
                        ckpt._flatten(carry[key])):
            assert x[0] == y[0] and torch.equal(x[1], y[1])
    assert back["carry"]["sync"].dtype == torch.bool
    assert torch.isinf(back["carry"]["guard"])
