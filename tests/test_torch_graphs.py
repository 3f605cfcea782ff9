"""The runtime's captured rounds on the CPU: the static-buffer logic that
a CUDA graph replays, with the capture replaced by eager calls.

On the card ``core.runtime`` captures one round over static buffers and
replays it (tests/test_torch_gpu.py holds the replays to the eager bits
there).  Here ``CapturedRound`` is swapped for a stand-in that runs the
round at each "replay", so the static carry, the copies at the round's
end, the round index on the device and the traces written at it run on
the CPU: every solver and run mode gives the eager run's bits, and the
eager run gives the reference's results (the port's solves against the
reference: tests/test_torch_solve.py and its neighbours).  Also the
static property that decides what is captured, and the copy rules.
"""
import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core import generate_problem as jgenerate
from repro.core import runtime as jrt
from repro.core.factorized import DCFConfig as JConfig
from repro_torch import convert
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.distributed.faults import FaultPlan
from repro_torch.distributed.grad_compress import CompressConfig

cf_pca = importlib.import_module("repro_torch.core.cf_pca")
dcf_pca = importlib.import_module("repro_torch.core.dcf_pca")
apgm = importlib.import_module("repro_torch.core.apgm")
ialm = importlib.import_module("repro_torch.core.ialm")
jdcf = importlib.import_module("repro.core.dcf_pca")

CPU = torch.device("cpu")
M, N, RANK, E, T = 48, 40, 3, 4, 9


class _EagerCapture:
    """``CapturedRound`` with each replay an eager call of the round."""

    def __init__(self, fn, device):
        fn()
        self.fn = fn
        rt.graph_counts["captures"] += 1

    def replay(self):
        self.fn()
        rt.graph_counts["replays"] += 1


@pytest.fixture
def fake_graphs(monkeypatch):
    """Capturable solvers take the static, captured path on the CPU."""
    monkeypatch.setattr(rt, "CapturedRound", _EagerCapture)
    monkeypatch.setattr(
        rt, "use_graph",
        lambda solver, device, eager, rounds: (
            solver.capturable and not eager
            and rounds >= rt.MIN_GRAPH_ROUNDS))
    rt.reset_graph_counts()
    yield
    rt.reset_graph_counts()


def _case(case):
    """``(solver, problem, rounds)`` of a small solve on the CPU."""
    masked = case in ("dual", "compact")
    p = prob.generate_problem(0, M, N - (case == "ragged"), RANK, 0.05,
                              observed_frac=0.8 if masked else 1.0,
                              device=CPU)
    if case in ("apgm", "ialm"):
        mod = apgm if case == "apgm" else ialm
        cfg = (apgm.APGMConfig(iters=T) if case == "apgm"
               else ialm.IALMConfig(iters=T))
        return mod.make_solver(cfg), mod._problem(p.m_obs, None), T
    kw = {"dual": dict(fused="dual"),
          "compact": dict(fused="dual", pack_mask=True, lam_sample=512),
          "off": dict(fused="off"),
          "wire": dict(consensus_delay=1,
                       consensus_compress=CompressConfig(topk_frac=0.2)),
          "faulted": dict(aggregator="trimmed_mean")}.get(case, {})
    cfg = DCFConfig.tuned(RANK, outer_iters=T, track_objective=True, **kw)
    if case == "cf":
        return (cf_pca.make_solver(cfg),
                cf_pca.make_problem(p.m_obs, cfg, 0, device=CPU), T)
    m_obs = p.m_obs.to(torch.bfloat16) if case == "compact" else p.m_obs
    extra = {}
    if case == "faulted":
        extra = dict(faults=FaultPlan.byzantine(T, E, (2,), kind="corrupt"),
                     participation=0.75)
    problem = dcf_pca.make_problem(m_obs, cfg, E, 0,
                                   mask=p.mask if masked else None,
                                   device=CPU, **extra)
    return dcf_pca.make_solver(cfg), problem, T


def _leaves_equal(a, b):
    la, lb = rt.leaves(a), rt.leaves(b)
    assert len(la) == len(lb)
    return all(torch.equal(x, y) for x, y in zip(la, lb))


CAPTURABLE = ["cf", "dcf", "off", "dual", "compact", "ragged", "wire",
              "faulted"]


@pytest.mark.parametrize("case", CAPTURABLE + ["apgm", "ialm"])
def test_capturable_is_a_static_property_of_the_solver(case):
    """The factorized solvers (every flavour, the wire and the faulted
    engine) can be captured; IALM and APGM, whose SVD reads cuSOLVER's
    status on the host every iteration, cannot."""
    solver, _, _ = _case(case)
    assert solver.capturable is (case in CAPTURABLE)
    cuda = torch.device("cuda")
    assert rt.use_graph(solver, cuda, False, T) is solver.capturable
    assert not rt.use_graph(solver, cuda, True, T)
    assert not rt.use_graph(solver, CPU, False, T)
    # Two rounds: the warm-up and one replay, which would not pay.
    assert not rt.use_graph(solver, cuda, False, rt.MIN_GRAPH_ROUNDS - 1)


@pytest.mark.parametrize("mode", ["scan", "while", "chunk"])
@pytest.mark.parametrize("case", CAPTURABLE)
def test_static_rounds_give_the_eager_bits(fake_graphs, case, mode):
    """The captured path's buffers and copies, replayed eagerly: carry,
    finalize output and stats bit for bit as the eager run, one capture
    and one replay for every later round run."""
    solver, problem, t = _case(case)
    run_cfg = rt.RunConfig(mode=mode, tol=1e-3, chunk_size=3, min_iters=2)
    want_c, want_s = rt.run(solver, problem, t, run_cfg, eager=True)
    assert rt.graph_counts["captures"] == 0
    got_c, got_s = rt.run(solver, problem, t, run_cfg)
    assert _leaves_equal(got_c, want_c) and _leaves_equal(got_s, want_s)
    assert _leaves_equal(solver.finalize(problem, got_c),
                         solver.finalize(problem, want_c))
    rounds = int(got_s.rounds)
    assert rt.graph_counts["captures"] == 1
    assert rt.graph_counts["replays"] == rounds - 1


@pytest.mark.parametrize("case", ["apgm", "ialm"])
def test_static_buffers_take_a_carry_passed_on_to_another_field(
        fake_graphs, case):
    """APGM's round hands ``l`` on as ``l_prev`` (and ``t_nes`` as
    ``t_prev``): copied into static buffers, the passed-on value is read
    before anything is written, so the static run keeps the eager bits
    (the rounds forced onto the captured path, which these solvers never
    take by themselves)."""
    solver, problem, t = _case(case)
    want = rt.run(solver, problem, t, eager=True)
    rounds = rt.Rounds(rt.single_body(solver, problem),
                       rt.single_state(solver, problem, t), CPU, graph=True)
    got = rt.drive(rounds, rt.FIXED, t)
    assert _leaves_equal(got, want)


@pytest.mark.parametrize("mode", ["scan", "while", "chunk"])
def test_static_batch_rounds_give_the_eager_bits(fake_graphs, mode):
    """A batch's done mask, freeze and per-problem rounds inside the
    captured round: the eager bits, the host reading all(done) once a
    round or chunk."""
    cfg = DCFConfig.tuned(RANK, outer_iters=30)
    m = torch.stack([prob.generate_problem(i, M, N - 1, RANK, 0.05,
                                           device=CPU).m_obs
                     for i in range(3)])
    batch = dcf_pca.make_batch(m, cfg, E, 0, device=CPU)
    solver = dcf_pca.make_solver(cfg)
    run_cfg = rt.RunConfig(mode=mode, tol=2e-3, chunk_size=4)
    want = rt.solve_batch(solver, batch, 30, run_cfg, eager=True)
    got = rt.solve_batch(solver, batch, 30, run_cfg)
    assert _leaves_equal(got, want)
    assert rt.graph_counts["captures"] == 1
    if mode != "scan":
        assert int(got[2].rounds.max()) < 30


def test_static_segments_resume_bit_exact(fake_graphs, tmp_path):
    """A segmented solve on the static path, interrupted after its first
    snapshot and resumed: the eager unsegmented solve's bits."""
    solver, problem, t = _case("wire")
    want_c, want_s = rt.run(solver, problem, t, eager=True)

    class Interrupt(Exception):
        pass

    def stop(step, carry):
        raise Interrupt

    run_cfg = rt.RunConfig(checkpoint_every=4)
    with pytest.raises(Interrupt):
        rt.run_segmented(solver, problem, t, run_cfg,
                         checkpoint_dir=str(tmp_path), save_extra=stop)
    got_c, got_s = rt.run_segmented(solver, problem, t, run_cfg,
                                    resume_from=str(tmp_path))
    assert _leaves_equal(got_c, want_c) and _leaves_equal(got_s, want_s)


def test_static_solve_tracks_the_reference(fake_graphs):
    """The reference's problem through the static path: the consensus U
    within 1e-4 relative of the reference's run (the tracking bar of
    tests/test_torch_solve.py)."""
    jp = jgenerate(jax.random.PRNGKey(7), 64, 64, 3, 0.05)
    jcfg = JConfig.tuned(3, outer_iters=6)
    ref_problem = jdcf.make_problem(jp.m_obs, jcfg, E, jax.random.PRNGKey(0))
    carry, _ = jrt.run(jdcf.make_solver(jcfg), ref_problem, 6)
    port = convert.problem_from_reference(ref_problem, "cpu")
    cfg = convert.config_from_reference(jcfg)
    got, _ = rt.run(dcf_pca.make_solver(cfg), port, 6)
    want = np.asarray(carry.u)
    assert np.linalg.norm(got.u.numpy() - want) / np.linalg.norm(want) \
        <= 1e-4
    assert rt.graph_counts["captures"] == 1


def test_copy_into_rules():
    """Copies skip a leaf that is its own destination, read a source that
    is another destination before writing, and refuse a changed shape."""
    a, b = torch.arange(3.0), torch.arange(3.0) + 10
    dst = {"x": a, "y": b}
    rt.copy_into(dst, {"x": b, "y": a})  # a swap through the buffers
    assert a.tolist() == [10.0, 11.0, 12.0] and b.tolist() == [0.0, 1.0,
                                                              2.0]
    rt.copy_into(dst, {"x": a, "y": b})  # no-op
    assert a.tolist() == [10.0, 11.0, 12.0]
    with pytest.raises(ValueError, match="carry leaf"):
        rt.copy_into({"x": a}, {"x": torch.zeros(4)})


def test_host_counters_are_one_registry():
    """The kernels' launch counters and the collectives' call and byte
    counters (not their seconds) are registered in ``repro_torch.counters``,
    the one registry ``CapturedRound`` reads: what a capture counted is
    taken back, and every replay adds it again."""
    from repro_torch import counters
    from repro_torch.distributed import multihost as mh
    from repro_torch.kernels import ops as kops

    assert {"launches", "wire"} <= set(counters.snapshot())
    assert "seconds" not in counters.snapshot()["wire"]
    before = counters.snapshot()
    kops.add_launch_counts({"huber_contract_v": 3})
    mh.add_wire_counts({"all_reduce_calls": 1, "all_reduce_bytes": 64,
                        "seconds": 0.5})
    moved = counters.since(before)
    assert moved == {"launches": {"huber_contract_v": 3},
                     "wire": {"all_reduce_calls": 1, "all_reduce_bytes": 64}}
    counters.add(moved, -1)  # the capture's counts taken back
    assert counters.since(before) == {}
    counters.add(moved)  # two replays
    counters.add(moved)
    assert counters.since(before) == {
        "launches": {"huber_contract_v": 6},
        "wire": {"all_reduce_calls": 2, "all_reduce_bytes": 128}}
    counters.add(moved, -2)
