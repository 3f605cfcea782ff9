"""The port's multi-process harness (``repro_torch.distributed.multihost``)
on the CPU, against the behaviour tests/test_multihost.py asks of the
reference's: the bootstrap's bounded retries, the relaunch after a lost
coordinator port, the multi-process gate, the NCCL refusal on a shared
card, a two-rank solve whose ranks hold one consensus U, and the kill ->
respawn -> resume drill, bit for bit against the uninterrupted solve.

The workers are real processes in one gloo process group
(``launch_workers``); each imports torch and the port only.
"""
import time
import types

import pytest
import torch
import torch.distributed as dist

from repro_torch import rpca
from repro_torch.distributed import multihost as mh


# ---------------------------------------------------------------------------
# bootstrap and harness faults (unit, monkeypatched)
# ---------------------------------------------------------------------------
def test_bootstrap_retries_with_backoff(monkeypatch):
    """tests/test_multihost.py:357-402: a failed connect is retried with
    exponential backoff, at most ``connect_attempts`` times, with the
    bounded timeout; a live default group is never retried."""
    calls, sleeps = [], []

    def flaky(backend, **kw):
        calls.append((backend, kw))
        if len(calls) < 3:
            raise RuntimeError("DistNetworkError: connection refused")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", flaky)
    monkeypatch.setattr(mh.time, "sleep", sleeps.append)
    mh.bootstrap("127.0.0.1:1", 2, 0, "gloo", backoff_s=0.05)
    assert len(calls) == 3
    assert sleeps == [0.05, 0.1]  # exponential
    backend, kw = calls[0]
    assert backend == "gloo" and kw["init_method"] == "tcp://127.0.0.1:1"
    assert (kw["world_size"], kw["rank"]) == (2, 0)
    assert kw["timeout"].total_seconds() == 120

    calls.clear()

    def down(backend, **kw):
        calls.append(kw)
        raise RuntimeError("DistNetworkError: connection refused")

    monkeypatch.setattr(dist, "init_process_group", down)
    with pytest.raises(RuntimeError, match="refused"):
        mh.bootstrap("127.0.0.1:1", 2, 0, "gloo", connect_attempts=2,
                     backoff_s=0.05)
    assert len(calls) == 2  # bounded


def test_live_group_is_never_retried(monkeypatch):
    """A process bootstraps once: with a live default group, or when the
    runtime says it is initialised twice, nothing is retried."""
    calls = []
    monkeypatch.setattr(mh.time, "sleep", lambda s: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: calls.append(k))
    with pytest.raises(RuntimeError, match="only be called once"):
        mh.bootstrap("127.0.0.1:1", 2, 0, "gloo")
    assert calls == []

    def twice(backend, **kw):
        calls.append(kw)
        raise ValueError("trying to initialize the default process group "
                         "twice!")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", twice)
    with pytest.raises(ValueError, match="twice"):
        mh.bootstrap("127.0.0.1:1", 2, 0, "gloo")
    assert len(calls) == 1


def test_launch_relaunches_after_a_bind_race(monkeypatch):
    """tests/test_multihost.py:405-443 with torch's words: a cohort that
    lost its coordinator port (TCPStore: EADDRINUSE, "address already in
    use") is relaunched on a fresh port; other failures and exhausted
    retries surface unchanged."""
    attempts = []

    def racy(code, n, backend, timeout, env, kills):
        attempts.append(kills)
        if len(attempts) == 1:
            raise RuntimeError(
                "worker 0 exited 1:\nDistNetworkError: The server socket "
                "has failed to listen on any local network address. port: "
                "12345, useIpv6: false, code: -98, name: EADDRINUSE, "
                "message: address already in use")
        return ["OK"] * n

    monkeypatch.setattr(mh, "_launch_once", racy)
    monkeypatch.setattr(mh.time, "sleep", lambda s: None)
    assert mh.launch_workers("pass", num_processes=2,
                             backend="gloo") == ["OK", "OK"]
    assert len(attempts) == 2

    attempts.clear()

    def always(code, n, backend, timeout, env, kills):
        attempts.append(kills)
        raise RuntimeError("name: EADDRINUSE, message: address already in "
                           "use")

    monkeypatch.setattr(mh, "_launch_once", always)
    with pytest.raises(RuntimeError, match="address already in use"):
        mh.launch_workers("pass", num_processes=2, backend="gloo",
                          bind_retries=2)
    assert len(attempts) == 3  # the first try and two retries

    attempts.clear()

    def crashy(code, n, backend, timeout, env, kills):
        attempts.append(kills)
        raise RuntimeError("worker 1 exited 1: boom")

    monkeypatch.setattr(mh, "_launch_once", crashy)
    with pytest.raises(RuntimeError, match="boom"):
        mh.launch_workers("pass", num_processes=2, backend="gloo")
    assert len(attempts) == 1  # not a bind race: no relaunch


def test_multiprocess_mesh_gate():
    """tests/test_multihost.py:271-291: a mesh of more than one rank is
    refused for solvers without supports_multiprocess, with the
    reference's words (the runtime named torch.distributed)."""
    two = types.SimpleNamespace(mesh=torch.arange(2))
    assert mh.is_multiprocess_mesh(two)
    assert not mh.is_multiprocess_mesh(types.SimpleNamespace(
        mesh=torch.arange(1)))
    assert not mh.is_multiprocess_mesh(None)
    entry = types.SimpleNamespace(
        name="fake", caps=rpca.SolverCaps(supports_sharding=True))
    spec = types.SimpleNamespace(
        m_obs=torch.zeros(4, 4), mask=None, num_clients=None,
        participation=None, mesh=two, batched=False)
    with pytest.raises(ValueError, match="multi-process") as got:
        rpca._check_caps(entry, spec)
    assert str(got.value) == (
        "method 'fake' does not support multi-process meshes "
        "(torch.distributed); methods with multi-process meshes "
        "(torch.distributed): dcf_sharded")
    ok = types.SimpleNamespace(
        name="fake", caps=rpca.SolverCaps(supports_sharding=True,
                                          supports_multiprocess=True))
    rpca._check_caps(ok, spec)  # no raise
    assert rpca.get_solver("dcf_sharded").caps.supports_multiprocess


def test_nccl_refused_on_a_shared_card(monkeypatch):
    """NCCL refuses two ranks on one device: asking for it with more local
    ranks than cards raises, naming the limit; gloo is the default there,
    NCCL where every rank has a card, gloo without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 local ranks but 1 CUDA"):
        mh.check_backend("nccl", 2)
    with pytest.raises(ValueError, match="at most one rank a card"):
        mh.launch_workers("pass", num_processes=2, backend="nccl")
    mh.check_backend("nccl", 1)
    mh.check_backend("gloo", 10)
    assert mh.default_backend(1) == "nccl"
    assert mh.default_backend(2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mh.default_backend(1) == "gloo"
    with pytest.raises(ValueError, match="0 CUDA"):
        mh.check_backend("nccl", 1)


# ---------------------------------------------------------------------------
# real worker cohorts (gloo, CPU)
# ---------------------------------------------------------------------------
_COMMON = """
import hashlib, os, signal
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import rpca
from repro_torch.core import metrics
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.distributed.grad_compress import CompressConfig
from repro_torch.training import checkpoint as ckpt
mesh = _mh.multihost_mesh(device="cpu")
p = prob.generate_problem(0, 48, 64, 3, 0.05, device="cpu")


def sha(x):
    return hashlib.sha256(x.numpy().tobytes()).hexdigest()
"""


def _lines(out: str, tag: str) -> list[list[str]]:
    return [ln.split()[1:] for ln in out.splitlines()
            if ln.startswith(tag + " ")]


@pytest.fixture(scope="module")
def drill(tmp_path_factory):
    """One two-rank cohort for the tests below (each cohort start costs
    seconds): the kill -> respawn -> resume drill, then, in the respawned
    cohort, tests/test_multihost.py:299-352's two solves.  In the first
    cohort rank 0 dies (SIGKILL) right after its third snapshot (round 60
    of 240, every 20) and rank 1, waiting in a collective, fails on the
    lost connection; ``launch_workers`` respawns the cohort
    (``max_restarts=1``); its output is the respawned cohort's."""
    d = tmp_path_factory.mktemp("drill")
    return mh.launch_workers(_COMMON + """
ckdir = os.environ["DRILL_CKPT"]
died = ckdir + ".died"
resume = ckdir if os.path.exists(os.path.join(ckdir, "LATEST")) else None
if not os.path.exists(died) and dist.get_rank() == 0:
    save = ckpt.save

    def save_then_die(d, step, tree, **kw):
        out = save(d, step, tree, **kw)
        if step >= 60:
            open(died, "w").close()
            os.kill(os.getpid(), signal.SIGKILL)
        return out

    ckpt.save = save_then_die
cfg = DCFConfig.tuned(4, outer_iters=240)
res = rpca.solve(rpca.RPCASpec(p.m_obs, mesh=mesh, key=1,
                               checkpoint_dir=ckdir, resume_from=resume),
                 method="dcf_sharded", cfg=cfg, device="cpu",
                 run=rt.RunConfig(mode="scan", checkpoint_every=20))
plain = rpca.solve(rpca.RPCASpec(p.m_obs, mesh=mesh, key=1),
                   method="dcf_sharded", cfg=cfg, device="cpu")
print("MODE", "resumed" if resume else "cold", ckpt.latest_step(ckdir)
      if resume else -1)
print("HASH", sha(res.u), sha(res.l), sha(plain.u), sha(plain.l))

cfg = DCFConfig.tuned(4, outer_iters=30)
res = rpca.solve(rpca.RPCASpec(p.m_obs, mesh=mesh, key=1),
                 method="dcf_sharded", cfg=cfg, device="cpu")
err = metrics.low_rank_relative_error(res.l, p.l0).item()
print("DENSE", sha(res.u), repr(err), res.l.shape[1])
ccfg = DCFConfig.tuned(4, outer_iters=30,
                       consensus_compress=CompressConfig(topk_frac=0.1))
res2 = rpca.solve(rpca.RPCASpec(p.m_obs, mesh=mesh, key=1),
                  method="dcf_sharded", cfg=ccfg, device="cpu")
print("COMPRESSED", sha(res2.u),
      repr(metrics.low_rank_relative_error(res2.l, p.l0).item()))
""", num_processes=2, timeout=300, backend="gloo",
        extra_env={"DRILL_CKPT": str(d / "ck")}, max_restarts=1)


def test_two_rank_dense_solve(drill):
    """tests/test_multihost.py:299-352 on the port: two ranks solve
    tests/test_multihost.py's problem over a (2,) mesh; both hold the same
    U (SHA-256) and error, and the compressed wire recovers (< 0.05) over
    the real process boundary."""
    (d0,), (d1,) = _lines(drill[0], "DENSE"), _lines(drill[1], "DENSE")
    assert d0 == d1 and d0[2] == "64"
    assert float(d0[1]) < 0.05
    (c0,), (c1,) = (_lines(drill[0], "COMPRESSED"),
                    _lines(drill[1], "COMPRESSED"))
    assert c0 == c1 and float(c0[1]) < 0.05


def test_kill_respawn_resume_bitexact(drill):
    """tests/test_multihost.py:446-571 on the port (the ``drill``
    fixture): the respawned ranks resume from the latest durable snapshot
    (round 60 or later), and the finished L and U are bit-identical to an
    uninterrupted solve of the same problem on the same mesh."""
    for out in drill:
        (mode,) = _lines(out, "MODE")
        assert mode[0] == "resumed"
        assert 60 <= int(mode[1]) < 240
        (h,) = _lines(out, "HASH")
        assert h[0] == h[2] and h[1] == h[3]  # resumed == uninterrupted
    assert _lines(drill[0], "HASH") == _lines(drill[1], "HASH")


def test_kill_after_respawns_the_cohort():
    """``kill_after`` SIGKILLs the named ranks on the first launch only
    (here while they start or wait: a rank that reaches its code before
    the kill's time waits past it); ``max_restarts`` respawns the whole
    cohort on a fresh port, which starts after the kill and runs to its
    end."""
    kill_s = 1.5
    outs = mh.launch_workers("""
import os, time
import torch
import torch.distributed as dist
if time.time() < float(os.environ["KILL_AT"]):
    time.sleep(60)
t = torch.ones(1)
dist.all_reduce(t)
print("DONE", int(t.item()))
""", num_processes=2, timeout=120, backend="gloo",
        extra_env={"KILL_AT": str(time.time() + kill_s)},
        kill_after={0: kill_s, 1: kill_s}, max_restarts=1)
    assert [_lines(o, "DONE") for o in outs] == [[["2"]], [["2"]]]
