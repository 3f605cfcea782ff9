"""The port's async gateway (``repro_torch.serving.gateway``) against the
JAX reference's (``repro.serving.gateway``), on the CPU: the counterparts
of tests/test_gateway.py's gateway tests and tests/test_faults.py's
divergence test.

Both gateways get the same numpy planes.  Held equal to the reference's:
the admission order under stride fairness and priority, the queue depth
and pool occupancy at which ``QueueFull`` sheds (with its words), the
eager ``ValueError`` text, the padding and pool accounting, the metrics'
keys, and the ``SolverDiverged`` outcome.  Held bit for bit: a
single-page gateway against the port's own ``RPCAService`` (same key,
same admission order, same planes).  The paged lanes, started from the
reference's factors, are held to the reference's responses within 1e-4 of
max|L| and to the reference test's recovery bar.  24 x 16 at r = 3, as the reference's
tests (tests/test_gateway.py:29).
"""
import asyncio
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import QueueFull as JQueueFull
from repro.core.validate import SolverDiverged as JSolverDiverged
from repro.core.factorized import DCFConfig as JConfig
from repro.core.ialm import IALMConfig as JIALM
from repro.serving import gateway as jgw
from repro_torch import convert
from repro_torch.core import validate
from repro_torch.core.factorized import DCFConfig
from repro_torch.core.ialm import IALMConfig
from repro_torch.serving import gateway as gw_mod
from repro_torch.serving import rpca_service as svc_mod

jcf = importlib.import_module("repro.core.cf_pca")

CPU = "cpu"
M, N, RANK = 24, 16, 3
CFG, JCFG = DCFConfig.tuned(rank=RANK), JConfig.tuned(rank=RANK)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread beside JAX's (tests/test_torch_convex.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gen(n_cols, seed=0, m=M, poison=False):
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((m, RANK)) @ rng.standard_normal((RANK, n_cols))
    out = (low + (rng.random((m, n_cols)) < 0.05) * 3.0).astype(np.float32)
    if poison:
        out[3, 5] = np.nan
    return out


def _kw(**kw):
    kw.setdefault("slots", 4)
    kw.setdefault("rounds_per_tick", 8)
    kw.setdefault("max_rounds", 96)
    return kw


def _port(n=N, cfgs=None, **kw):
    return gw_mod.RPCAGateway(M, n, CFG, gw_mod.GatewayConfig(**_kw(**kw)),
                              cfgs=cfgs, device=CPU)


def _ref(n=N, cfgs=None, **kw):
    return jgw.RPCAGateway(M, n, JCFG, jgw.GatewayConfig(**_kw(**kw)),
                           cfgs=cfgs)


def test_gateway_config_is_the_references():
    from dataclasses import fields

    assert [(f.name, f.default) for f in fields(gw_mod.GatewayConfig)] == \
        [(f.name, f.default) for f in fields(jgw.GatewayConfig)]
    assert [(f.name, f.default) for f in fields(svc_mod.RPCAServiceConfig)
            ] == [(f.name, f.default) for f in fields(
                __import__("repro.serving.rpca_service", fromlist=["x"])
                .RPCAServiceConfig)]


def test_single_page_gateway_is_the_service_bit_for_bit():
    """tests/test_gateway.py:143-164 on the port: page_cols = n, so every
    request spans one page and lands in one full-width lane, and the
    gateway reproduces the port's RPCAService bit for bit."""
    mats = [_gen(N, seed=1), _gen(10, seed=2), _gen(N, seed=3)]
    mask = (np.random.default_rng(9).random((M, N)) < 0.8).astype(
        np.float32)
    svc = svc_mod.RPCAService(M, N, CFG, svc_mod.RPCAServiceConfig(
        **_kw()), key=7, device=CPU)
    direct = svc.solve_all(list(mats), masks={0: mask})
    gw = gw_mod.RPCAGateway(M, N, CFG, gw_mod.GatewayConfig(**_kw()), key=7,
                            device=CPU)
    via = gw.solve_all(list(mats), masks={0: mask})
    for d, g in zip(direct, via, strict=True):
        assert g.method == d.method and g.rounds == d.rounds
        assert g.converged == d.converged
        for name in ("l", "s", "u", "v"):
            assert torch.equal(getattr(g, name), getattr(d, name)), name


@pytest.fixture
def reference_factors(monkeypatch):
    """Test-only: every ``cf`` lane builds its slot problems with the
    reference's hook at the reference's key (the i-th submission of a
    width class at ``fold_in(PRNGKey(0), i)``, as each of the reference's
    width-class services draws it), carried over by
    ``convert.problem_from_reference``."""
    from repro_torch import rpca

    entry = rpca.get_solver("cf")
    jkey = jax.random.PRNGKey(0)

    def make_problem(m_obs, cfg, key, warm, mask, device):
        ref = jcf._service_problem(
            jnp.asarray(np.array(m_obs)), JCFG, jax.random.fold_in(jkey, key),
            None if warm is None else tuple(jnp.asarray(np.array(w))
                                            for w in warm),
            None if mask is None else jnp.asarray(np.array(mask)))
        return convert.problem_from_reference(ref, device)

    hooks = dataclasses.replace(entry.service, make_problem=make_problem)
    monkeypatch.setitem(rpca.SOLVERS, "cf",
                        dataclasses.replace(entry, service=hooks))


def _paged(make):
    rng = np.random.default_rng(1)

    async def go():
        async with make(32, page_cols=8, pool_pages=16, max_queue=8,
                        max_rounds=200) as gw:
            truths, tickets = [], []
            for n_req in (8, 12, 32):
                low = rng.standard_normal((M, RANK)) @ \
                    rng.standard_normal((RANK, n_req))
                truths.append(low.astype(np.float32))
                tickets.append(await gw.submit(truths[-1]))
            resps = [await t for t in tickets]
            assert sorted(gw._services) == [8, 16, 32]
            return truths, resps

    return asyncio.run(go())


def test_paged_mixed_widths_recover_as_the_reference(reference_factors):
    """tests/test_gateway.py:167-192: page_cols < n, requests land in
    page-span lanes (8, 16 and 32 columns) and recover their low-rank
    planes within the reference test's 5e-2.  From the reference's
    initial factors: at 24 x 8-32 the recovery depends on the draw in
    both packages (the reference's own gateway misses 5e-2 at keys 1, 2
    and 4), so the port's lanes start where the reference's do, and each
    response is held to the reference's within 1e-4 of max|L|."""
    truths, resps = _paged(_port)
    _, want = _paged(_ref)
    for truth, resp, ref in zip(truths, resps, want):
        assert tuple(resp.l.shape) == truth.shape
        assert resp.rounds == ref.rounds and resp.converged
        rel = np.linalg.norm(resp.l.numpy() - truth)
        assert rel / np.linalg.norm(truth) < 5e-2
        scale = float(np.abs(np.asarray(ref.l)).max())
        for name in ("l", "s", "u", "v"):
            np.testing.assert_allclose(
                getattr(resp, name).numpy(), np.asarray(getattr(ref, name)),
                rtol=0, atol=1e-4 * scale, err_msg=name)


def _shed_run(make, queue_full):
    async def go():
        async with make(slots=2, max_queue=3, pool_pages=8) as gw:
            accepted, shed, words = [], 0, set()
            for i in range(9):
                try:
                    accepted.append(await gw.submit(_gen(N, seed=i)))
                except queue_full as e:
                    shed += 1
                    words.add(str(e))
            mets = gw.metrics()
            out = (shed, len(accepted), mets["shed"], mets["queue_depth"],
                   sorted(words))
            for t in accepted:
                assert tuple((await t).l.shape) == (M, N)
            return out + (gw.metrics()["completed"],)

    return asyncio.run(go())


def test_backpressure_sheds_as_the_reference():
    """tests/test_gateway.py:195-215: past max_queue, submit raises
    QueueFull (a CapacityError) at the reference's depth, with its
    words; accepted work completes."""
    got = _shed_run(_port, validate.QueueFull)
    assert got == _shed_run(_ref, JQueueFull)
    assert got[:4] == (6, 3, 6, 3) and got[-1] == 3
    assert issubclass(validate.QueueFull, validate.CapacityError)


def test_pool_exhaustion_sheds_as_the_reference():
    """tests/test_gateway.py:218-230: the staging pool is the second
    admission-control surface."""

    def run(make, queue_full):
        async def go():
            async with make(32, page_cols=8, pool_pages=2,
                            max_queue=64) as gw:
                await gw.submit(_gen(16, seed=0))
                with pytest.raises(queue_full, match="page pool") as e:
                    await gw.submit(_gen(8, seed=1))
                return str(e.value), gw.metrics()["shed"], \
                    gw.metrics()["pool"]

        return asyncio.run(go())

    assert run(_port, validate.QueueFull) == run(_ref, JQueueFull)


def _admissions(make, ialm_cfg):
    mats_cf = [_gen(N, seed=i) for i in range(4)]
    mats_ia = [_gen(N, seed=10 + i) for i in range(2)]

    async def go():
        async with make(cfgs={"ialm": ialm_cfg}, slots=8, max_queue=16,
                        lane_weights=(("cf", 2.0), ("ialm", 1.0))) as gw:
            tickets = [await gw.submit(m) for m in mats_cf]
            tickets += [await gw.submit(m, method="ialm") for m in mats_ia]
            for t in tickets:
                await t
            return list(gw.admissions)

    return asyncio.run(go())


def test_fairness_admits_in_the_references_order():
    """tests/test_gateway.py:233-256: cf weighted 2x over ialm, every
    request queued before the loop runs: the stride interleave, the same
    as the reference's and the same on a second run."""
    got = _admissions(_port, IALMConfig())
    assert got == _admissions(_ref, JIALM()) == [0, 4, 1, 2, 5, 3]
    assert _admissions(_port, IALMConfig()) == got


def test_priority_preempts_fifo_as_the_reference():
    """tests/test_gateway.py:259-272."""

    def run(make):
        async def go():
            async with make(slots=1, max_queue=8) as gw:
                low = [await gw.submit(_gen(N, seed=i)) for i in range(2)]
                high = await gw.submit(_gen(N, seed=9), priority=1)
                for t in [*low, high]:
                    await t
                return list(gw.admissions), [high.id, low[0].id, low[1].id]

        return asyncio.run(go())

    got = run(_port)
    assert got == run(_ref) and got[0] == got[1]


@pytest.mark.parametrize("case", ["rows", "method", "mask", "columns"])
def test_never_valid_requests_raise_eagerly_as_the_reference(case):
    """tests/test_gateway.py:275-300: ValueError at submit() with the
    reference's words, before queueing: no shed, no ticket, no page."""

    def run(make):
        async def go():
            async with make() as gw:
                with pytest.raises(ValueError) as e:
                    if case == "rows":
                        await gw.submit(_gen(N, m=M + 1))
                    elif case == "method":
                        await gw.submit(_gen(N), method="dcf")
                    elif case == "mask":
                        await gw.submit(_gen(N), mask=np.ones((M, N - 1)))
                    else:
                        await gw.submit(_gen(N + 1))
                mets = gw.metrics()
                return (str(e.value), mets["submitted"], mets["shed"],
                        mets["pool"]["entries"])

        return asyncio.run(go())

    got = run(_port)
    assert got == run(_ref) and got[1:] == (0, 0, 0)


def test_lifecycle_errors_read_as_the_references():
    gw, jg = _port(), _ref()
    with pytest.raises(RuntimeError, match="not running") as got:
        asyncio.run(gw.submit(_gen(N)))
    with pytest.raises(RuntimeError) as want:
        asyncio.run(jg.submit(_gen(N)))
    assert str(got.value) == str(want.value)
    for kw in (dict(page_cols=N + 1), dict(page_cols=0), dict(max_queue=0)):
        with pytest.raises(ValueError) as got:
            _port(**kw)
        with pytest.raises(ValueError) as want:
            _ref(**kw)
        assert str(got.value) == str(want.value)


def test_warm_refresh_and_mixed_methods():
    """tests/test_gateway.py:303-322: a warm-started refresh converges in
    fewer rounds, a per-request method routes to its lane."""

    async def go():
        async with _port(cfgs={"ialm": IALMConfig()}) as gw:
            mat = _gen(N, seed=5)
            cold = await (await gw.submit(mat))
            warm = await (await gw.submit(mat, warm=(cold.u, cold.v)))
            assert warm.converged and warm.rounds < cold.rounds
            ia = await (await gw.submit(_gen(N, seed=6), method="ialm"))
            assert ia.method == "ialm" and ia.v is None
            lanes = gw.metrics()["lanes"]
            assert f"cf@{N}" in lanes and f"ialm@{N}" in lanes

    asyncio.run(go())


def _keys(tree):
    return {k: _keys(v) for k, v in tree.items()} if isinstance(
        tree, dict) else None


def test_metrics_and_snapshot_hook_are_the_references():
    """tests/test_gateway.py:325-359: occupancy and the padding accounting
    while solves are in flight equal the reference's, latency percentiles
    after completion, the snapshot hook, and the metrics' keys."""

    def run(make):
        snaps = []

        async def go():
            async with make(32, page_cols=8, pool_pages=16, max_queue=8,
                            tol=1e-12, snapshot_every=1) as gw:
                gw._snapshot_hook = snaps.append
                t1 = await gw.submit(_gen(5, seed=1))
                t2 = await gw.submit(_gen(32, seed=2))
                while gw.metrics()["in_flight"] < 2:
                    await asyncio.sleep(0)
                mets = gw.metrics()
                flight = (mets["padding"], mets["lanes"], mets["pool"])
                await t1
                await t2
                done = gw.metrics()
                assert done["latency"]["count"] == 2
                assert done["latency"]["p99_ms"] >= \
                    done["latency"]["p50_ms"] > 0
                assert done["rounds_total"] > 0
                assert done["pool"]["entries"] == 0
                return flight, _keys(done)

        out = asyncio.run(go())
        assert snaps and all("queue_depth" in s for s in snaps)
        return out

    (pad, lanes, pool), keys = run(_port)
    assert ((pad, lanes, pool), keys) == run(_ref)
    assert pad["allocated_bytes"] == (8 + 32) * M * 4
    assert pad["waste_ratio"] == pytest.approx(40 / 37)
    assert pad["homogeneous_ratio"] == pytest.approx(64 / 40)


@pytest.mark.parametrize("dtype", ["float64", "bfloat16"])
def test_dense_fallback_for_foreign_dtypes(dtype):
    """tests/test_gateway.py:362-373: a plane the f32 pool cannot hold
    (float64; a bf16 tensor, which numpy lacks) stages dense and solves."""
    plane = _gen(N, seed=8)
    plane = plane.astype(np.float64) if dtype == "float64" else \
        torch.from_numpy(plane).to(torch.bfloat16)

    async def go():
        async with _port() as gw:
            resp = await (await gw.submit(plane))
            assert tuple(resp.l.shape) == (M, N)
            assert torch.isfinite(resp.l).all()
            assert gw.metrics()["pool"]["entries"] == 0

    asyncio.run(go())


def test_aclose_cancels_queued():
    """tests/test_gateway.py:376-389."""

    async def go():
        gw = _port(slots=1, max_queue=4, tol=1e-12)
        await gw.start()
        tickets = [await gw.submit(_gen(N, seed=i)) for i in range(3)]
        await gw.aclose()
        assert sum(t._future.cancelled() for t in tickets) >= 2
        assert gw._pool.used_pages == 0

    asyncio.run(go())


def test_divergence_maps_to_the_typed_error_as_the_reference():
    """tests/test_faults.py:408-424: a poisoned tenant's ticket raises
    SolverDiverged with the reference's words while its co-resident
    completes."""

    def run(make, diverged):
        async def go():
            async with make() as gw:
                t_good = await gw.submit(_gen(N, seed=0))
                t_bad = await gw.submit(_gen(N, seed=1, poison=True))
                resp = await t_good
                with pytest.raises(diverged, match="rounds") as e:
                    await t_bad
                assert np.isfinite(np.asarray(resp.l)).all()
                return str(e.value), gw.metrics()["diverged"]

        return asyncio.run(go())

    got = run(_port, validate.SolverDiverged)
    assert got == run(_ref, JSolverDiverged) and got[1] == 1
