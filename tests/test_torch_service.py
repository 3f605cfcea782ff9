"""The port's slot service (``repro_torch.serving.rpca_service``) against the
JAX reference's (``repro.serving.rpca_service``), on the CPU.

Both services get the same numpy inputs.  For cold ``cf`` starts the
port's lane builds each slot problem through the reference's own hook
(``_with_reference_factors``: ``repro.core.cf_pca._service_problem`` at
the reference's key, carried over by ``convert.problem_from_reference``),
so the initial factors match; that is a test-only substitution and the
program is unchanged.  Bars: ``l``, ``s``, ``u`` and ``v`` within 1e-4 of
max|L| of the reference's (fp32 in another order over up to 100 rounds;
tests/test_torch_compile_cache.py's tracking bar), ``rounds`` and
``converged`` equal; the convex lanes within 1e-5 of max|L|; error text
word for word; the lam-cache and compile-cache counters equal under the
reference tests' sequences (tests/test_compile_cache.py:314-385).  The
port's own pairs hold bit for bit: the all-ones mask against no mask, a
quarantined slot's neighbour against a solo run, and (with the capture
replaced by eager calls, as tests/test_torch_graphs.py does) the static
buffers a card lane replays against eager ticks.  Shapes are the reference
tests' (24 x 16 at r = 3, 48 x 40); the card's own checks are in
tests/test_torch_gpu.py and ``chip_smoke.py``.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compile_cache as jcc
from repro.core import generate_problem as jgenerate
from repro.core.apgm import APGMConfig as JAPGM
from repro.core.factorized import DCFConfig as JConfig
from repro.core.ialm import IALMConfig as JIALM
from repro.serving import rpca_service as jsvc
from repro_torch import convert, rpca
from repro_torch.core import compile_cache as cc
from repro_torch.core import runtime as rt
from repro_torch.core import validate
from repro_torch.core.apgm import APGMConfig
from repro_torch.core.factorized import DCFConfig
from repro_torch.core.ialm import IALMConfig
from repro_torch.distributed import multihost as mh
from repro_torch.serving import rpca_service as svc_mod

jcf = importlib.import_module("repro.core.cf_pca")

CPU = "cpu"
TRACK = 1e-4
CONVEX_TOL = 1e-5
M, N, RANK = 24, 16, 3  # tests/test_gateway.py:29, tests/test_faults.py:335


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread beside JAX's (tests/test_torch_convex.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def caches(monkeypatch):
    """Fresh process-default compile caches on both sides."""
    port, ref = cc.CompileCache(), jcc.CompileCache()
    monkeypatch.setattr(cc, "_DEFAULT_CACHE", port)
    monkeypatch.setattr(jcc, "_DEFAULT_CACHE", ref)
    return port, ref


def _plane(n_cols, seed=0, m=M, poison=False):
    """tests/test_gateway.py's and tests/test_faults.py's tenant plane."""
    rng = np.random.default_rng(seed)
    low = rng.standard_normal((m, RANK)) @ rng.standard_normal((RANK, n_cols))
    out = (low + (rng.random((m, n_cols)) < 0.05) * 3.0).astype(np.float32)
    if poison:
        out[3, 5] = np.nan
    return out


def _np(x):
    return None if x is None else np.array(x)


def _with_reference_factors(svc, jcfg, jkey=None):
    """Test-only: the port's ``cf`` lane builds each slot problem with the
    reference's hook at the reference's key (``fold_in(key, i)`` for the
    i-th submission, as the reference's service draws it), so both start
    from the same factors and threshold."""
    jkey = jax.random.PRNGKey(0) if jkey is None else jkey
    lane = svc._lanes["cf"]

    def make_problem(m_obs, cfg, key, warm, mask, device):
        jc = jcfg if cfg.lam is None else dataclasses.replace(jcfg,
                                                              lam=cfg.lam)
        ref = jcf._service_problem(
            jnp.asarray(_np(m_obs)), jc, jax.random.fold_in(jkey, key),
            None if warm is None else tuple(jnp.asarray(_np(w))
                                            for w in warm),
            None if mask is None else jnp.asarray(_np(mask)))
        return convert.problem_from_reference(ref, device)

    lane.hooks = dataclasses.replace(lane.hooks, make_problem=make_problem)
    return svc


def _close(got, want, bar=TRACK):
    """Every field of a port response against the reference's."""
    assert got.method == want.method
    assert got.rounds == want.rounds and got.converged == want.converged
    assert got.diverged == want.diverged
    scale = float(np.abs(np.asarray(want.l)).max())
    for name in ("l", "s", "u", "v"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is None:
            continue
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=bar * scale, err_msg=name)


def _same_bits(a, b):
    assert a.rounds == b.rounds and a.converged == b.converged
    for name in ("l", "s", "u", "v"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name


def _drain(svc, slots):
    """tests/test_faults.py:352's drain: tick and poll until every slot in
    ``slots`` answered."""
    pending, resps = set(slots), {}
    for _ in range(64):
        if not pending:
            break
        svc.tick()
        for s in list(pending):
            r = svc.poll(s)
            if r is not None:
                resps[s] = r
                pending.remove(s)
    assert not pending
    return resps


def _raises_alike(call_port, call_ref, port_type=ValueError,
                  ref_type=ValueError):
    with pytest.raises(port_type) as got:
        call_port()
    with pytest.raises(ref_type) as want:
        call_ref()
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The registry's service hooks
# ---------------------------------------------------------------------------
def test_service_hooks_are_registered_as_the_references():
    assert "ServiceHooks" in rpca.__all__
    fields = [f.name for f in dataclasses.fields(rpca.ServiceHooks)]
    from repro import rpca as jrpca

    assert fields == [f.name for f in dataclasses.fields(
        jrpca.ServiceHooks)]
    assert rpca.methods_with("supports_service") == ["apgm", "cf", "ialm"]
    for name in ("cf", "ialm", "apgm"):
        assert isinstance(rpca.get_solver(name).service, rpca.ServiceHooks)
    assert rpca.get_solver("ialm").service.default_cfg is IALMConfig
    assert rpca.get_solver("apgm").service.cfg_type is APGMConfig
    for name in ("dcf", "dcf_sharded"):
        _raises_alike(
            lambda: svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                                        method=name, device=CPU),
            lambda: jsvc.RPCAService(M, N, JConfig.tuned(RANK),
                                     method=name))


def test_empty_slot_tables_are_the_references():
    """An empty table: zero data, factors, lam0 and t0, an all-ones mask
    plane, packed under pack_mask; the convex lanes' zero planes."""
    for kw in ({}, {"pack_mask": True}):
        cfg, jcfg = DCFConfig.tuned(RANK, **kw), JConfig.tuned(RANK, **kw)
        got = rpca.get_solver("cf").service.empty_problems(cfg, 3, M, N, CPU)
        want = jcf._service_empty(jcfg, 3, M, N)
        for name in got._fields:
            a, b = getattr(got, name), np.asarray(getattr(want, name))
            assert tuple(a.shape) == b.shape and np.array_equal(a.numpy(),
                                                                b), name
    for name, cfg in (("ialm", IALMConfig()), ("apgm", APGMConfig())):
        p = rpca.get_solver(name).service.empty_problems(cfg, 2, M, N, CPU)
        assert p.mask.sum() == 2 * M * N and p.m_obs.abs().sum() == 0
        ptrs = {x.untyped_storage().data_ptr() for x in rt.leaves(p)}
        assert len(ptrs) == len(rt.leaves(p))  # one buffer a field


# ---------------------------------------------------------------------------
# Continuous batching and the warm refresh (tests/test_runtime.py:186)
# ---------------------------------------------------------------------------
CB_M, CB_N, CB_SCFG = 48, 40, dict(slots=3, rounds_per_tick=10,
                                   max_rounds=100, tol=5e-4)


@pytest.fixture(scope="module")
def batching():
    """Five problems drained through three slots, then a warm refresh of
    the first with perturbed data, on both services."""
    probs = [jgenerate(jax.random.PRNGKey(i), CB_M, CB_N, RANK, 0.05)
             for i in range(5)]
    mats = [np.array(p.m_obs) for p in probs]
    pert = np.array(probs[0].m_obs + 0.01 * jax.random.normal(
        jax.random.PRNGKey(99), probs[0].m_obs.shape))
    jcfg = JConfig.tuned(RANK)
    ref = jsvc.RPCAService(CB_M, CB_N, jcfg,
                           jsvc.RPCAServiceConfig(**CB_SCFG))
    want = ref.solve_all(mats)
    port = _with_reference_factors(
        svc_mod.RPCAService(CB_M, CB_N, DCFConfig.tuned(RANK),
                            svc_mod.RPCAServiceConfig(**CB_SCFG),
                            device=CPU), jcfg)
    got = port.solve_all(mats)

    def refresh(svc, resp):
        slot = svc.try_submit(pert, warm=(resp.u, resp.v))
        while svc.pending():
            svc.tick()
        out = svc.poll(slot)
        svc.release(slot)
        return out

    return dict(probs=probs, got=got, want=want,
                got_refresh=refresh(port, got[0]),
                want_refresh=refresh(ref, want[0]))


def _recovery(resp, p):
    l0, s0 = np.asarray(p.l0), np.asarray(p.s0)
    return (np.linalg.norm(np.asarray(resp.l) - l0)
            + np.linalg.norm(np.asarray(resp.s) - s0)) / (
        np.linalg.norm(l0) + np.linalg.norm(s0))


@pytest.mark.parametrize("index", range(5))
def test_continuous_batching_is_the_references(batching, index):
    """Each response within the tracking bar of the reference's, with its
    rounds and verdict, and its recovery error within 1% of the
    reference's (at 48 x 40, r = 3 the reference's own error is ~1e-3,
    not the 1e-4 of tests/test_runtime.py's 96 x 96, r = 5)."""
    got, want = batching["got"][index], batching["want"][index]
    assert got.converged
    _close(got, want)
    p = batching["probs"][index]
    want_err = _recovery(want, p)
    assert abs(_recovery(got, p) - want_err) <= 1e-2 * want_err


def test_warm_refresh_is_the_references(batching):
    """A warm start continues the schedule: under a third of the cold
    rounds, as the reference's."""
    got, want = batching["got_refresh"], batching["want_refresh"]
    assert got.rounds < batching["got"][0].rounds // 3
    _close(got, want)


# ---------------------------------------------------------------------------
# Ragged widths, masks, quarantine
# ---------------------------------------------------------------------------
def test_ragged_width_is_trimmed_and_warm_starts():
    """tests/test_elastic.py:224-246 at 24 x 16: a 10-column tenant is
    padded behind mask-zero columns, trimmed back at poll, and its
    trimmed factors warm-start a refresh at the same width; both against
    the reference's."""
    jcfg = JConfig.tuned(RANK)
    scfg = dict(slots=2, rounds_per_tick=8, max_rounds=200)
    ref = jsvc.RPCAService(M, N, jcfg, jsvc.RPCAServiceConfig(**scfg))
    port = _with_reference_factors(
        svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                            svc_mod.RPCAServiceConfig(**scfg), device=CPU),
        jcfg)
    plane = _plane(10, seed=2)
    out = []
    for svc in (port, ref):
        cold = _drain(svc, [svc.try_submit(plane)])
        cold = next(iter(cold.values()))
        svc.release(0)
        warm = _drain(svc, [svc.try_submit(plane, warm=(cold.u, cold.v))])
        out.append((cold, next(iter(warm.values()))))
    (cold, warm), (jcold, jwarm) = out
    assert tuple(cold.l.shape) == tuple(cold.s.shape) == (M, 10)
    assert tuple(cold.v.shape) == (10, RANK)
    assert warm.rounds <= cold.rounds
    _close(cold, jcold)
    _close(warm, jwarm)


def test_all_ones_mask_is_the_maskless_solve_bit_for_bit():
    """tests/test_masked.py:320-337 on the port: a maskless submission and
    the same plane under an all-ones mask give the same bits."""
    scfg = svc_mod.RPCAServiceConfig(slots=2, rounds_per_tick=8,
                                     max_rounds=48)
    cfg = DCFConfig.tuned(RANK, outer_iters=40)
    plane = _plane(N, seed=4)
    a = svc_mod.RPCAService(M, N, cfg, scfg, device=CPU)
    b = svc_mod.RPCAService(M, N, cfg, scfg, device=CPU)
    ra = _drain(a, [a.try_submit(plane)])[0]
    rb = _drain(b, [b.try_submit(plane, mask=np.ones_like(plane))])[0]
    _same_bits(ra, rb)


def test_quarantine_leaves_the_neighbour_bit_for_bit():
    """tests/test_faults.py:371-405: the poisoned slot is flagged diverged
    (as the reference's), its lam entry evicted, the co-resident tenant's
    answer is byte-identical to a solo run of the port, and the slot is
    reusable."""
    scfg = dict(slots=4, rounds_per_tick=8, max_rounds=96)
    cfg, jcfg = DCFConfig.tuned(RANK), JConfig.tuned(RANK)
    solo = svc_mod.RPCAService(M, N, cfg, svc_mod.RPCAServiceConfig(**scfg),
                               key=21, device=CPU)
    want = _drain(solo, [solo.try_submit(_plane(N, seed=0))])[0]

    svc = svc_mod.RPCAService(M, N, cfg, svc_mod.RPCAServiceConfig(**scfg),
                              key=21, device=CPU)
    good = svc.try_submit(_plane(N, seed=0))
    bad = svc.try_submit(_plane(N, seed=1, poison=True))
    fp_bad = svc._slot_lam_fp[bad]
    resps = _drain(svc, [good, bad])

    jsv = jsvc.RPCAService(M, N, jcfg, jsvc.RPCAServiceConfig(**scfg),
                           key=jax.random.PRNGKey(21))
    jgood = jsv.try_submit(_plane(N, seed=0))
    jbad = jsv.try_submit(_plane(N, seed=1, poison=True))
    jresps = _drain(jsv, [jgood, jbad])

    for slot, jslot in ((good, jgood), (bad, jbad)):
        assert resps[slot].diverged == jresps[jslot].diverged
        assert resps[slot].converged == jresps[jslot].converged
    assert resps[bad].diverged and not resps[bad].converged
    assert fp_bad not in svc._lam_cache
    assert svc.metrics()["diverged"] == 1
    assert not resps[good].diverged
    for name in ("l", "s", "u", "v"):
        a = getattr(resps[good], name).numpy()
        assert a.tobytes() == getattr(want, name).numpy().tobytes(), name
    svc.release(bad)
    again = svc.try_submit(_plane(N, seed=2))
    r2 = _drain(svc, [again])[again]
    assert not r2.diverged and torch.isfinite(r2.l).all()


# ---------------------------------------------------------------------------
# The lam cache, the compile cache and metrics (tests/test_compile_cache.py)
# ---------------------------------------------------------------------------
def _cache_pair(scfg=None):
    scfg = scfg or dict(slots=3, rounds_per_tick=4, max_rounds=40)
    port = svc_mod.RPCAService(48, 40, DCFConfig.tuned(4, outer_iters=40),
                               svc_mod.RPCAServiceConfig(**scfg), device=CPU)
    ref = jsvc.RPCAService(48, 40, JConfig.tuned(4, outer_iters=40),
                           jsvc.RPCAServiceConfig(**scfg))
    return port, ref


def _counts(svc):
    out = svc.metrics()
    cache = dict(out["compile_cache"])
    cache.pop("bytes")  # XLA's memory_analysis against device bytes
    return {"compile_cache": cache, "lam_cache": out["lam_cache"]}


def _cache_problem():
    p = jgenerate(jax.random.PRNGKey(0), 48, 40, 4, 0.1, observed_frac=0.8)
    return np.array(p.m_obs), np.array(p.mask)


def test_second_service_counts_as_the_references(caches):
    """tests/test_compile_cache.py:314-331: a second service of the same
    geometry builds nothing; the counters equal the reference's at every
    step."""
    m_obs, mask = _cache_problem()
    port, ref = _cache_pair()
    assert _counts(port) == _counts(ref)
    for svc in (port, ref):
        slot = svc.submit(m_obs, mask=mask)
        while svc.pending():
            svc.tick()
        assert svc.poll(slot) is not None
    assert _counts(port) == _counts(ref)
    compiles = caches[0].stats.compiles
    assert compiles > 0
    port2, ref2 = _cache_pair()
    for svc in (port2, ref2):
        slot = svc.submit(m_obs.copy(), mask=mask.copy())
        while svc.pending():
            svc.tick()
        assert svc.poll(slot) is not None
    assert _counts(port2) == _counts(ref2)
    assert caches[0].stats.compiles == compiles


def test_lam_calibration_cache_counts_as_the_references(caches):
    """tests/test_compile_cache.py:334-373's sequence on both services: a
    warm refresh of the same (M, mask) hits, release() evicts by
    refcount, other data misses."""
    m_obs, mask = _cache_problem()
    port, ref = _cache_pair()
    slots = {}
    for name, svc in (("port", port), ("ref", ref)):
        slot = svc.submit(m_obs, mask=mask)
        while svc.pending():
            svc.tick()
        slots[name] = [slot, svc.poll(slot)]
    assert _counts(port) == _counts(ref)
    assert port.metrics()["lam_cache"] == {"hits": 0, "misses": 1,
                                           "entries": 1}
    for name, svc in (("port", port), ("ref", ref)):
        slot, r1 = slots[name]
        slot2 = svc.submit(m_obs, warm=(r1.u, r1.v), mask=mask)
        svc.release(slot)
        while svc.pending():
            svc.tick()
        r2 = svc.poll(slot2)
        assert r2.converged
        slot3 = svc.submit(m_obs * 2.0, mask=mask)
        slots[name] = [slot2, slot3]
    assert _counts(port) == _counts(ref)
    assert port.metrics()["lam_cache"] == {"hits": 1, "misses": 2,
                                           "entries": 2}
    for name, svc in (("port", port), ("ref", ref)):
        svc.release(slots[name][0])
    assert _counts(port) == _counts(ref)
    assert port.metrics()["lam_cache"]["entries"] == 1
    for name, svc in (("port", port), ("ref", ref)):
        svc.release(slots[name][1])
    assert _counts(port) == _counts(ref)
    assert port.metrics()["lam_cache"]["entries"] == 0


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ if isinstance(tree, bool) else None


def test_metrics_have_the_references_keys(caches):
    """tests/test_compile_cache.py:376-383 and tests/test_multihost.py:239:
    the same keys (the consensus traffic counters included) and the same
    values on a fresh service."""
    port, ref = _cache_pair()
    got, want = port.metrics(), ref.metrics()
    assert _keys(got) == _keys(want)
    assert {k: got[k] for k in ("slots", "active", "pending", "diverged",
                                "lanes")} == \
        {k: want[k] for k in ("slots", "active", "pending", "diverged",
                              "lanes")}
    assert got["compile_cache"]["entries"] == len(caches[0])
    assert got["compile_cache"]["compiles"] == caches[0].stats.compiles
    assert got["consensus"] == mh.consensus_traffic()
    for key in ("bytes_per_round", "achieved_ratio", "shipped_bytes"):
        assert key in got["consensus"]


# ---------------------------------------------------------------------------
# The convex lanes and per-slot methods (tests/test_api.py:325-347)
# ---------------------------------------------------------------------------
def test_convex_lanes_are_the_references():
    """An ialm and an apgm lane (one masked tenant) beside the cf default:
    L and S within 1e-5 of max|L| of the reference's, the same rounds, and
    bit for bit the port's serial solve of as many iterations (the lane
    adds nothing to the solver).  The budget is tests/test_torch_convex.py's
    ~30 iterations: run on to 96, APGM's iterates at 24 x 16 drift to 2.9e-5
    of max|L| from the reference's in the serial solves as much as in the
    lanes (continuation shrinks mu to 1e-5 of its start, where the fp32
    SVDs' differences grow)."""
    scfg = dict(slots=3, rounds_per_tick=8, max_rounds=32)
    port = svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                               svc_mod.RPCAServiceConfig(**scfg),
                               cfgs={"ialm": IALMConfig(),
                                     "apgm": APGMConfig()}, device=CPU)
    ref = jsvc.RPCAService(M, N, JConfig.tuned(RANK),
                           jsvc.RPCAServiceConfig(**scfg),
                           cfgs={"ialm": JIALM(), "apgm": JAPGM()})
    mask = (np.random.default_rng(5).random((M, N)) < 0.8).astype(
        np.float32)
    tenants = [(_plane(N, seed=1), None, "ialm"),
               (_plane(N, seed=2), mask, "apgm")]
    out = []
    for svc in (port, ref):
        slots = [svc.try_submit(x, mask=w, method=meth)
                 for x, w, meth in tenants]
        assert svc.metrics()["lanes"] == {"cf": 0, "ialm": 1, "apgm": 1}
        resps = _drain(svc, slots)
        out.append([resps[s] for s in slots])
    for got, want, (x, w, meth) in zip(*out, tenants):
        assert got.u is None and got.v is None
        _close(got, want, CONVEX_TOL)
        cfg = (IALMConfig if meth == "ialm" else APGMConfig)(iters=got.rounds)
        serial = rpca.solve(torch.from_numpy(x), method=meth, cfg=cfg,
                            mask=None if w is None else torch.from_numpy(w),
                            device=CPU)
        assert torch.equal(got.l, serial.l) and torch.equal(got.s, serial.s)


def test_per_slot_methods_and_their_refusals_read_as_the_references():
    cfg, jcfg = DCFConfig.tuned(RANK, outer_iters=150), \
        JConfig.tuned(RANK, outer_iters=150)
    port = svc_mod.RPCAService(M, N, cfg, svc_mod.RPCAServiceConfig(
        slots=3, max_rounds=200), device=CPU)
    ref = jsvc.RPCAService(M, N, jcfg, jsvc.RPCAServiceConfig(
        slots=3, max_rounds=200))
    _raises_alike(lambda: port.submit(_plane(N), method="dcf_sharded"),
                  lambda: ref.submit(_plane(N), method="dcf_sharded"))
    _raises_alike(
        lambda: svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                                    method="ialm", device=CPU),
        lambda: jsvc.RPCAService(M, N, JConfig.tuned(RANK), method="ialm"))
    _raises_alike(
        lambda: svc_mod.RPCAService(
            M, N, cfg, cfgs={"apgm": cfg}, device=CPU).submit(
                _plane(N), method="apgm"),
        lambda: jsvc.RPCAService(M, N, jcfg, cfgs={"apgm": jcfg}).submit(
            _plane(N), method="apgm"))
    # Convex lanes validate their (L, S) warm layout eagerly.
    bad = (np.zeros((M, N - 1), np.float32), np.zeros((M, N), np.float32))
    _raises_alike(lambda: port.submit(_plane(N), warm=bad, method="ialm"),
                  lambda: ref.submit(_plane(N), warm=bad, method="ialm"))
    bad_uv = (np.zeros((M, RANK + 1), np.float32),
              np.zeros((N, RANK), np.float32))
    _raises_alike(lambda: port.submit(_plane(N), warm=bad_uv),
                  lambda: ref.submit(_plane(N), warm=bad_uv))


@pytest.mark.parametrize("shape,mask_shape", [((M + 1, N), None),
                                              ((M, N + 1), None),
                                              ((M, 0), None),
                                              ((M, N), (M, N - 1))])
def test_never_valid_submissions_read_as_the_references(shape, mask_shape):
    """tests/test_elastic.py:249-261: ValueError with the reference's
    words, before any slot is taken."""
    port = svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK, outer_iters=20),
                               svc_mod.RPCAServiceConfig(slots=2),
                               device=CPU)
    ref = jsvc.RPCAService(M, N, JConfig.tuned(RANK, outer_iters=20),
                           jsvc.RPCAServiceConfig(slots=2))
    x = np.zeros(shape, np.float32)
    mask = None if mask_shape is None else np.ones(mask_shape, np.float32)
    _raises_alike(lambda: port.submit(x, mask=mask),
                  lambda: ref.submit(x, mask=mask))
    assert port.free_slots() == 2


def test_capacity_is_typed_and_release_decrements_lanes():
    """tests/test_gateway.py:375-398: CapacityError at a full table with
    the reference's words, the deprecated shim's None and warning, lane
    occupancy through release, and the double-release refusal."""
    port = svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                               svc_mod.RPCAServiceConfig(slots=2,
                                                         rounds_per_tick=8,
                                                         max_rounds=96),
                               device=CPU)
    ref = jsvc.RPCAService(M, N, JConfig.tuned(RANK),
                           jsvc.RPCAServiceConfig(slots=2, rounds_per_tick=8,
                                                  max_rounds=96))
    from repro.core import CapacityError as JCapacityError

    for svc in (port, ref):
        svc.try_submit(_plane(N, seed=0))
        svc.try_submit(_plane(N, seed=1), method="ialm")
        assert svc.free_slots() == 0
        assert svc.metrics()["lanes"] == {"cf": 1, "ialm": 1}
    _raises_alike(lambda: port.try_submit(_plane(N, seed=2)),
                  lambda: ref.try_submit(_plane(N, seed=2)),
                  validate.CapacityError, JCapacityError)
    with pytest.warns(DeprecationWarning, match="try_submit"):
        assert port.submit(_plane(N, seed=2)) is None
    for svc in (port, ref):
        svc.release(1)
        assert svc.metrics()["lanes"] == {"cf": 1, "ialm": 0}
        svc.release(0)
        assert svc.metrics()["lanes"] == {"cf": 0, "ialm": 0}
    for slot in (0, 99):
        _raises_alike(lambda: port.release(slot), lambda: ref.release(slot))
        _raises_alike(lambda: port.poll(slot), lambda: ref.poll(slot))


def test_results_survive_the_next_admission_and_tick():
    """A response's tensors are fresh: releasing its slot, admitting
    another tenant there and ticking leave them as they were."""
    svc = svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                              svc_mod.RPCAServiceConfig(slots=1,
                                                        rounds_per_tick=8,
                                                        max_rounds=96),
                              device=CPU)
    first = _drain(svc, [svc.try_submit(_plane(N, seed=0))])[0]
    kept = [x.clone() for x in (first.l, first.s, first.u, first.v)]
    svc.release(0)
    svc.try_submit(_plane(N, seed=1))
    svc.tick()
    for a, b in zip((first.l, first.s, first.u, first.v), kept):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", ["seed", "generator"])
def test_key_draws_each_submission_in_order(form):
    """``key`` as a seed gives submission i the initial factors of seed key
    + i (``rpca.batch_keys``); as a ``torch.Generator``, the generator's
    draws one submission after the other."""
    from repro_torch.core import factorized as fz
    from repro_torch.core import problems as prob

    key = 5 if form == "seed" else torch.Generator().manual_seed(5)
    svc = svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                              svc_mod.RPCAServiceConfig(slots=3), key=key,
                              device=CPU)
    for i in range(3):
        svc.try_submit(_plane(N, seed=i))
    in_order = torch.Generator().manual_seed(5)
    carry = svc._lanes["cf"].carry
    for i in range(3):
        gen = prob.generator(5 + i) if form == "seed" else in_order
        want = fz.init_state(gen, M, N, RANK, torch.device(CPU))
        assert torch.equal(carry.u[i], want.u)
        assert torch.equal(carry.v[i], want.v)


# ---------------------------------------------------------------------------
# The static buffers a card lane replays, with eager calls for the capture
# ---------------------------------------------------------------------------
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
def fake_graphs(monkeypatch, caches):
    """``cf`` lanes take the captured static-buffer path on the CPU."""
    monkeypatch.setattr(rt, "CapturedRound", _EagerCapture)
    monkeypatch.setattr(
        rt, "use_graph",
        lambda solver, device, eager, rounds: (
            solver.capturable and not eager
            and rounds >= rt.MIN_GRAPH_ROUNDS))
    rt.reset_graph_counts()
    yield
    rt.reset_graph_counts()


def _graph_service(eager=False, key=3):
    return svc_mod.RPCAService(
        M, N, DCFConfig.tuned(RANK),
        svc_mod.RPCAServiceConfig(slots=3, rounds_per_tick=8, max_rounds=96),
        key=key, cfgs={"ialm": IALMConfig()}, device=CPU, eager=eager)


def _mixed_run(svc):
    """Continuous refill with a ragged, a masked and an ialm tenant."""
    mats = [_plane(N, seed=0), _plane(10, seed=1), _plane(N, seed=2),
            _plane(N, seed=3), _plane(N, seed=4)]
    mask = (np.random.default_rng(6).random((M, N)) < 0.8).astype(
        np.float32)
    return svc.solve_all(mats, masks={2: mask}, methods={3: "ialm"})


def test_replayed_ticks_are_the_eager_ticks(fake_graphs):
    """The static slot table, its counters and ``active`` (what a card
    lane captures) give the eager ticks' bits; one capture, a replay a
    round of every cf tick."""
    eager = _mixed_run(_graph_service(eager=True))
    assert rt.graph_counts["captures"] == 0
    replayed = _mixed_run(_graph_service())
    assert rt.graph_counts["captures"] == 1
    assert rt.graph_counts["replays"] % 8 == 0
    for a, b in zip(eager, replayed, strict=True):
        assert a.method == b.method
        _same_bits(a, b)


def test_two_services_share_one_captured_tick(fake_graphs):
    """A second service of the same geometry captures nothing; ticking the
    two in turn (each tick swaps the shared static buffers' owner) gives
    each service the bits it gives alone."""
    alone = []
    for seed in (0, 5):
        svc = _graph_service(key=seed)
        alone.append(_drain(svc, [svc.try_submit(_plane(N, seed=seed)),
                                  svc.try_submit(_plane(N, seed=seed + 1))]))
    rt.reset_graph_counts()
    a, b = _graph_service(key=0), _graph_service(key=5)
    assert rt.graph_counts["captures"] == 0
    slots = {}
    for svc, seed in ((a, 0), (b, 5)):
        slots[id(svc)] = [svc.try_submit(_plane(N, seed=seed)),
                          svc.try_submit(_plane(N, seed=seed + 1))]
    got = {id(a): {}, id(b): {}}
    for _ in range(64):
        for svc in (a, b):
            svc.tick()
            for s in slots[id(svc)]:
                if s not in got[id(svc)]:
                    r = svc.poll(s)
                    if r is not None:
                        got[id(svc)][s] = r
        if all(len(got[k]) == 2 for k in got):
            break
    assert rt.graph_counts["captures"] == 0
    for svc, want in ((a, alone[0]), (b, alone[1])):
        for s, r in want.items():
            _same_bits(got[id(svc)][s], r)


def test_replayed_results_survive_the_next_admission(fake_graphs):
    """Polled tensors are not views of the static buffers."""
    svc = _graph_service()
    first = _drain(svc, [svc.try_submit(_plane(N, seed=0))])[0]
    kept = [x.clone() for x in (first.l, first.s, first.u, first.v)]
    svc.release(0)
    svc.try_submit(_plane(N, seed=1))
    svc.tick()
    for x, y in zip((first.l, first.s, first.u, first.v), kept):
        assert torch.equal(x, y)


def test_float16_plane_is_the_references():
    """A float16 tenant plane (the front door's other low-precision type):
    admitted on the fp32 path, answered as the reference's service answers
    the same float16 plane, and fingerprinted by its dtype (the same
    values in fp32 key another lam-cache entry)."""
    jcfg = JConfig.tuned(RANK)
    scfg = dict(slots=2, rounds_per_tick=8, max_rounds=200)
    ref = jsvc.RPCAService(M, N, jcfg, jsvc.RPCAServiceConfig(**scfg))
    port = _with_reference_factors(
        svc_mod.RPCAService(M, N, DCFConfig.tuned(RANK),
                            svc_mod.RPCAServiceConfig(**scfg), device=CPU),
        jcfg)
    plane = _plane(N, seed=6).astype(np.float16)
    got = _drain(port, [port.try_submit(torch.from_numpy(plane))])[0]
    want = _drain(ref, [ref.try_submit(jnp.asarray(plane))])[0]
    assert got.l.dtype == torch.float32
    _close(got, want)
    fp16 = svc_mod._fingerprint(torch.from_numpy(plane))
    assert fp16 == svc_mod._fingerprint(torch.from_numpy(plane.copy()))
    assert fp16 != svc_mod._fingerprint(
        torch.from_numpy(plane.astype(np.float32)))
