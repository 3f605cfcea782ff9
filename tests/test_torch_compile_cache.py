"""The port's shape-bucketed compile cache against the JAX reference's, on
the CPU (``repro_torch.core.compile_cache`` against
``repro.core.compile_cache``).

The bucket grid, the policy checks and their error text, the LRU
counters under the same sequences of solves, and the bypasses are held to
the reference's exactly.  Solves start from the same numpy inputs on both
sides.  Bars: IALM and APGM padded against unpadded within atol 5e-4
(tests/test_compile_cache.py:168-190, the reference's own tolerance, on
the port's solves and against the reference's unpadded ones); warm cf
through the port's cache within 1e-4 of max|L| of the reference's
``solve_cached`` output on the same inputs (fp32 arithmetic in another
order over 10 rounds; tests/test_torch_solve.py's tracking bar) and bit
for bit with the port's unpadded solve; cold cf's recovery within the
reference's bar (1.5x the uncached error + 1e-3).  On the card the cache
captures one round a bucket (tests/test_torch_gpu.py,
``chip_smoke.py``'s ``compile_cache`` phase).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rpca as jrpca
from repro.core import compile_cache as jcc
from repro.core import generate_problem as jgenerate
from repro.core.factorized import DCFConfig as JConfig
from repro.core.ialm import IALMConfig as JIALM
from repro_torch import rpca
from repro_torch.core import compile_cache as cc
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.core.ialm import IALMConfig

japgm = importlib.import_module("repro.core.apgm")
apgm_mod = importlib.import_module("repro_torch.core.apgm")

# Small buckets so tiny problems still pad (the reference tests' policy).
POLICY = cc.CompilePolicy(bucket_min=32)
JPOLICY = jcc.CompilePolicy(bucket_min=32)
CONVEX_ATOL = 5e-4
CF_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread beside JAX's (tests/test_torch_convex.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def caches(monkeypatch):
    """Fresh process-default caches on both sides."""
    port, ref = cc.CompileCache(), jcc.CompileCache()
    monkeypatch.setattr(cc, "_DEFAULT_CACHE", port)
    monkeypatch.setattr(jcc, "_DEFAULT_CACHE", ref)
    return port, ref


def _gen(m=48, n=40, rank=4, observed=0.8, seed=0):
    """The reference tests' problem as numpy arrays."""
    p = jgenerate(jax.random.PRNGKey(seed), m, n, rank, 0.1,
                  observed_frac=observed)
    return {k: np.asarray(getattr(p, k)) for k in ("m_obs", "mask", "l0")}


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Bucket geometry, policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("bucket_min,ratio", [(32, 2.0), (10, 1.5),
                                              (64, 2.0), (7, 1.3),
                                              (1, 3.7)])
def test_bucket_grid_is_the_references(bucket_min, ratio):
    """Every dimension up to 700 lands in the reference's bucket,
    non-integer ratios included (each step's ceil)."""
    p = cc.CompilePolicy(bucket_min=bucket_min, bucket_ratio=ratio)
    jp = jcc.CompilePolicy(bucket_min=bucket_min, bucket_ratio=ratio)
    for x in range(1, 701):
        assert cc.bucket_dim(x, p) == jcc.bucket_dim(x, jp)
    assert cc.bucket_shape(45, 37, p) == jcc.bucket_shape(45, 37, jp)


def test_bucket_geometry_and_non_integer_progress():
    """tests/test_compile_cache.py:47-62's values."""
    p = cc.CompilePolicy(bucket_min=32, bucket_ratio=2.0)
    assert [cc.bucket_dim(x, p) for x in (1, 32, 33, 64, 65)] == \
        [32, 32, 64, 64, 128]
    assert cc.bucket_shape(45, 37, p) == (64, 64)
    q = cc.CompilePolicy(bucket_min=10, bucket_ratio=1.5)
    assert cc.bucket_dim(11, q) == 15 and cc.bucket_dim(16, q) == 23
    with pytest.raises(ValueError) as got:
        cc.bucket_dim(0, p)
    with pytest.raises(ValueError) as want:
        jcc.bucket_dim(0, jcc.CompilePolicy(bucket_min=32))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(bucket_min=0), dict(bucket_ratio=1.0),
                                dict(bucket_ratio=0.5), dict(max_entries=0),
                                dict(max_bytes=0)])
def test_policy_validation_reads_as_the_reference(kw):
    with pytest.raises(ValueError) as got:
        cc.CompilePolicy(**kw)
    with pytest.raises(ValueError) as want:
        jcc.CompilePolicy(**kw)
    assert str(got.value) == str(want.value)


def test_policy_fields_and_defaults_are_the_references():
    assert [f.name for f in dataclasses.fields(cc.CompilePolicy)] == \
        [f.name for f in dataclasses.fields(jcc.CompilePolicy)]
    assert dataclasses.asdict(cc.AOT) == dataclasses.asdict(jcc.AOT)
    assert cc.CacheStats().as_dict() == jcc.CacheStats().as_dict()


@pytest.mark.parametrize("policy", [123, "bogus", 1.5])
def test_resolve_policy_is_the_references(policy):
    assert cc.resolve_policy(None) is None
    assert cc.resolve_policy("off") is None
    assert cc.resolve_policy("aot") is cc.AOT
    assert cc.resolve_policy(POLICY) is POLICY
    with pytest.raises(ValueError) as got:
        cc.resolve_policy(policy)
    with pytest.raises(ValueError) as want:
        jcc.resolve_policy(policy)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got:
        rpca.solve(torch.zeros(8, 8), method="ialm", compile_policy=policy,
                   device="cpu")
    with pytest.raises(ValueError) as want:
        jrpca.solve(jnp.zeros((8, 8)), method="ialm",
                    compile_policy=policy)
    assert str(got.value) == str(want.value)


def test_front_door_reexport():
    assert rpca.CompilePolicy is cc.CompilePolicy
    assert "CompilePolicy" in rpca.__all__ and "AOTHooks" in rpca.__all__
    assert [f.name for f in dataclasses.fields(rpca.AOTHooks)] == \
        [f.name for f in dataclasses.fields(jrpca.AOTHooks)]
    assert {n for n, e in rpca.SOLVERS.items() if e.aot is not None} == \
        {"cf", "ialm", "apgm"}
    assert [f.name for f in dataclasses.fields(rpca.RPCAResult)] == \
        [f.name for f in dataclasses.fields(jrpca.RPCAResult)]


# ---------------------------------------------------------------------------
# The LRU store: the reference's counters under the same sequences
# ---------------------------------------------------------------------------
def _both(port_cache, ref_cache, shapes, policy_kw, iters=2):
    """IALM solves of all-ones (m, m) matrices through both caches."""
    pol, jpol = cc.CompilePolicy(**policy_kw), jcc.CompilePolicy(**policy_kw)
    for m in shapes:
        rpca.solve(torch.ones(m, m), method="ialm",
                   cfg=IALMConfig(iters=iters), compile_policy=pol,
                   device="cpu")
        jrpca.solve(np.ones((m, m), np.float32), method="ialm",
                    cfg=JIALM(iters=iters), compile_policy=jpol)
    return port_cache.stats.as_dict(), ref_cache.stats.as_dict()


@pytest.mark.parametrize("shapes", [(16, 20, 40), (16, 20, 16, 40, 16),
                                    (16, 16, 16), (20, 40, 70, 16, 20)])
def test_entry_budget_and_lru_order_are_the_references(caches, shapes):
    port, ref = caches
    got, want = _both(port, ref, shapes, dict(bucket_min=16, max_entries=2))
    assert got == want
    assert len(port) == len(ref) <= 2


def test_lru_order_refreshes_on_hit(caches):
    """tests/test_compile_cache.py:249-261: a hit refreshes an entry, so
    the least recently used one is evicted."""
    port, _ = caches
    pol = cc.CompilePolicy(bucket_min=16, max_entries=2)
    kw = dict(method="ialm", cfg=IALMConfig(iters=2), compile_policy=pol,
              device="cpu")
    a, b = torch.ones(16, 16), torch.ones(20, 20)
    rpca.solve(a, **kw)
    rpca.solve(b, **kw)
    rpca.solve(a, **kw)  # refresh a
    rpca.solve(torch.ones(40, 40), **kw)  # evicts b, not a
    before = port.stats.compiles
    rpca.solve(a, **kw)
    assert port.stats.compiles == before


def test_byte_budget_keeps_the_newest_entry(caches):
    port, ref = caches
    got, want = _both(port, ref, (16, 20), dict(bucket_min=16, max_bytes=1))
    assert len(port) == 1 and port.stats.evictions >= 1
    assert got == want
    assert port.nbytes > 0


def test_clear_keeps_counting(caches):
    port, ref = caches
    _both(port, ref, (16, 16), dict(bucket_min=16))
    port.clear()
    ref.clear()
    assert len(port) == 0
    got, want = _both(port, ref, (16,), dict(bucket_min=16))
    assert got == want
    assert got["compiles"] == 2 and got["misses"] == 2 and got["hits"] == 1


def test_store_counts_as_the_reference_with_stand_in_programs():
    """CompileCache.get on stand-in builds: hits, misses, builds and
    evictions of the reference's store, the newest entry kept past the
    byte budget."""

    class Program:
        nbytes = 10

    port, ref = cc.CompileCache(), jcc.CompileCache()
    pol = cc.CompilePolicy(max_entries=3, max_bytes=25)
    jpol = jcc.CompilePolicy(max_entries=3, max_bytes=25)
    for key in ["a", "b", "a", "c", "d", "b", "a", "e", "e"]:
        got = port.get(key, Program, pol)
        ref.get(key, Program, jpol)
        assert isinstance(got, Program)
    assert port.stats.hits + port.stats.misses == 9
    assert port.stats.hits >= 1 and len(port) == 2 and port.nbytes == 20
    assert ref.stats.hits + ref.stats.misses == 9


# ---------------------------------------------------------------------------
# Bypasses and the caller's tensors
# ---------------------------------------------------------------------------
def test_bypasses_take_the_regular_path(caches):
    """Simulated clients, a batch and participation return no cache stats
    and build nothing, as in the reference; a mesh or a method without
    hooks is out of scope for ``solve_cached`` on both sides."""
    port, ref = caches
    p = _gen(32, 32)
    m = _t(p["m_obs"])
    res = rpca.solve(m, method="dcf", rank=4, num_clients=4,
                     compile_policy="aot", device="cpu")
    assert res.cache_stats is None
    res = rpca.solve(torch.stack([m, m]), method="ialm",
                     cfg=IALMConfig(iters=2), compile_policy="aot",
                     device="cpu")
    assert res.cache_stats is None
    res = rpca.solve(m, method="dcf", rank=4, participation=0.5,
                     num_clients=4, cfg=DCFConfig.tuned(4, outer_iters=3),
                     compile_policy="aot", device="cpu")
    assert res.cache_stats is None
    res = rpca.solve(m, method="ialm", cfg=IALMConfig(iters=2),
                     device="cpu")
    assert res.cache_stats is None
    assert len(port) == 0
    mesh = rpca.RPCASpec(m, mesh=object())
    jmesh = jrpca.RPCASpec(jnp.asarray(p["m_obs"]), mesh=object())
    for name in ("cf", "dcf", "ialm"):
        got = cc.solve_cached(rpca.get_solver(name), mesh, None, rt.FIXED,
                              POLICY, device=torch.device("cpu"))
        want = jcc.solve_cached(jrpca.get_solver(name), jmesh, None,
                                jrpca._rt().FIXED, JPOLICY)
        assert got is None and want is None
    assert len(port) == 0 and len(ref) == 0


@pytest.mark.parametrize("method", ["cf", "ialm"])
def test_caller_tensors_are_left_untouched(caches, method):
    """The admission pads into fresh planes: after two cached solves the
    caller's data, mask and warm factors hold their bits (the counterpart
    of the reference's donation test, tests/test_compile_cache.py:385)."""
    p = _gen(40, 36)
    m, w = _t(p["m_obs"]), _t(p["mask"])
    if method == "cf":
        cfg = DCFConfig.tuned(4, outer_iters=3)
        g = torch.Generator().manual_seed(0)
        warm = (torch.randn(40, 4, generator=g), torch.randn(36, 4,
                                                              generator=g))
    else:
        cfg, warm = IALMConfig(iters=3), (m.clone(), torch.zeros(40, 36))
    keep = [x.clone() for x in (m, w, *warm)]
    for _ in range(2):
        rpca.solve(m, method=method, cfg=cfg, mask=w, warm=warm,
                   compile_policy=POLICY, device="cpu")
    for a, b in zip((m, w, *warm), keep):
        assert torch.equal(a, b)


def test_results_survive_the_next_admission(caches):
    """A result is the caller's: the next admission into the same entry
    rewrites the static buffers, not the tensors handed out."""
    p = _gen(48, 40)
    cfg = DCFConfig.tuned(4, outer_iters=4)
    kw = dict(method="cf", cfg=cfg, compile_policy=POLICY, device="cpu")
    first = rpca.solve(_t(p["m_obs"]), mask=_t(p["mask"]), **kw)
    keep = [x.clone() for x in (first.l, first.s, first.u, first.v,
                                first.stats.objective)]
    rpca.solve(_t(p["m_obs"])[:40, :33] * 2.0, mask=_t(p["mask"])[:40, :33],
               **kw)
    for a, b in zip((first.l, first.s, first.u, first.v,
                     first.stats.objective), keep):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Padding is semantics-free
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
@pytest.mark.parametrize("method", ["ialm", "apgm"])
def test_padded_convex_matches_unpadded(caches, method, masked):
    """IALM and APGM through the cache against the unpadded solve, the
    port's and the reference's, within the reference's atol 5e-4; the
    unmasked spec rides the all-ones plane."""
    p = _gen(40, 36, observed=0.8 if masked else 1.0)
    cfg = {"ialm": IALMConfig(iters=30), "apgm": apgm_mod.APGMConfig(
        iters=30)}[method]
    jcfg = {"ialm": JIALM(iters=30), "apgm": japgm.APGMConfig(iters=30)}[
        method]
    w = _t(p["mask"]) if masked else None
    plain = rpca.solve(_t(p["m_obs"]), method=method, cfg=cfg, mask=w,
                       device="cpu")
    got = rpca.solve(_t(p["m_obs"]), method=method, cfg=cfg, mask=w,
                     compile_policy=POLICY, device="cpu")
    want = jrpca.solve(jnp.asarray(p["m_obs"]), method=method, cfg=jcfg,
                       mask=None if w is None else jnp.asarray(p["mask"]))
    assert got.cache_stats is not None and got.cache_stats.compiles == 1
    assert got.l.shape == (40, 36) and got.u is None
    for x, y in ((got.l, plain.l), (got.s, plain.s),
                 (got.l, _t(want.l)), (got.s, _t(want.s))):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0,
                                   atol=CONVEX_ATOL)


def test_warm_cf_through_the_cache_is_the_references(caches):
    """Warm-started cf (deterministic) through the port's cache against the
    reference's ``solve_cached`` on the same inputs, and bit for bit with
    the port's unpadded solve."""
    p = _gen(48, 40)
    rng = np.random.default_rng(3)
    warm = (rng.standard_normal((48, 4)).astype(np.float32) * 0.5,
            rng.standard_normal((40, 4)).astype(np.float32) * 0.5)
    cfg = DCFConfig.tuned(4, outer_iters=10)
    got = rpca.solve(_t(p["m_obs"]), method="cf", cfg=cfg,
                     mask=_t(p["mask"]), warm=tuple(map(_t, warm)),
                     compile_policy=POLICY, device="cpu")
    plain = rpca.solve(_t(p["m_obs"]), method="cf", cfg=cfg,
                       mask=_t(p["mask"]), warm=tuple(map(_t, warm)),
                       device="cpu")
    want = jrpca.solve(jnp.asarray(p["m_obs"]), method="cf",
                       cfg=JConfig.tuned(4, outer_iters=10),
                       mask=jnp.asarray(p["mask"]),
                       warm=tuple(map(jnp.asarray, warm)),
                       compile_policy=JPOLICY)
    assert want.cache_stats is not None and got.cache_stats is not None
    for name in ("l", "s", "u", "v"):
        a, b = getattr(got, name), _t(getattr(want, name))
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= CF_TOL * b.abs().max().item()
        assert torch.equal(a, getattr(plain, name))
    np.testing.assert_allclose(got.stats.objective.numpy(),
                               np.asarray(want.stats.objective), rtol=1e-4)


def test_cold_cf_recovery_through_the_cache(caches):
    """Cold cf draws its factors at the bucket shape (another draw than
    unpadded), so it is held to the ground truth: within the reference's
    bar of the uncached recovery (tests/test_compile_cache.py:193-208)."""
    p = _gen(48, 40)
    cfg = DCFConfig.tuned(4)
    l0 = _t(p["l0"])

    def recovery(**kw):
        r = rpca.solve(_t(p["m_obs"]), method="cf", cfg=cfg,
                       mask=_t(p["mask"]), device="cpu", **kw)
        return float(torch.linalg.norm(r.l - l0) / torch.linalg.norm(l0))

    assert recovery(compile_policy=POLICY) <= 1.5 * recovery() + 1e-3


def test_same_bucket_builds_one_entry(caches):
    """Two fresh true shapes in one (64, 64) bucket after the first solve:
    hits, one build, every result the shape of its spec
    (tests/test_compile_cache.py:99-128)."""
    port, _ = caches
    p = _gen(48, 40)
    cfg = DCFConfig.tuned(4, outer_iters=10)
    kw = dict(method="cf", cfg=cfg, rank=4, compile_policy=POLICY,
              device="cpu")
    res = rpca.solve(_t(p["m_obs"]), mask=_t(p["mask"]), **kw)
    assert (res.cache_stats.misses, res.cache_stats.compiles) == (1, 1)
    for i, (mt, nt) in enumerate([(45, 37), (40, 33)]):
        res = rpca.solve(_t(p["m_obs"][:mt, :nt]), mask=_t(p["mask"][:mt,
                                                                    :nt]),
                         **kw)
        assert res.cache_stats.hits == i + 1
        assert res.cache_stats.compiles == 1
        assert res.l.shape == (mt, nt) and res.s.shape == (mt, nt)
        assert res.u.shape == (mt, 4) and res.v.shape == (nt, 4)
    assert len(port) == 1
