"""The port's kernel functions against the JAX reference.

On the CPU every wrapper of ``repro_torch.kernels`` returns its plain
version; these tests hold that against the reference's Pallas kernels (run
in interpret mode, as tests/test_kernels.py runs them) and its jnp oracles,
client by client, on small ragged shapes.  The CUDA kernels themselves are
held against their plain versions on the card in tests/test_torch_gpu.py.

Tolerances: contractions and S use rtol = atol = 2e-5 (as
tests/test_kernels.py: fp32 sums in another order); the scalar diagnostics
use rtol 1e-5 (a sum over every entry, taken in another order by each
framework).  A bf16 M is cast on each side from the same fp32 numpy array
(both round to nearest even) and upcast exactly, so it keeps the same
tolerances.  ``*_packed`` families take the bit-packed mask on both sides;
their jnp oracle takes the dense plane it packs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitmask as jbitmask
from repro.kernels import huber_contract as jhc
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import shrinkage as jsh
from repro_torch.kernels import bitmask, ops
from repro_torch.kernels import huber_contract as hc
from repro_torch.kernels import shrinkage as sh

E, M, NI = 3, 40, 24
LAMS = np.array([0.5, 0.9, 1.3], np.float32)
SCALAR_RTOL = 1e-5
PLANE_TOL = 2e-5


def _inputs(r, seed=0, frac=0.7):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((E, M, r)).astype(np.float32)
    v = rng.standard_normal((E, NI, r)).astype(np.float32)
    m = (rng.standard_normal((E, M, NI)) * 4.0).astype(np.float32)
    w = (rng.random((E, M, NI)) < frac).astype(np.float32)
    return u, v, m, w


# name -> (port wrapper, reference Pallas kernel, reference oracle); the
# reference takes one client's 2-D operands (and w before lam when masked).
FAMILIES = {
    "huber_contract_v": (
        lambda u, v, m, lam, w: hc.huber_contract_v(u, v, m, lam),
        lambda u, v, m, lam, w: jhc.huber_contract_v(u, v, m, lam,
                                                     interpret=True),
        lambda u, v, m, lam, w: jref.huber_contract_v(u, v, m, lam)),
    "huber_contract_v_masked": (
        lambda u, v, m, lam, w: hc.huber_contract_v(u, v, m, lam, w),
        lambda u, v, m, lam, w: jhc.huber_contract_v_masked(
            u, v, m, w, lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_contract_v_masked(u, v, m, w, lam)),
    "huber_contract_u_diag": (
        lambda u, v, m, lam, w: hc.huber_contract_u_diag(u, v, m, lam),
        lambda u, v, m, lam, w: jhc.huber_contract_u_diag(
            u, v, m, lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_dual_contract(u, v, m, lam)[1:]),
    "huber_contract_u_diag_masked": (
        lambda u, v, m, lam, w: hc.huber_contract_u_diag(u, v, m, lam, w),
        lambda u, v, m, lam, w: jhc.huber_contract_u_diag_masked(
            u, v, m, w, lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_dual_contract_masked(
            u, v, m, w, lam)[1:]),
    "huber_contract_v_packed": (
        lambda u, v, m, lam, w: hc.huber_contract_v(u, v, m, lam,
                                                    bitmask.pack_mask(w)),
        lambda u, v, m, lam, w: jhc.huber_contract_v_packed(
            u, v, m, jbitmask.pack_mask(w), lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_contract_v_masked(u, v, m, w, lam)),
    "huber_contract_u": (
        lambda u, v, m, lam, w: hc.huber_contract_u(u, v, m, lam),
        lambda u, v, m, lam, w: jhc.huber_contract_u(u, v, m, lam,
                                                     interpret=True),
        lambda u, v, m, lam, w: jref.huber_contract_u(u, v, m, lam)),
    "huber_contract_u_masked": (
        lambda u, v, m, lam, w: hc.huber_contract_u(u, v, m, lam, w),
        lambda u, v, m, lam, w: jhc.huber_contract_u_masked(
            u, v, m, w, lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_contract_u_masked(u, v, m, w, lam)),
    "huber_contract_u_packed": (
        lambda u, v, m, lam, w: hc.huber_contract_u(u, v, m, lam,
                                                    bitmask.pack_mask(w)),
        lambda u, v, m, lam, w: jhc.huber_contract_u_packed(
            u, v, m, jbitmask.pack_mask(w), lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_contract_u_masked(u, v, m, w, lam)),
    "huber_contract_u_diag_packed": (
        lambda u, v, m, lam, w: hc.huber_contract_u_diag(
            u, v, m, lam, bitmask.pack_mask(w)),
        lambda u, v, m, lam, w: jhc.huber_contract_u_diag_masked(
            u, v, m, jbitmask.pack_mask(w), lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_dual_contract_masked(
            u, v, m, w, lam)[1:]),
    "huber_dual_contract": (
        lambda u, v, m, lam, w: hc.huber_dual_contract(u, v, m, lam),
        lambda u, v, m, lam, w: jhc.huber_dual_contract(u, v, m, lam,
                                                        interpret=True),
        lambda u, v, m, lam, w: jref.huber_dual_contract(u, v, m, lam)),
    "huber_dual_contract_masked": (
        lambda u, v, m, lam, w: hc.huber_dual_contract(u, v, m, lam, w),
        lambda u, v, m, lam, w: jhc.huber_dual_contract_masked(
            u, v, m, w, lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_dual_contract_masked(
            u, v, m, w, lam)),
    "huber_dual_contract_packed": (
        lambda u, v, m, lam, w: hc.huber_dual_contract(
            u, v, m, lam, bitmask.pack_mask(w)),
        lambda u, v, m, lam, w: jhc.huber_dual_contract_masked(
            u, v, m, jbitmask.pack_mask(w), lam, interpret=True),
        lambda u, v, m, lam, w: jref.huber_dual_contract_masked(
            u, v, m, w, lam)),
    "residual_shrink": (
        lambda u, v, m, lam, w: sh.residual_shrink(u, v, m, lam),
        lambda u, v, m, lam, w: jsh.residual_shrink(u, v, m, lam,
                                                    interpret=True),
        lambda u, v, m, lam, w: jref.residual_shrink(u, v, m, lam)),
    "residual_shrink_masked": (
        lambda u, v, m, lam, w: sh.residual_shrink(u, v, m, lam, w),
        lambda u, v, m, lam, w: jsh.residual_shrink_masked(
            u, v, m, w, lam, interpret=True),
        lambda u, v, m, lam, w: jref.residual_shrink_masked(u, v, m, w, lam)),
}


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _check_against_reference(name, r, against, bf16):
    port_fn, pallas_fn, ref_fn = FAMILIES[name]
    jax_fn = pallas_fn if against == "pallas" else ref_fn
    u, v, m, w = _inputs(r)
    m_port = torch.from_numpy(m)
    m_ref = jnp.asarray(m)
    if bf16:
        m_port, m_ref = m_port.to(torch.bfloat16), m_ref.astype(jnp.bfloat16)
    got = _as_tuple(port_fn(torch.from_numpy(u), torch.from_numpy(v), m_port,
                            torch.from_numpy(LAMS), torch.from_numpy(w)))
    for e in range(E):
        want = _as_tuple(jax_fn(jnp.asarray(u[e]), jnp.asarray(v[e]),
                                m_ref[e], float(LAMS[e]),
                                jnp.asarray(w[e])))
        assert len(got) == len(want)
        for g, ww in zip(got, want):
            g, ww = g[e].numpy(), np.asarray(ww)
            if ww.ndim == 0:
                np.testing.assert_allclose(g, ww, rtol=SCALAR_RTOL)
            else:
                np.testing.assert_allclose(g, ww, rtol=PLANE_TOL,
                                           atol=PLANE_TOL)


@pytest.mark.parametrize("against", ["pallas", "ref"])
@pytest.mark.parametrize("r", [5, 7])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_plain_matches_reference(name, r, against):
    _check_against_reference(name, r, against, bf16=False)


@pytest.mark.parametrize("name", ["huber_contract_v", "huber_contract_u_diag",
                                  "huber_dual_contract", "residual_shrink"])
def test_plain_matches_reference_at_a_wide_rank(name):
    """At r = 300 (two rank halves or slices on the card) the plain
    versions against the reference's Pallas kernels in interpret mode (r
    padded to 384 lanes there)."""
    _check_against_reference(name, 300, "pallas", bf16=False)


@pytest.mark.parametrize("against", ["pallas", "ref"])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_plain_matches_reference_bf16_data(name, against):
    """Every family with M stored in bf16 (the compact data plane)."""
    _check_against_reference(name, 7, against, bf16=True)


@pytest.mark.parametrize("name", ["huber_contract_v", "huber_contract_u_diag",
                                  "residual_shrink", "huber_contract_u",
                                  "huber_dual_contract"])
def test_all_ones_mask_is_bit_exact(name):
    """Within the port, an all-ones mask gives the bits of no mask."""
    u, v, m, _ = (torch.from_numpy(x) for x in _inputs(7, seed=3))
    fn = getattr(ops, name)
    lam = torch.from_numpy(LAMS)
    plain = _as_tuple(fn(u, v, m, lam))
    masked = _as_tuple(fn(u, v, m, lam, w=torch.ones_like(m)))
    for a, b in zip(plain, masked):
        assert torch.equal(a, b)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["huber_contract_v", "huber_contract_u",
                                  "huber_contract_u_diag",
                                  "huber_dual_contract", "residual_shrink"])
def test_packed_mask_is_bit_exact(name, bf16):
    """Within the port, a packed mask gives the bits of the dense one."""
    u, v, m, w = (torch.from_numpy(x) for x in _inputs(7, seed=4))
    if bf16:
        m = m.to(torch.bfloat16)
    fn = getattr(ops, name)
    lam = torch.from_numpy(LAMS)
    dense = _as_tuple(fn(u, v, m, lam, w=w))
    packed = _as_tuple(fn(u, v, m, lam, w=bitmask.pack_mask(w)))
    for a, b in zip(dense, packed):
        assert a.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.parametrize("n", [8, 13, 24])
def test_pack_mask_byte_identical(n):
    rng = np.random.default_rng(n)
    w = (rng.random((2, 5, n)) < 0.6).astype(np.float32)
    mine = bitmask.pack_mask(torch.from_numpy(w)).numpy()
    theirs = np.asarray(jbitmask.pack_mask(jnp.asarray(w)))
    assert mine.dtype == theirs.dtype == np.uint8
    assert mine.tobytes() == theirs.tobytes()
    back = bitmask.unpack_mask(torch.from_numpy(mine), n).numpy()
    assert np.array_equal(back, w)
    ones = bitmask.packed_ones((2, 5, n), device="cpu").numpy()
    assert ones.tobytes() == np.asarray(
        jbitmask.packed_ones((2, 5, n))).tobytes()


def test_ops_dispatch_single_problem_and_impls():
    """2-D operands run as one client; impl='ref' and 'auto' agree on the
    CPU; 'cuda' refuses CPU tensors; S + Psi is the residual."""
    u, v, m, w = (torch.from_numpy(x[0]) for x in _inputs(5))
    a = ops.huber_contract_v(u, v, m, 0.9, w=w)
    b = ops.huber_contract_v(u, v, m, 0.9, w=w, impl="ref")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=PLANE_TOL,
                               atol=PLANE_TOL)
    assert a.shape == (NI, 5)
    with pytest.raises(ValueError, match="impl='cuda'"):
        ops.residual_shrink(u, v, m, 0.9, impl="cuda")
    with pytest.raises(ValueError):
        ops.residual_shrink(u, v, m, 0.9, impl="pallas")
    packed = bitmask.pack_mask(w)
    np.testing.assert_allclose(
        ops.residual_shrink(u, v, m, 0.9, w=packed).numpy(),
        ops.residual_shrink(u, v, m, 0.9, w=w).numpy())
    s, psi = ops.residual_shrink_psi(u, v, m, 0.9)
    np.testing.assert_allclose((s + psi).numpy(), (m - u @ v.T).numpy(),
                               rtol=PLANE_TOL, atol=PLANE_TOL)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
@pytest.mark.parametrize("mask", ["none", "dense", "packed"])
def test_residual_shrink_psi_matches_reference(mask, stacked, bf16):
    """``ops.residual_shrink_psi`` (S, R - S; masked W S, W R - W S) against
    the reference's Pallas kernels through its own entry point, one problem
    (2-D operands, a float threshold) or E stacked clients."""
    u, v, m, w = _inputs(7, seed=6)
    m_port, m_ref = torch.from_numpy(m), jnp.asarray(m)
    if bf16:
        m_port, m_ref = m_port.to(torch.bfloat16), m_ref.astype(jnp.bfloat16)
    w_port = {"none": None, "dense": torch.from_numpy(w),
              "packed": bitmask.pack_mask(torch.from_numpy(w))}[mask]
    w_ref = {"none": None, "dense": jnp.asarray(w),
             "packed": jbitmask.pack_mask(jnp.asarray(w))}[mask]
    if stacked:
        got = ops.residual_shrink_psi(torch.from_numpy(u), torch.from_numpy(v),
                                      m_port, torch.from_numpy(LAMS),
                                      w=w_port)
    else:
        got = ops.residual_shrink_psi(
            torch.from_numpy(u[0]), torch.from_numpy(v[0]), m_port[0],
            float(LAMS[0]), w=None if w_port is None else w_port[0])
        got = tuple(x[None] for x in got)
    for e in range(E if stacked else 1):
        want = jops.residual_shrink_psi(
            jnp.asarray(u[e]), jnp.asarray(v[e]), m_ref[e], float(LAMS[e]),
            w=None if w_ref is None else w_ref[e], impl="pallas")
        for g, ww in zip(got, want):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(g[e].numpy(), np.asarray(ww),
                                       rtol=PLANE_TOL, atol=PLANE_TOL)


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("e,m,n", [(1, 1, 1), (10, 3000, 300), (1, 3000, 3000),
                                   (4, 2048, 512), (3, 40, 24), (2, 64, 65),
                                   (1, 129, 7), (7, 4097, 1000),
                                   (1, 100000, 64)])
def test_v_splits_cover_m_in_whole_tiles(e, m, n, sms):
    """``huber_contract_v``'s row ranges: each a whole number of the
    kernel's 64-row tiles, none empty, together exactly the m rows; a pure
    function of (E, m, n, SM count)."""
    splits, rows = hc.v_splits(e, m, n, sms)
    assert splits >= 1 and rows >= hc.V_TILE_ROWS
    assert rows % hc.V_TILE_ROWS == 0
    starts = [s * rows for s in range(splits)]
    assert all(start < m for start in starts)  # no empty range
    assert splits * rows >= m  # the ranges reach the last row
    covered = sum(min(m, start + rows) - start for start in starts)
    assert covered == m
    assert hc.v_splits(e, m, n, sms) == (splits, rows)


def test_library_declares_every_entry_it_is_asked_for(monkeypatch):
    """An entry's ctypes signature is declared at its first call even when
    another entry loaded the library (an undeclared entry would pass each
    device pointer as a C int)."""
    import ctypes

    from repro_torch.kernels import _build

    class Entry:
        argtypes, restype = None, None

    class Lib:
        first, second = Entry(), Entry()

    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_declared", set())
    monkeypatch.setattr(_build, "build_all", lambda: 0.0)
    monkeypatch.setattr(_build, "library_path", lambda source: source)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    lib = _build.library("stub", {"first": (ctypes.c_int,)})
    assert lib.first.argtypes == [ctypes.c_int]
    assert _build.library("stub", {"second": (ctypes.c_void_p,)}) is lib
    assert lib.second.argtypes == [ctypes.c_void_p]
    assert lib.second.restype is ctypes.c_int


# Ranks of huber_contract_v's cluster kernel (257 .. 2048): both ends, the
# two-slice ranks of Table 1 (500) and the wide phase (600), exact slices
# of 256 (512, 768, 1024), and one rank past a slice count (513, 1025).
CLUSTER_RANKS = [257, 300, 448, 500, 512, 513, 600, 768, 1024, 1025, 1792,
                 2047, 2048]


@pytest.mark.parametrize("r", CLUSTER_RANKS)
def test_v_cluster_slices_fit_a_block(r):
    """The cluster kernel's rank slices: together exactly r, each a
    multiple of 4 but the last, none wider than SLICE_MAX, none empty,
    at most 8 blocks a cluster, the fewest that cover r, and a block's
    shared memory within the 227 KB an H100 block may take."""
    from repro_torch.kernels import _launch

    cluster, slice_ = hc.v_slices(r)
    widths = [min(slice_, r - c * slice_) for c in range(cluster)]
    assert sum(widths) == r and min(widths) >= 1
    assert all(wd % 4 == 0 for wd in widths[:-1])
    assert max(widths) == slice_ <= _launch.SLICE_MAX
    assert 2 <= cluster <= _launch.CLUSTER_MAX == 8
    assert cluster == -(-r // _launch.SLICE_MAX)
    assert max(widths) - min(widths) < 4 * cluster  # as even as groups allow
    assert hc.cluster_smem_bytes(slice_) <= 227 * 1024
    assert not _launch.v_chunked(r)
    if r in (500, 600):
        assert widths == {500: [252, 248], 600: [200, 200, 200]}[r]


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
def test_v_cluster_slots_bound_the_card(sms):
    """The resident clusters the cluster grids' row and column splits are
    costed with: at least one, at most one a cluster's SMs, and the H100's
    measured counts at 132 SMs (66 clusters of 2: every SM busy; clusters
    stay inside one GPC: 39 of 3, not 44)."""
    for cluster in range(2, 9):
        slots = hc.cluster_slots(cluster, sms)
        assert 1 <= slots <= max(1, sms // cluster)
    if sms == 132:
        assert hc.cluster_slots(2, sms) == 66
        assert hc.cluster_slots(3, sms) == 39


@pytest.mark.parametrize("sms", [1, 78, 132])
@pytest.mark.parametrize("r", [8, 256, 257, 500, 600, 2048, 2049, 4000])
@pytest.mark.parametrize("e,m,n", [(10, 5000, 500), (10, 4000, 400),
                                   (1, 129, 7), (3, 40, 65)])
def test_v_plan_grid_and_splits(e, m, n, r, sms):
    """``huber_contract_v``'s launch plan: the cluster kernel from 257 to
    V_CLUSTER_MAX_RANK (its grid's x a multiple of the cluster, one
    cluster a column tile), the chunk kernel above and one block a tile
    at r <= 256; y (the row splits) and z (E) within GRID_YZ; the splits
    cover m in whole 64-row tiles, none empty; a pure function."""
    from repro_torch.kernels import _launch

    plan = hc.v_plan(e, m, n, r, sms)
    x, y, z = plan.grid
    col_tiles = -(-n // hc.V_TILE_COLS)
    if 256 < r <= _launch.V_CLUSTER_MAX_RANK:
        assert (plan.cluster, plan.slice) == hc.v_slices(r)
        assert x == col_tiles * plan.cluster and x % plan.cluster == 0
    else:
        assert plan.cluster == plan.slice == 0
        assert _launch.v_chunked(r) == (r > 256)
        assert x == col_tiles * _launch.rank_chunks(r)
    assert (y, z) == (plan.splits, e) and max(y, z) <= _launch.GRID_YZ
    rows = plan.rows
    assert rows % hc.V_TILE_ROWS == 0
    assert all(s * rows < m for s in range(plan.splits))
    assert plan.splits * rows >= m > (plan.splits - 1) * rows
    assert hc.v_plan(e, m, n, r, sms) == plan


# The shrink's launch plan at paper Table 1's n = 5000 blocks (T5), the
# wide phase's (T6), the batch phase's 128 clients (Bn) and Fig. 1's (F),
# at their own ranks and at each side of every rank route.
SHRINK_PLAN_SHAPES = {"T5": (10, 5000, 500), "T6": (10, 4000, 400),
                      "Bn": (128, 500, 63), "F": (10, 3000, 300)}


@pytest.mark.parametrize("sms", [78, 132])
@pytest.mark.parametrize("r", [8, 150, 256, 257, 500, 512, 513, 600, 2048,
                               4096])
@pytest.mark.parametrize("shape", list(SHRINK_PLAN_SHAPES.values()),
                         ids=list(SHRINK_PLAN_SHAPES))
def test_shrink_plan(shape, r, sms):
    """The shrink's launch plan: ``shrink_kernel`` (64 x 64 tiles, the whole
    rank staged at once, two blocks an SM up to r = 192) up to r = 256 and
    ``shrink_stream_kernel`` (128 x 64 tiles, a ring of two 32-rank
    slabs) above; its grid covers the plane in whole tiles with E on z,
    within the CUDA grid's limits; a block's shared memory fits the
    232,448 bytes an H100 block may take, and the resident blocks the SM's
    228 KB; the slabs cover r; a pure function."""
    from repro_torch.kernels import _launch

    e, m, n = shape
    plan = sh.shrink_plan(e, m, n, r, sms)
    assert plan.route == ("base" if r <= 256 else "stream")
    if plan.route == "stream":
        assert (plan.rows, plan.cols) == (_launch.STREAM_ROWS,
                                         _launch.STREAM_COLS) == (128, 64)
        assert (plan.slab, plan.stages, plan.threads) == (32, 2, 128)
        assert plan.stages * plan.slab < r  # the ring streams the rank
        assert plan.resident == 2
    else:
        assert (plan.rows, plan.cols, plan.threads) == (64, 64, 256)
        assert plan.stages == 1 and plan.slab == 32 * -(-r // 32)
        assert plan.resident == (2 if r <= 192 else 1)
    slabs = -(-r // plan.slab)  # the last one zero-padded
    assert slabs * plan.slab >= r > (slabs - 1) * plan.slab
    x, y, z = plan.grid
    assert x * plan.cols >= n > (x - 1) * plan.cols
    assert y * plan.rows >= m > (y - 1) * plan.rows
    assert z == e and max(y, z) <= _launch.GRID_YZ
    if plan.route == "stream":  # 128-byte rows, swizzled; an mbarrier a stage
        assert plan.slab * 4 == 128
        assert plan.smem == (1024 + 4 * plan.stages * (plan.rows + plan.cols)
                             * plan.slab + 8 * plan.stages)
    else:  # both factors' rows, padded to an odd number of float4
        assert plan.smem == 4 * 2 * 64 * (plan.slab + 4)
    assert plan.smem <= 232448
    assert plan.resident * (plan.smem + 1024) <= 233472
    assert plan.waves == x * y * z / (plan.resident * sms)
    assert sh.shrink_plan(e, m, n, r, sms) == plan
    if (shape, r) == ((10, 5000, 500), 500):
        assert plan.grid == (8, 40, 10)  # 3200 blocks
    if (shape, r) == ((10, 4000, 400), 600):
        assert plan.grid == (7, 32, 10)  # 2240 blocks


@pytest.mark.parametrize("r", [150, 256, 257, 600, 2049])
@pytest.mark.parametrize("fn", ["residual_shrink", "residual_shrink_psi"])
def test_shrink_launch_follows_shrink_plan(monkeypatch, fn, r):
    """What a shrink wrapper hands its C entry on the card, with the entry
    replaced: the route code of ``shrink_plan`` (0 base, 1 stream) after
    the operand sizes and codes, and S (and Psi) as outputs."""
    from repro_torch.kernels import _build, _launch

    e, m, n = 2, 130, 200
    calls = []

    def fake_launch(lib, entry, name, counts, op, u, v, mat, w, lam,
                    *outputs, ints=()):
        calls.append((entry, name, outputs, ints))

    monkeypatch.setattr(sh, "on_cpu", lambda u: False)
    monkeypatch.setattr(sh, "check_operands",
                        lambda u, v, mat, lam, w=None: _launch.Operands(
                            *u.shape[:2], v.shape[1], u.shape[2], 0, 0))
    monkeypatch.setattr(sh, "sm_count", lambda device: 132)
    monkeypatch.setattr(sh, "launch", fake_launch)
    monkeypatch.setattr(_build, "library", lambda stem, sigs: None)
    getattr(sh, fn)(torch.zeros(e, m, r), torch.zeros(e, n, r),
                    torch.zeros(e, m, n), torch.ones(e))
    (entry, name, outputs, ints), = calls
    assert (entry, name) == ("repro_" + fn, fn)
    assert ints == (sh.ROUTES[sh.shrink_plan(e, m, n, r, 132).route],)
    assert ints == ((0,) if r <= 256 else (1,))
    assert len(outputs) == (2 if fn.endswith("psi") else 1)
    assert all(o.shape == (e, m, n) for o in outputs)


@pytest.mark.parametrize("r", CLUSTER_RANKS)
def test_u_cluster_slices_fit_a_block(r):
    """The row-stripe cluster kernel's rank slices: together exactly r,
    each a multiple of 4 but the last, none wider than SLICE_MAX, none
    empty, at most 8 blocks a cluster, the fewest that cover r, and a
    block's shared memory (its U slice, two V stages, the partial and an
    unpadded Psi^T) within the 232,448 bytes an H100 block may take."""
    from repro_torch.kernels import _launch

    cluster, slice_ = hc.u_slices(r)
    widths = [min(slice_, r - c * slice_) for c in range(cluster)]
    assert sum(widths) == r and min(widths) >= 1
    assert all(wd % 4 == 0 for wd in widths[:-1])
    assert max(widths) == slice_ <= _launch.SLICE_MAX
    assert 2 <= cluster <= _launch.CLUSTER_MAX == 8
    assert cluster == -(-r // _launch.SLICE_MAX)
    assert max(widths) - min(widths) < 4 * cluster  # as even as groups allow
    assert hc.cluster_smem_bytes(slice_) <= 232448
    assert hc.cluster_smem_bytes(256) == 232448  # exactly, at a full slice
    assert not _launch.u_chunked(r)
    if r in (500, 600):
        assert widths == {500: [252, 248], 600: [200, 200, 200]}[r]


@pytest.mark.parametrize("sms", [1, 78, 132])
@pytest.mark.parametrize("r", [8, 256, 257, 500, 600, 2048, 2049, 4000])
@pytest.mark.parametrize("e,m,n", [(10, 5000, 500), (10, 4000, 400),
                                   (1, 129, 7), (3, 40, 65)])
def test_u_plan_grid_and_splits(e, m, n, r, sms):
    """The row-stripe kernels' launch plan: the cluster kernel from 257 to
    U_CLUSTER_MAX_RANK (its grid's x a multiple of the cluster, one
    cluster a stripe), the chunk kernel above and one block a stripe at r
    <= 256; y (the column splits) and z (E) within GRID_YZ; the splits
    cover n in whole 64-column tiles, none empty; a pure function."""
    from repro_torch.kernels import _launch

    plan = hc.u_plan(e, m, n, r, sms)
    x, y, z = plan.grid
    stripes = -(-m // hc.U_TILE_ROWS)
    if 256 < r <= _launch.U_CLUSTER_MAX_RANK:
        assert (plan.cluster, plan.slice) == hc.u_slices(r)
        assert x == stripes * plan.cluster and x % plan.cluster == 0
        assert (plan.splits, plan.cols) == hc.u_splits(
            e, m, n, sms, cluster=plan.cluster)
    else:
        assert plan.cluster == plan.slice == 0
        assert _launch.u_chunked(r) == (r > 256)
        assert x == stripes * _launch.rank_chunks(r)
    assert (y, z) == (plan.splits, e) and max(y, z) <= _launch.GRID_YZ
    cols = plan.cols
    assert cols % hc.U_TILE_COLS == 0
    assert all(s * cols < n for s in range(plan.splits))
    assert plan.splits * cols >= n > (plan.splits - 1) * cols
    assert hc.u_plan(e, m, n, r, sms) == plan


@pytest.mark.parametrize("r", [8, 256, 257, 300, 512, 513, 2048, 4000])
def test_grid_limit_counts_one_block_a_client(r):
    """Every kernel grid's z axis holds one block a client at every rank
    (the rank slices, halves and chunks ride x or a block's own loop), so
    E = 65535 fits and one more does not."""
    from repro_torch.kernels import _launch

    assert _launch.grid_limit_error(_launch.GRID_YZ, 64, r) is None
    assert "z axis" in _launch.grid_limit_error(_launch.GRID_YZ + 1, 64, r)


@pytest.mark.parametrize("r", [150, 300, 600, 2049])
@pytest.mark.parametrize("fn", ["huber_contract_u", "huber_contract_u_diag",
                                "huber_dual_contract"])
def test_stripe_launch_follows_u_plan(monkeypatch, fn, r):
    """What a row-stripe wrapper hands its C entry on the card, with the
    entry replaced: the column splits and the rank slices of ``u_plan``
    (the dual also its row groups), out_u's partial planes with several
    splits, and per-block diagnostics partials for every block of the grid
    (stripes x splits x the cluster's blocks)."""
    from repro_torch.kernels import _build, _launch

    e, m, n = 2, 130, 200
    sms = 5
    calls = []

    def fake_launch(lib, entry, name, counts, op, u, v, mat, w, lam,
                    *outputs, ints=()):
        calls.append((entry, name, outputs, ints))

    monkeypatch.setattr(hc, "on_cpu", lambda u: False)
    monkeypatch.setattr(hc, "check_operands",
                        lambda u, v, mat, lam, w=None: _launch.Operands(
                            *u.shape[:2], v.shape[1], u.shape[2], 0, 0))
    monkeypatch.setattr(hc, "sm_count", lambda device: sms)
    monkeypatch.setattr(hc, "launch", fake_launch)
    monkeypatch.setattr(_build, "library", lambda stem, sigs: None)
    u, v = torch.zeros(e, m, r), torch.zeros(e, n, r)
    getattr(hc, fn)(u, v, torch.zeros(e, m, n), torch.ones(e))
    plan = hc.u_plan(e, m, n, r, sms)
    if fn == "huber_dual_contract" and hc.dual_plan(e, m, n, r) is None:
        assert [c[0] for c in calls] == ["repro_huber_contract_v",
                                         "repro_huber_contract_u_diag"]
        calls = calls[1:]
    (entry, name, outputs, ints), = calls
    assert name == ("huber_contract_u_diag" if entry.endswith("u_diag")
                    else fn)
    assert ints[:2] == (plan.splits, plan.cols)
    assert ints[-2:] == (plan.cluster, plan.slice)
    assert (plan.cluster > 0) == (256 < r <= 2048)
    if entry == "repro_huber_dual_contract":
        assert ints[2:4] == hc.dual_plan(e, m, n, r)
    u_partial = outputs[1] if entry == "repro_huber_contract_u" else (
        outputs[4] if entry.endswith("u_diag") else outputs[5])
    assert (u_partial is None) == (plan.splits == 1)
    if entry != "repro_huber_contract_u":
        diag = outputs[3] if entry.endswith("u_diag") else outputs[4]
        blocks = plan.grid[0] * plan.grid[1] if plan.cluster else \
            -(-m // 64) * plan.splits
        assert diag.numel() == 2 * e * blocks


@pytest.mark.parametrize("sms", [1, 78, 114, 132])
@pytest.mark.parametrize("e,m,n", [(1, 1, 1), (10, 3000, 300), (1, 3000, 3000),
                                   (4, 2048, 512), (3, 40, 24), (2, 65, 64),
                                   (1, 7, 129), (7, 1000, 4097),
                                   (1, 64, 100000)])
def test_u_splits_cover_n_in_whole_tiles(e, m, n, sms):
    """The row-stripe kernels' column ranges: each a whole number of the
    kernels' 64-column tiles, none empty, together exactly the n columns;
    a pure function of (E, m, n, SM count)."""
    splits, cols = hc.u_splits(e, m, n, sms)
    assert splits >= 1 and cols >= hc.U_TILE_COLS
    assert cols % hc.U_TILE_COLS == 0
    starts = [s * cols for s in range(splits)]
    assert all(start < n for start in starts)  # no empty range
    covered = sum(min(n, start + cols) - start for start in starts)
    assert covered == n
    hc.u_splits.cache_clear()
    assert hc.u_splits(e, m, n, sms) == (splits, cols)


@pytest.mark.parametrize("e,m,n,r", [(4, 2048, 512, 64), (1, 3000, 3000, 150),
                                     (2, 65, 7, 1), (3, 64, 24, 256),
                                     (1, 1, 1, 5)])
def test_dual_partial_shape_counts_64_row_stripes(e, m, n, r):
    """The dual's row groups cover the 64-row stripes: ``groups`` clusters
    of ``cluster`` stripes reach every stripe, no group is empty, and the
    groups fit the scratch's planes (``None``: the two-pass route)."""
    assert hc.U_TILE_ROWS == 64
    stripes = -(-m // 64)
    plan = hc.dual_plan(e, m, n, r)
    if plan is None:
        assert -(-stripes // 8) > hc.dual_groups(e, n, r)
        return
    cluster, groups = plan
    assert cluster in (1, 2, 4, 8) and groups >= 1
    assert groups * cluster >= stripes > (groups - 1) * cluster
    assert groups <= hc.dual_groups(e, n, r)


# (E, n, r): the compact-plane blocks at D in fp32 and at r = 256, the
# Fig. 1 blocks, one client's 3000 columns, and planes too large for two.
SCRATCH_SHAPES = [(4, 512, 64), (4, 512, 256), (10, 300, 150),
                  (1, 3000, 150), (10, 3000, 256), (3, 24, 5)]


@pytest.mark.parametrize("e,n,r", SCRATCH_SHAPES)
def test_dual_scratch_is_bounded_whatever_m(e, n, r):
    """huber_dual_contract's out_v scratch: a function of (E, n, r) alone
    (its bytes cannot grow with m), at most 4 MiB, with room for the row
    groups of every m that takes the one-pass route; 4 MiB exactly at D in
    fp32 (8 planes of 512 KB, where one plane a 64-row stripe took
    16.8 MB)."""
    shape = hc.dual_scratch_shape(e, n, r)
    planes = 1 if shape is None else shape[0]
    nbytes = 0 if shape is None else 4 * int(np.prod(shape))
    assert nbytes <= 4 << 20
    for m in (1, 64, 65, 700, 2048, 3000, 4096, 65536, 10 ** 6):
        plan = hc.dual_plan(e, m, n, r)
        assert plan is None or plan[1] <= planes
    if (e, n, r) == (4, 512, 64):
        assert shape == (8, 4, 512, 64) and nbytes == 4 << 20
        assert hc.dual_plan(4, 2048, 512, 64) == (4, 8)
