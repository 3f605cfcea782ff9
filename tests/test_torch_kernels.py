"""The port's kernel functions against the JAX reference.

On the CPU every wrapper of ``repro_torch.kernels`` returns its plain
version; these tests hold that against the reference's Pallas kernels (run
in interpret mode, as tests/test_kernels.py runs them) and its jnp oracles,
client by client, on small ragged shapes.  The CUDA kernels themselves are
held against their plain versions on the card in tests/test_torch_gpu.py.

Tolerances: contractions and S use rtol = atol = 2e-5 (as
tests/test_kernels.py: fp32 sums in another order); the scalar diagnostics
use rtol 1e-5 (a sum over every entry, taken in another order by each
framework).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bitmask as jbitmask
from repro.kernels import huber_contract as jhc
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


@pytest.mark.parametrize("against", ["pallas", "ref"])
@pytest.mark.parametrize("r", [5, 7])
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_plain_matches_reference(name, r, against):
    port_fn, pallas_fn, ref_fn = FAMILIES[name]
    jax_fn = pallas_fn if against == "pallas" else ref_fn
    u, v, m, w = _inputs(r)
    got = _as_tuple(port_fn(*(torch.from_numpy(x) for x in (u, v, m)),
                            torch.from_numpy(LAMS), torch.from_numpy(w)))
    for e in range(E):
        want = _as_tuple(jax_fn(jnp.asarray(u[e]), jnp.asarray(v[e]),
                                jnp.asarray(m[e]), float(LAMS[e]),
                                jnp.asarray(w[e])))
        assert len(got) == len(want)
        for g, ww in zip(got, want):
            g, ww = g[e].numpy(), np.asarray(ww)
            if ww.ndim == 0:
                np.testing.assert_allclose(g, ww, rtol=SCALAR_RTOL)
            else:
                np.testing.assert_allclose(g, ww, rtol=PLANE_TOL,
                                           atol=PLANE_TOL)


@pytest.mark.parametrize("name", ["huber_contract_v", "huber_contract_u_diag",
                                  "residual_shrink"])
def test_all_ones_mask_is_bit_exact(name):
    """Within the port, an all-ones mask gives the bits of no mask."""
    u, v, m, _ = (torch.from_numpy(x) for x in _inputs(7, seed=3))
    fn = getattr(ops, name)
    lam = torch.from_numpy(LAMS)
    plain = _as_tuple(fn(u, v, m, lam))
    masked = _as_tuple(fn(u, v, m, lam, w=torch.ones_like(m)))
    for a, b in zip(plain, masked):
        assert torch.equal(a, b)


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
    ones = bitmask.packed_ones((2, 5, n)).numpy()
    assert ones.tobytes() == np.asarray(
        jbitmask.packed_ones((2, 5, n))).tobytes()


def test_ops_dispatch_single_problem_and_impls():
    """2-D operands run as one client; impl='ref' and 'auto' agree on the
    CPU; 'cuda' refuses CPU tensors; unported ops name the roadmap."""
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
