"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports torch and the port only (no JAX), so it runs on a machine that
has the card but not the reference; run it there without the suite's
conftest, which imports JAX:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: max|kernel - plain| <= 1e-4 * max|plain| for the planes (fp32
sums of up to 3000 products, taken in another order than cuBLAS) and
rtol 1e-5 for the scalar diagnostics (sums over every entry).
"""
import pytest
import torch

from repro_torch.kernels import huber_contract as hc
from repro_torch.kernels import ops
from repro_torch.kernels import shrinkage as sh

NAMES = ["huber_contract_u_diag", "huber_contract_u_diag_masked",
         "huber_contract_v", "huber_contract_v_masked", "residual_shrink",
         "residual_shrink_masked"]
SCALAR_RTOL = 1e-5


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_inputs(device, e, m, n, r, seed=0):
    g = torch.Generator().manual_seed(seed)
    scale = 1.0 / r ** 0.5
    u = torch.randn(e, m, r, generator=g) * scale
    v = torch.randn(e, n, r, generator=g) * scale
    mat = torch.randn(e, m, n, generator=g) * 2.0
    mat[torch.rand(e, m, n, generator=g) < 0.05] = 3000.0
    w = (torch.rand(e, m, n, generator=g) < 0.7).to(torch.float32)
    lam = torch.linspace(0.5, 2.0, e)
    return [x.to(device) for x in (u, v, mat, w, lam)]


def _kernel_and_plain(name, u, v, mat, w, lam):
    masked = name.endswith("_masked")
    base = name.removesuffix("_masked")
    module = sh if base == "residual_shrink" else hc
    kernel, plain = getattr(module, base), getattr(module, base + "_plain")
    args = (u, v, mat, lam, w if masked else None)
    return _as_tuple(kernel(*args)), _as_tuple(plain(*args))


def _assert_card_close(got, want):
    for g, p in zip(got, want):
        if g.ndim == 1:
            torch.testing.assert_close(g, p, rtol=SCALAR_RTOL, atol=0.0)
        else:
            err = (g - p).abs().max().item()
            assert err <= 1e-4 * p.abs().max().item(), err


# The shapes the solves give the kernels: dcf's client blocks and cf's one
# block (other grids: fewer column tiles per block row, no client axis).
SLICE_SHAPES = [(10, 3000, 300, 150), (1, 3000, 3000, 150)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", SLICE_SHAPES, ids=["dcf", "cf"])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_at_slice_shape(cuda, name, shape):
    got, want = _kernel_and_plain(name, *_card_inputs(cuda, *shape))
    torch.cuda.synchronize()
    _assert_card_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 40, 24, 5), (2, 33, 70, 1),
                                   (1, 65, 31, 256), (4, 100, 7, 33)])
@pytest.mark.parametrize("name", NAMES)
def test_kernel_matches_plain_ragged(cuda, name, shape):
    got, want = _kernel_and_plain(name, *_card_inputs(cuda, *shape))
    _assert_card_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["huber_contract_v", "huber_contract_u_diag",
                                  "residual_shrink"])
def test_kernel_all_ones_mask_and_reruns_are_bit_exact(cuda, name):
    u, v, mat, _, lam = _card_inputs(cuda, 10, 3000, 300, 150)
    fn = getattr(ops, name)
    first = _as_tuple(fn(u, v, mat, lam))
    again = _as_tuple(fn(u, v, mat, lam))
    masked = _as_tuple(fn(u, v, mat, lam, w=torch.ones_like(mat)))
    for a, b, c in zip(first, again, masked):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_operands(cuda):
    u, v, mat, w, lam = _card_inputs(cuda, 2, 40, 24, 5)
    with pytest.raises(ValueError, match="contiguous"):
        hc.huber_contract_v(u, v.transpose(1, 2).contiguous().transpose(1, 2),
                            mat, lam)
    with pytest.raises(TypeError, match="float32"):
        hc.huber_contract_v(u.double(), v, mat, lam)
    with pytest.raises(ValueError, match="rank"):
        big = torch.zeros(2, 40, 257, device=cuda)
        hc.huber_contract_v(big, torch.zeros(2, 24, 257, device=cuda), mat,
                            lam)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ops.huber_contract_u(u, v, mat, lam)


@pytest.mark.gpu
def test_solvers_refuse_tf32_matmuls(cuda):
    from repro_torch import rpca

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32"):
            rpca.solve(torch.zeros(8, 8, device=cuda), rank=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
