"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
file imports torch and the port only (no JAX), so it runs on a machine that
has the card but not the reference; run it there without the suite's
conftest, which imports JAX:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: max|kernel - plain| <= 1e-4 * max|plain| for the planes (fp32
sums of up to 3000 products, taken in another order than cuBLAS) and
rtol 1e-5 for the scalar diagnostics (sums over every entry).  A bf16 M is
upcast exactly on both sides, so it keeps the same tolerances.  Masks:
``dense`` a 0/1 fp32 plane, ``packed`` the same plane bit-packed.

Flash attention against its plain version (fp32 softmax attention, not
rounded to the inputs' type), one query row (b, i) at a time: max over
(h, d) of |kernel - plain| <= tol * max over (h, d) of |plain|, tol 2e-5 in
fp32 (the kernel sums in another order and exponentiates in base 2) and
1e-2 in bf16 (the kernel rounds O to bf16, at most 2^-8 of the row's max,
and P to bf16 for P V, at most 2^-8 a weight).
"""
import copy
import json

import pytest
import torch

from repro_torch.kernels import bitmask, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import huber_contract as hc
from repro_torch.kernels import shrinkage as sh

CONTRACTIONS = ["huber_contract_v", "huber_contract_u",
                "huber_contract_u_diag", "huber_dual_contract"]
# (function, mask mode) pairs: every kernel function in all three modes.
CASES = [(f, mode)
         for f in CONTRACTIONS + ["residual_shrink", "residual_shrink_psi"]
         for mode in ("none", "dense", "packed")]
IDS = [f"{f}-{mode}" for f, mode in CASES]
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


def _card_inputs(device, e, m, n, r, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    scale = 1.0 / r ** 0.5
    u = torch.randn(e, m, r, generator=g) * scale
    v = torch.randn(e, n, r, generator=g) * scale
    mat = torch.randn(e, m, n, generator=g) * 2.0
    mat[torch.rand(e, m, n, generator=g) < 0.05] = 3000.0
    w = (torch.rand(e, m, n, generator=g) < 0.7).to(torch.float32)
    lam = torch.linspace(0.5, 2.0, e)
    return [x.to(device) for x in (u, v, mat.to(dtype), w, lam)]


def _mask(w, mode):
    return {"none": None, "dense": w, "packed": bitmask.pack_mask(w)}[mode]


def _kernel_and_plain(fn, mode, u, v, mat, w, lam):
    module = sh if fn.startswith("residual_shrink") else hc
    kernel, plain = getattr(module, fn), getattr(module, fn + "_plain")
    args = (u, v, mat, lam, _mask(w, mode))
    return _as_tuple(kernel(*args)), _as_tuple(plain(*args))


def _assert_card_close(got, want):
    assert len(got) == len(want)
    for g, p in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == p.shape
        if g.ndim == 1:
            torch.testing.assert_close(g, p, rtol=SCALAR_RTOL, atol=0.0)
        else:
            err = (g - p).abs().max().item()
            assert err <= 1e-4 * p.abs().max().item(), err


# The shapes the solves give the kernels: dcf's and off's client blocks,
# cf's one block (other grids: fewer column tiles per block row, no client
# axis), and the dual and compact phases' blocks.
SLICE_SHAPES = [(10, 3000, 300, 150), (1, 3000, 3000, 150),
                (4, 2048, 512, 64)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SLICE_SHAPES, ids=["dcf", "cf", "dual"])
@pytest.mark.parametrize("fn,mode", CASES, ids=IDS)
def test_kernel_matches_plain_at_slice_shape(cuda, fn, mode, shape, dtype):
    got, want = _kernel_and_plain(fn, mode,
                                  *_card_inputs(cuda, *shape, dtype=dtype))
    torch.cuda.synchronize()
    _assert_card_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(3, 40, 24, 5), (2, 33, 70, 1),
                                   (1, 65, 31, 256), (4, 100, 7, 33)])
@pytest.mark.parametrize("fn,mode", CASES, ids=IDS)
def test_kernel_matches_plain_ragged(cuda, fn, mode, shape, dtype):
    """Ragged m, n (n % 8 != 0: a packed tail byte) and r (not a multiple
    of 32)."""
    got, want = _kernel_and_plain(fn, mode,
                                  *_card_inputs(cuda, *shape, dtype=dtype))
    _assert_card_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(10, 3000, 300, 150), (4, 2048, 512, 64),
                                   (2, 33, 70, 5)])
@pytest.mark.parametrize("fn", CONTRACTIONS + ["residual_shrink"])
def test_masks_are_bit_exact(cuda, fn, shape):
    """Reruns, an all-ones mask and no mask give the same bits; a packed
    mask gives the bits of the dense mask it packs."""
    u, v, mat, w, lam = _card_inputs(cuda, *shape)
    f = getattr(ops, fn)
    first = _as_tuple(f(u, v, mat, lam))
    again = _as_tuple(f(u, v, mat, lam))
    ones = _as_tuple(f(u, v, mat, lam, w=torch.ones_like(mat)))
    dense = _as_tuple(f(u, v, mat, lam, w=w))
    packed = _as_tuple(f(u, v, mat, lam, w=bitmask.pack_mask(w)))
    for a, b, c in zip(first, again, ones):
        assert torch.equal(a, b) and torch.equal(a, c)
    for a, b in zip(dense, packed):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["none", "dense", "packed"])
def test_u_kernels_share_their_bits(cuda, mode):
    """huber_contract_u is u_diag without the diagnostics, and the dual
    kernel's Psi V and scalars are u_diag's, bit for bit."""
    u, v, mat, w, lam = _card_inputs(cuda, 4, 2048, 512, 64,
                                     dtype=torch.bfloat16)
    w = _mask(w, mode)
    out_u, obj, psi2 = hc.huber_contract_u_diag(u, v, mat, lam, w)
    assert torch.equal(hc.huber_contract_u(u, v, mat, lam, w), out_u)
    _, dual_u, dual_obj, dual_psi2 = hc.huber_dual_contract(u, v, mat, lam, w)
    assert torch.equal(dual_u, out_u)
    assert torch.equal(dual_obj, obj) and torch.equal(dual_psi2, psi2)


@pytest.mark.gpu
@pytest.mark.parametrize("n,masked", [(256, False), (253, True)])
def test_off_and_diag_give_the_same_factors(cuda, n, masked):
    """fused="off" and "diag" differ only in the U-step kernel, which gives
    the same Psi V bits: whole solves agree bit for bit."""
    from repro_torch.core import problems as prob
    from repro_torch.core.dcf_pca import dcf_pca
    from repro_torch.core.factorized import DCFConfig

    p = prob.generate_problem(3, 256, n, 8, 0.05, device=cuda,
                              observed_frac=0.8 if masked else 1.0)
    results = [dcf_pca(p.m_obs, DCFConfig.tuned(8, outer_iters=20,
                                                        fused=fused), 4,
                               mask=p.mask, device=cuda)
               for fused in ("diag", "off")]
    for a, b in zip(results[0][:4], results[1][:4]):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_kernel_wrappers_refuse_bad_operands(cuda):
    u, v, mat, w, lam = _card_inputs(cuda, 2, 40, 24, 5)
    with pytest.raises(ValueError, match="contiguous"):
        hc.huber_contract_v(u, v.transpose(1, 2).contiguous().transpose(1, 2),
                            mat, lam)
    with pytest.raises(TypeError, match="float32"):
        hc.huber_contract_v(u.double(), v, mat, lam)
    with pytest.raises(TypeError, match="float32"):
        hc.huber_dual_contract(u.to(torch.bfloat16), v, mat, lam)
    with pytest.raises(TypeError, match="bfloat16"):
        hc.huber_contract_u(u, v, mat.half(), lam)
    with pytest.raises(ValueError, match="mask shape"):
        hc.huber_contract_u(u, v, mat, lam,
                            bitmask.pack_mask(w)[..., :-1].contiguous())
    with pytest.raises(TypeError, match="dense float32"):
        sh.residual_shrink(u, v, mat, lam, w.half())
    with pytest.raises(ValueError, match="unsupported sizes"):
        hc.huber_contract_v(torch.zeros(2, 40, 0, device=cuda),
                            torch.zeros(2, 24, 0, device=cuda), mat, lam)
    with pytest.raises(ValueError, match="z axis"):  # E > 65535 clients
        e = 65536
        hc.huber_contract_v(torch.zeros(e, 1, 300, device=cuda),
                            torch.zeros(e, 1, 300, device=cuda),
                            torch.zeros(e, 1, 1, device=cuda),
                            torch.ones(e, device=cuda))
    s, psi = ops.residual_shrink_psi(u, v, mat, lam)
    assert s.is_cuda and psi.is_cuda and s.shape == mat.shape
    with pytest.raises(TypeError, match="dense float32"):
        sh.residual_shrink_psi(u, v, mat, lam, w.half())


@pytest.mark.gpu
def test_solvers_refuse_tf32_matmuls(cuda):
    from repro_torch import rpca

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(ValueError, match="TF32"):
            rpca.solve(torch.zeros(8, 8, device=cuda), method="cf", rank=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(10, 3000, 300, 150), (4, 2048, 512, 64),
                                   (2, 33, 70, 5)])
@pytest.mark.parametrize("mode", ["none", "dense", "packed"])
def test_psi_is_the_residual_and_s_is_the_shrink(cuda, mode, shape):
    """S + Psi == W R (the reference's identity, test_kernels.py:44),
    |Psi| <= lam, and the psi kernel's S is the shrink kernel's, bit for
    bit."""
    u, v, mat, w, lam = _card_inputs(cuda, *shape)
    wm = _mask(w, mode)
    s, psi = ops.residual_shrink_psi(u, v, mat, lam, w=wm)
    assert torch.equal(s, ops.residual_shrink(u, v, mat, lam, w=wm))
    r = mat - u @ v.transpose(1, 2)
    if mode != "none":
        r = w * r
    err = (s + psi - r).abs().max().item()
    assert err <= 1e-4 * r.abs().max().item(), err
    # |R - S| = lam where |R| > lam, up to the rounding of |R| - lam.
    assert (psi.abs() <= lam[:, None, None] + 1e-6 * r.abs()).all()


FLASH_SHAPES = [  # (b, sq, skv, h, d, causal)
    (2, 128, 128, 4, 64, True), (1, 100, 100, 2, 32, True),
    (2, 64, 200, 2, 64, False), (1, 256, 256, 3, 128, True),
    (1, 32, 96, 1, 16, False), (2, 77, 131, 3, 128, True),
    (2, 131, 77, 3, 16, True), (1, 1, 50, 2, 32, False),
    (1, 300, 300, 2, 64, False), (4, 2048, 2048, 2, 128, True),
]
# Error of each query row (b, i) against the plain version in fp32: max over
# (h, d) of |kernel - plain| over max over (h, d) of |plain|.  Causal rows
# differ in scale ~50x between the first and the last, so a bar on max|plain|
# of the whole call would not see faults in late rows.  bf16: the kernel's
# rounding of O (at most 2^-8 of the row's max) and of P for P V (at most
# 2^-8 a weight), ~5e-3 together.
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 1e-2}


def _flash_inputs(device, b, sq, skv, h, d, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(b, s, h, d, generator=g).to(dtype).to(device)
            for s in (sq, skv, skv)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES,
                         ids=["x".join(map(str, s)) for s in FLASH_SHAPES])
def test_flash_matches_plain(cuda, shape, dtype):
    """Every head dim the kernel takes, causal and full, ragged query and
    key lengths (not multiples of the tiles), S_q > S_kv and S_q < S_kv;
    each query row within its bar."""
    *dims, causal = shape
    q, k, v = _flash_inputs(cuda, *dims, dtype)
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    diff = (got.float() - want).abs().amax(dim=(2, 3))
    row_err = diff / want.abs().amax(dim=(2, 3))
    assert row_err.max().item() <= FLASH_TOL[dtype], row_err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_is_deterministic_and_counts_launches(cuda, dtype):
    q, k, v = _flash_inputs(cuda, 2, 300, 300, 4, 128, dtype, seed=1)
    before = fa.launches["flash_attention"]
    a = fa.flash_attention(q, k, v)
    b = fa.flash_attention(q, k, v)
    assert torch.equal(a, b)
    assert fa.launches["flash_attention"] == before + 2
    ref.flash_attention(q, k, v)  # the plain version launches no kernel
    assert fa.launches["flash_attention"] == before + 2


@pytest.mark.gpu
def test_flash_takes_strided_inputs_and_refuses_bad_ones(cuda):
    q, k, v = _flash_inputs(cuda, 1, 64, 64, 2, 32, torch.bfloat16)
    strided = q.transpose(1, 2).contiguous().transpose(1, 2)
    assert torch.equal(fa.flash_attention(strided, k, v),
                       fa.flash_attention(q, k, v))
    with pytest.raises(ValueError, match="head dim"):
        x = torch.zeros(1, 8, 2, 48, device=cuda)
        fa.flash_attention(x, x, x)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(q, k.float(), v)


@pytest.mark.gpu
def test_small_lm_on_the_card_matches_the_cpu(cuda):
    """The llama3-8b smoke config in fp32 with the flash kernel: greedy
    tokens equal to the CPU's (plain versions), logits within 1e-4."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops as kops
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeConfig, generate

    cfg = get_smoke_config("llama3-8b").replace(
        param_dtype="float32", compute_dtype="float32", flash_attention=True)
    model = get_model(cfg)
    params = model.init_params(seed=0, device="cpu")
    prompt = torch.randint(0, cfg.vocab, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    card = copy.deepcopy(params).to(cuda)
    cpu_logits, _ = model.prefill(params, prompt)
    kops.reset_launch_counts()
    logits, _ = model.prefill(card, prompt.to(cuda))
    assert kops.launch_counts()["flash_attention"] == cfg.n_layers
    err = (logits.cpu() - cpu_logits).abs().max().item()
    assert err <= 1e-4 * cpu_logits.abs().max().item(), err
    want = generate(model, params, prompt, ServeConfig(max_new_tokens=8))
    got = generate(model, card, prompt.to(cuda), ServeConfig(max_new_tokens=8))
    assert torch.equal(got.cpu(), want)


# The bf16 kernel's tiles: 128 query rows a block, 128-key tiles in a ring of
# two stages.  Shapes with more key tiles than stages, lengths that are not
# multiples of 128, S_q != S_kv both ways, a single query row, and more
# (b, h) pairs than the card has SMs (the grid wraps).
WGMMA_SHAPES = [  # (b, sq, skv, h)
    (1, 700, 700, 2), (2, 129, 385, 3), (1, 385, 129, 2), (1, 1, 300, 4),
    (1, 1, 1, 1), (3, 200, 257, 50),
]


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("shape", WGMMA_SHAPES,
                         ids=["x".join(map(str, s)) for s in WGMMA_SHAPES])
def test_flash_bf16_tiles_ring_and_edges(cuda, shape, d, causal):
    """The bf16 kernel at every head dim (each its own swizzle), causal and
    full: each query row within FLASH_TOL of the fp32 plain version, and a
    rerun gives the same bits."""
    q, k, v = _flash_inputs(cuda, *shape, d, torch.bfloat16, seed=d)
    got = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert torch.equal(got, again)
    diff = (got.float() - want).abs().amax(dim=(2, 3))
    row_err = diff / want.abs().amax(dim=(2, 3))
    assert row_err.max().item() <= FLASH_TOL[torch.bfloat16], \
        row_err.max().item()


# huber_contract_v's tiles are 64 x 64; (E, m, n) with m not a multiple of
# 64, in one row range and in several (v_splits decides from the shape).
V_SHAPES = [(1, 60, 200, False), (10, 50, 70, False), (1, 4000, 100, True),
            (10, 3001, 90, True)]  # (E, m, n, several row ranges)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 33, 150, 256])
@pytest.mark.parametrize("shape", V_SHAPES,
                         ids=["x".join(map(str, s[:3])) for s in V_SHAPES])
def test_contract_v_ranks_splits_and_masks(cuda, shape, r, dtype):
    """huber_contract_v at ranks that fill 1, 2, 5 and 8 register groups,
    with one row range and with several, in every mask mode: within
    PLANE_TOL of the plain version; packed == dense and all-ones == none bit
    for bit."""
    e, m, n, several = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, rows = hc.v_splits(e, m, n, sms)
    assert (splits > 1) == several and rows % hc.V_TILE_ROWS == 0
    u, v, mat, w, lam = _card_inputs(cuda, e, m, n, r, seed=r, dtype=dtype)
    outs = {}
    for mode in ("none", "dense", "packed"):
        got, want = _kernel_and_plain("huber_contract_v", mode, u, v, mat, w,
                                      lam)
        _assert_card_close(got, want)
        outs[mode] = got[0]
    ones = hc.huber_contract_v(u, v, mat, lam, torch.ones_like(w))
    assert torch.equal(outs["dense"], outs["packed"])
    assert torch.equal(outs["none"], ones)


# The row-stripe kernels (huber_contract_u, huber_contract_u_diag,
# huber_dual_contract) take 64-row stripes and walk 64-column tiles; (E, m,
# n) with m and n not multiples of 64 (n not of 8: a packed tail byte), E=1
# with several column ranges, and a shape in one range (u_splits decides
# from the shape).
STRIPE_SHAPES = [(1, 3001, 1000, True), (1, 200, 517, True),
                 (2, 1000, 77, True), (3, 130, 61, False)]
STRIPE_FNS = ["huber_contract_u", "huber_contract_u_diag",
              "huber_dual_contract"]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 31, 64, 150, 256])
@pytest.mark.parametrize("shape", STRIPE_SHAPES,
                         ids=["x".join(map(str, s[:3])) for s in STRIPE_SHAPES])
def test_stripe_kernels_ranks_splits_and_masks(cuda, shape, r, dtype):
    """The three row-stripe flavours at ranks that fill 1, 2, 5 and 8
    register groups, with one column range and with several, in every mask
    mode: within the plane and scalar tolerances of the plain versions;
    packed == dense, all-ones == none and a rerun bit for bit; and
    huber_contract_u, huber_contract_u_diag and huber_dual_contract share
    out_u, obj and psi2 bit for bit."""
    e, m, n, several = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    splits, cols = hc.u_splits(e, m, n, sms)
    assert (splits > 1) == several and cols % hc.U_TILE_COLS == 0
    u, v, mat, w, lam = _card_inputs(cuda, e, m, n, r, seed=r, dtype=dtype)
    outs = {}
    for fn in STRIPE_FNS:
        for mode in ("none", "dense", "packed"):
            got, want = _kernel_and_plain(fn, mode, u, v, mat, w, lam)
            _assert_card_close(got, want)
            outs[fn, mode] = got
        kernel = getattr(hc, fn)
        again = _as_tuple(kernel(u, v, mat, lam))
        ones = _as_tuple(kernel(u, v, mat, lam, torch.ones_like(w)))
        for a, b, c in zip(outs[fn, "none"], again, ones):
            assert torch.equal(a, b) and torch.equal(a, c)
        for a, b in zip(outs[fn, "dense"], outs[fn, "packed"]):
            assert torch.equal(a, b)
    for mode in ("none", "dense", "packed"):
        out_u, obj, psi2 = outs["huber_contract_u_diag", mode]
        assert torch.equal(outs["huber_contract_u", mode][0], out_u)
        _, dual_u, dual_obj, dual_psi2 = outs["huber_dual_contract", mode]
        assert torch.equal(dual_u, out_u)
        assert torch.equal(dual_obj, obj) and torch.equal(dual_psi2, psi2)


# The shrink's 64 x 64 tiles: m and n not multiples of 64 (n not of 8: a
# packed tail byte), one tile and many, several clients.
SHRINK_SHAPES = [(2, 130, 77), (1, 200, 517), (3, 65, 61), (1, 64, 64)]
# The new kernels against their plain versions: planes within 2e-5 of
# max|plain|, scalars within rtol 1e-5.
NEW_PLANE_TOL = 2e-5


def _assert_close_new(got, want):
    assert len(got) == len(want)
    for g, p in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == p.shape
        if g.ndim == 1:
            torch.testing.assert_close(g, p, rtol=SCALAR_RTOL, atol=0.0)
        else:
            err = (g - p).abs().max().item()
            assert err <= NEW_PLANE_TOL * p.abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [1, 31, 33, 64, 150, 256])
@pytest.mark.parametrize("shape", SHRINK_SHAPES,
                         ids=["x".join(map(str, s)) for s in SHRINK_SHAPES])
def test_shrink_tiles_ranks_and_masks(cuda, shape, r, dtype):
    """The shrink and its psi mode at ranks that fill 1, 2, 5 and 8 register
    groups (and 1 and 33: a ragged rank), ragged m and n, fp32 and bf16 M,
    in every mask mode: within 2e-5 of the plain versions; packed == dense,
    all-ones == none and a rerun bit for bit; and the psi mode's S is the
    shrink's S bit for bit."""
    u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=r, dtype=dtype)
    outs = {}
    for fn in ("residual_shrink", "residual_shrink_psi"):
        for mode in ("none", "dense", "packed"):
            got, want = _kernel_and_plain(fn, mode, u, v, mat, w, lam)
            _assert_close_new(got, want)
            outs[fn, mode] = got
        kernel = getattr(sh, fn)
        again = _as_tuple(kernel(u, v, mat, lam))
        ones = _as_tuple(kernel(u, v, mat, lam, torch.ones_like(w)))
        for a, b, c in zip(outs[fn, "none"], again, ones):
            assert torch.equal(a, b) and torch.equal(a, c)
        for a, b in zip(outs[fn, "dense"], outs[fn, "packed"]):
            assert torch.equal(a, b)
    for mode in ("none", "dense", "packed"):
        assert torch.equal(outs["residual_shrink_psi", mode][0],
                           outs["residual_shrink", mode][0])


@pytest.mark.gpu
def test_shrink_reads_packed_masks_itself(cuda):
    """ops.residual_shrink hands a packed mask to the kernel as it is (one
    launch of residual_shrink_packed) and gives the dense mask's bits."""
    u, v, mat, w, lam = _card_inputs(cuda, 4, 2048, 512, 64,
                                     dtype=torch.bfloat16)
    packed = bitmask.pack_mask(w)
    ops.reset_launch_counts()
    s = ops.residual_shrink(u, v, mat, lam, w=packed)
    counts = ops.launch_counts()
    assert counts["residual_shrink_packed"] == 1
    assert sum(counts.values()) == 1
    assert torch.equal(s, ops.residual_shrink(u, v, mat, lam, w=w))


# fp32 flash on the tensor cores: the grids of chip_smoke's rows a (1, 256,
# 256, 4), x (2, 64 x 200, 2) and T (4, 2048, 2048, 32; d = 64 causal
# only), S_q != S_kv both ways, a single query row, and a ragged tail.
F32_SHAPES = [(1, 256, 256, 4), (2, 64, 200, 2), (1, 100, 300, 3),
              (2, 300, 77, 2), (1, 1, 50, 2), (3, 130, 130, 5)]


def _f32_flash_check(cuda, b, sq, skv, h, d, causal, seed):
    q, k, v = _flash_inputs(cuda, b, sq, skv, h, d, torch.float32, seed=seed)
    got = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, again)
    diff = (got - want).abs().amax(dim=(2, 3))
    row_err = diff / want.abs().amax(dim=(2, 3))
    assert row_err.max().item() <= FLASH_TOL[torch.float32], \
        row_err.max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("shape", F32_SHAPES,
                         ids=["x".join(map(str, s)) for s in F32_SHAPES])
def test_flash_f32_tensor_cores_and_key_split(cuda, shape, d, causal):
    """The 3xTF32 kernel at every head dim, causal and full, with and
    without a key split over a cluster (rows a and x split 4 ways): each
    query row within 2e-5 of the fp32 plain version, reruns bit for
    bit."""
    b, sq, skv, h = shape
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    if shape in [(1, 256, 256, 4), (2, 64, 200, 2)] and d == 64:
        assert fa.f32_split(b, sq, skv, h, d, sms) == 4
    _f32_flash_check(cuda, b, sq, skv, h, d, causal, seed=d)


@pytest.mark.gpu
def test_flash_f32_full_width_row(cuda):
    """Row T (TinyLlama-1.1B's prefill, GQA expanded: B=4, S=2048, H=32,
    d=64, causal), one block a query tile."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert fa.f32_split(4, 2048, 2048, 32, 64, sms) == 1
    _f32_flash_check(cuda, 4, 2048, 2048, 32, 64, True, seed=3)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", [64, 256])
def test_dual_bounded_scratch_keeps_u_diag_bits(cuda, r, dtype):
    """The dual at D's blocks (E=4, 2048 x 512) with its scratch within
    4 MiB: row groups of 4 stripes (clusters) at r = 64, the two passes at
    r = 256 (clusters of 8 would need 4 planes of 2 MiB).  out_v within
    2e-5 of the plain version, and out_u, obj and psi2 those of
    huber_contract_u_diag bit for bit, in every mask mode."""
    e, m, n = 4, 2048, 512
    plan = hc.dual_plan(e, m, n, r)
    assert plan == ((4, 8) if r == 64 else None)
    shape = hc.dual_scratch_shape(e, n, r)
    assert 4 * shape[0] * e * n * r <= 4 << 20
    u, v, mat, w, lam = _card_inputs(cuda, e, m, n, r, seed=r, dtype=dtype)
    for mode in ("none", "dense", "packed"):
        got, want = _kernel_and_plain("huber_dual_contract", mode, u, v, mat,
                                      w, lam)
        _assert_close_new(got[:1], want[:1])
        diag = hc.huber_contract_u_diag(u, v, mat, lam, _mask(w, mode))
        for a, b in zip(got[1:], diag):
            assert torch.equal(a, b)


# Ranks 257 .. 512, on a small grid and on one with several row ranges
# (v_splits) and column ranges (u_splits) at E = 1: the contractions take
# their cluster kernels there (two rank slices), the shrink its stream
# kernel (csrc/shrink.cu: 128 x 64 tiles, 9 to 16 slabs of 32 ranks, the
# last one partial but at 384, 448 and 512).  Both shapes end in a
# partial tile of every kernel.
WIDE_RANKS = [257, 300, 384, 448, 500, 512]
WIDE_SHAPES = [(2, 200, 133), (1, 700, 650)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", WIDE_RANKS)
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s in WIDE_SHAPES])
@pytest.mark.parametrize("fn,mode", CASES, ids=IDS)
def test_wide_ranks_match_plain(cuda, fn, mode, shape, r, dtype):
    """Every RPCA kernel flavour at r > 256 (plain, dense and packed mask,
    fp32 and bf16 M, the psi mode) within 2e-5 of its plain version."""
    got, want = _kernel_and_plain(
        fn, mode, *_card_inputs(cuda, *shape, r, seed=r, dtype=dtype))
    torch.cuda.synchronize()
    _assert_close_new(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s in WIDE_SHAPES])
def test_wide_ranks_keep_the_bit_exact_pairs(cuda, shape):
    """At r = 500: all-ones mask == no mask, packed == dense, reruns, u ==
    u_diag (off == diag), the dual's out_u, obj and psi2 are u_diag's, and
    the psi mode's S is the shrink's, bit for bit."""
    u, v, mat, w, lam = _card_inputs(cuda, *shape, 500, seed=5)
    packed = bitmask.pack_mask(w)
    for fn in CONTRACTIONS + ["residual_shrink", "residual_shrink_psi"]:
        f = getattr(ops, fn)
        none = _as_tuple(f(u, v, mat, lam))
        for a, b, c in zip(none, _as_tuple(f(u, v, mat, lam)),
                           _as_tuple(f(u, v, mat, lam,
                                       w=torch.ones_like(mat)))):
            assert torch.equal(a, b) and torch.equal(a, c), fn
        for a, b in zip(_as_tuple(f(u, v, mat, lam, w=w)),
                        _as_tuple(f(u, v, mat, lam, w=packed))):
            assert torch.equal(a, b), fn
    for wm in (None, w, packed):
        out_u, obj, psi2 = hc.huber_contract_u_diag(u, v, mat, lam, wm)
        assert torch.equal(hc.huber_contract_u(u, v, mat, lam, wm), out_u)
        _, dual_u, dual_obj, dual_psi2 = hc.huber_dual_contract(u, v, mat,
                                                                lam, wm)
        assert torch.equal(dual_u, out_u)
        assert torch.equal(dual_obj, obj) and torch.equal(dual_psi2, psi2)
        s, _ = sh.residual_shrink_psi(u, v, mat, lam, wm)
        assert torch.equal(s, sh.residual_shrink(u, v, mat, lam, wm))


@pytest.mark.gpu
@pytest.mark.parametrize("m,launched", [(640, True), (2048, False)])
def test_dual_scratch_at_rank_512(cuda, m, launched):
    """At r = 512 the dual's row groups are single stripes (no room for a
    cluster's receive buffers): its out_v scratch stays within 4 MiB, the
    kernel runs where every stripe has a plane (m = 640: 10 planes of
    256 KB) and takes the two passes where not (m = 2048: 32 stripes, 16
    planes fit 4 MiB)."""
    e, n, r = 1, 128, 512
    plan = hc.dual_plan(e, m, n, r)
    assert (plan == (1, m // 64)) if launched else plan is None
    shape = hc.dual_scratch_shape(e, n, r)
    assert 4 * shape[0] * e * n * r <= 4 << 20
    u, v, mat, w, lam = _card_inputs(cuda, e, m, n, r, seed=3)
    hc.launches["huber_dual_contract_masked"] = 0
    got, want = _kernel_and_plain("huber_dual_contract", "dense", u, v, mat,
                                  w, lam)
    assert hc.launches["huber_dual_contract_masked"] == int(launched)
    _assert_close_new(got, want)


@pytest.mark.gpu
def test_dual_clusters_only_where_they_fit(cuda):
    """Row groups are clusters only up to r = 160, where a cluster's
    receive buffers fit beside the stripe (RQ = 6 would need 266 KB); at
    r = 192 a shape that wanted clusters of 2 takes the two passes."""
    assert hc.dual_plan(1, 1024, 512, 160)[0] == 2
    assert hc.dual_plan(1, 1024, 512, 192) is None
    u, v, mat, w, lam = _card_inputs(cuda, 1, 1024, 512, 192, seed=4)
    got, want = _kernel_and_plain("huber_dual_contract", "none", u, v, mat,
                                  w, lam)
    _assert_close_new(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["ialm", "apgm"])
@pytest.mark.parametrize("masked", [False, True], ids=["dense", "masked"])
def test_convex_solvers_on_the_card_match_the_cpu(cuda, method, masked):
    """IALM (60 iterations) and APGM (200) through the front door on the
    card and on the CPU from the same 160 x 160 problem: L and S within
    1e-5 relative (one cuSOLVER and one LAPACK SVD an iteration)."""
    from repro_torch import rpca
    from repro_torch.core import APGMConfig, IALMConfig
    from repro_torch.core import problems as prob

    p = prob.generate_problem(7, 160, 160, 8, 0.05, device="cpu",
                              observed_frac=0.8 if masked else 1.0)
    cfg = IALMConfig(iters=60) if method == "ialm" else APGMConfig(iters=200)
    cpu = rpca.solve(p.m_obs, method=method, cfg=cfg, mask=p.mask,
                     device="cpu")
    card = rpca.solve(p.m_obs.to(cuda), method=method, cfg=cfg,
                      mask=None if p.mask is None else p.mask.to(cuda))
    assert card.l.is_cuda and card.u is None
    for a, b in ((card.l, cpu.l), (card.s, cpu.s)):
        rel = (torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)).item()
        assert rel <= 1e-5, rel


@pytest.mark.gpu
def test_svt_on_the_card_matches_the_cpu(cuda):
    from repro_torch.core import ops as core_ops

    x = torch.randn(160, 120, generator=torch.Generator().manual_seed(0))
    want, sv_want = core_ops.svt(x, 3.0)
    got, sv = core_ops.svt(x.to(cuda), torch.tensor(3.0, device=cuda))
    torch.testing.assert_close(sv.cpu(), sv_want, rtol=1e-5, atol=1e-5)
    assert (torch.linalg.norm(got.cpu() - want)
            / torch.linalg.norm(want)).item() <= 1e-5


# Ranks above 512: the shrink's stream kernel at 17 to 32 slabs of 32
# ranks (513: one rank in the last slab); the contractions' cluster kernels
# of three and four rank slices.
CHUNK_RANKS = [513, 600, 768, 1024]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", CHUNK_RANKS)
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s in WIDE_SHAPES])
@pytest.mark.parametrize("fn,mode", CASES, ids=IDS)
def test_chunked_ranks_match_plain(cuda, fn, mode, shape, r, dtype):
    """Every RPCA kernel flavour at r > 512 (plain, dense and packed mask,
    fp32 and bf16 M, the psi mode) within 2e-5 of its plain version, and
    launched (not passed to the plain version)."""
    suffix = {"none": "", "dense": "_masked", "packed": "_packed"}[mode]
    names = [fn + suffix]
    if fn == "huber_dual_contract" and hc.dual_plan(*shape, r) is None:
        # past its 4 MiB of scratch the dual takes the two passes
        names = ["huber_contract_v" + suffix, "huber_contract_u_diag" + suffix]
    before = ops.launch_counts()
    got, want = _kernel_and_plain(
        fn, mode, *_card_inputs(cuda, *shape, r, seed=r, dtype=dtype))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in names) for k in after}
    _assert_close_new(got, want)


def _bit_exact_pairs(u, v, mat, w, lam):
    """all-ones mask == no mask, packed == dense, reruns, u == u_diag, the
    dual's out_u, obj and psi2 are u_diag's, the psi mode's S is the
    shrink's, bit for bit."""
    packed = bitmask.pack_mask(w)
    for fn in CONTRACTIONS + ["residual_shrink", "residual_shrink_psi"]:
        f = getattr(ops, fn)
        none = _as_tuple(f(u, v, mat, lam))
        for a, b, c in zip(none, _as_tuple(f(u, v, mat, lam)),
                           _as_tuple(f(u, v, mat, lam,
                                       w=torch.ones_like(mat)))):
            assert torch.equal(a, b) and torch.equal(a, c), fn
        for a, b in zip(_as_tuple(f(u, v, mat, lam, w=w)),
                        _as_tuple(f(u, v, mat, lam, w=packed))):
            assert torch.equal(a, b), fn
    for wm in (None, w, packed):
        out_u, obj, psi2 = hc.huber_contract_u_diag(u, v, mat, lam, wm)
        assert torch.equal(hc.huber_contract_u(u, v, mat, lam, wm), out_u)
        _, dual_u, dual_obj, dual_psi2 = hc.huber_dual_contract(u, v, mat,
                                                                lam, wm)
        assert torch.equal(dual_u, out_u)
        assert torch.equal(dual_obj, obj) and torch.equal(dual_psi2, psi2)
        s, _ = sh.residual_shrink_psi(u, v, mat, lam, wm)
        assert torch.equal(s, sh.residual_shrink(u, v, mat, lam, wm))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s in WIDE_SHAPES])
def test_chunked_ranks_keep_the_bit_exact_pairs(cuda, shape):
    """At r = 600 (three chunks) every bit-exact pair holds; the dual runs
    its one pass at 2 x 200 x 133 (4 single-stripe planes within 4 MiB)
    and the two passes at 1 x 700 x 650 (11 stripes, 2 planes fit)."""
    e, m, n = shape
    assert (hc.dual_plan(e, m, n, 600) is None) == (m == 700)
    _bit_exact_pairs(*_card_inputs(cuda, *shape, 600, seed=6))


# The shrink's stream kernel past the contractions' cluster ranks (2049:
# one rank in the last slab; 2304: 72 whole slabs) on WIDE_SHAPES and on a
# single partial 128-row tile (3 clients of 127 x 70), which also takes
# every rank of WIDE_RANKS and CHUNK_RANKS.  The last column tile of each
# holds at most 16 columns and sums only its two column groups inside the
# plane; at 2 x 130 x 90 (26 columns) it sums all eight.
STREAM_RANKS = [2049, 2304]
STREAM_EDGE = (3, 127, 70)
STREAM_GROUPS = (2, 130, 90)
STREAM_CASES = ([(s, r) for s in WIDE_SHAPES for r in STREAM_RANKS]
                + [(STREAM_EDGE, r)
                   for r in WIDE_RANKS + CHUNK_RANKS + STREAM_RANKS]
                + [(STREAM_GROUPS, r) for r in (300, 600)])
STREAM_IDS = [f"{'x'.join(map(str, s))}-r{r}" for s, r in STREAM_CASES]
SHRINK_CASES = [c for c in CASES if c[0].startswith("residual_shrink")]
SHRINK_IDS = [i for c, i in zip(CASES, IDS) if c in SHRINK_CASES]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,r", STREAM_CASES, ids=STREAM_IDS)
@pytest.mark.parametrize("fn,mode", SHRINK_CASES, ids=SHRINK_IDS)
def test_stream_ranks_match_plain(cuda, fn, mode, shape, r, dtype):
    """The shrink and its psi mode on the stream route (every mask mode,
    fp32 and bf16 M) within 2e-5 of the plain version, one launch of the
    kernel a call."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert sh.shrink_plan(*shape, r, sms).route == "stream"
    name = fn + {"none": "", "dense": "_masked", "packed": "_packed"}[mode]
    before = ops.launch_counts()
    got, want = _kernel_and_plain(
        fn, mode, *_card_inputs(cuda, *shape, r, seed=r, dtype=dtype))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}
    _assert_close_new(got, want)


@pytest.mark.gpu
def test_stream_resident_blocks_are_the_cards(cuda):
    """shrink_plan's resident blocks of the stream kernel (its waves) are
    every instance's own cudaOccupancyMaxActiveBlocksPerMultiprocessor."""
    for dtype in (0, 1):
        for mask in (0, 1, 2):
            for psi in (False, True):
                assert sh.stream_resident_on_device(
                    cuda, dtype, mask, psi) == sh.STREAM_RESIDENT


@pytest.mark.gpu
@pytest.mark.parametrize("shape,r", STREAM_CASES, ids=STREAM_IDS)
def test_stream_ranks_keep_the_bit_exact_pairs(cuda, shape, r):
    """The shrink's bit-exact pairs on the stream route, in fp32 and bf16:
    reruns, all-ones mask == no mask, packed == dense, and the psi mode's S
    is the shrink's, bit for bit."""
    for dtype in (torch.float32, torch.bfloat16):
        u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=r + 1,
                                         dtype=dtype)
        packed = bitmask.pack_mask(w)
        for f in (sh.residual_shrink, sh.residual_shrink_psi):
            none = _as_tuple(f(u, v, mat, lam))
            for a, b, c in zip(none, _as_tuple(f(u, v, mat, lam)),
                               _as_tuple(f(u, v, mat, lam,
                                           torch.ones_like(w)))):
                assert torch.equal(a, b) and torch.equal(a, c)
            for a, b in zip(_as_tuple(f(u, v, mat, lam, w)),
                            _as_tuple(f(u, v, mat, lam, packed))):
                assert torch.equal(a, b)
        for wm in (None, w, packed):
            s, _ = sh.residual_shrink_psi(u, v, mat, lam, wm)
            assert torch.equal(s, sh.residual_shrink(u, v, mat, lam, wm))


@pytest.mark.gpu
@pytest.mark.parametrize("r", [460, 500])
@pytest.mark.parametrize("shape", WIDE_SHAPES,
                         ids=["x".join(map(str, s)) for s in WIDE_SHAPES])
@pytest.mark.parametrize("fn,mode", [c for c in CASES
                                     if c[0] in CONTRACTIONS],
                         ids=[i for c, i in zip(CASES, IDS)
                              if c[0] in CONTRACTIONS])
def test_chunk_order_is_the_two_half_order(cuda, monkeypatch, fn, mode,
                                           shape, r):
    """At r 449-512 two rank slices of 256 are two chunks of 256: each
    contraction's cluster kernel, given them as its slices, gives the
    planes' bits of its chunk kernel (forced by lowering the cluster
    limits); both sum the slices or chunks in order over the same row or
    column splits.  The row-stripe kernels' diagnostics sum other partials
    (the cluster kernel's blocks each a share of the tile's entries, the
    chunk kernel's first block all of them), so they agree within
    SCALAR_RTOL."""
    from repro_torch.kernels import _launch

    u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=r)
    args = (u, v, mat, lam, _mask(w, mode))
    monkeypatch.setattr(hc, "v_slices", lambda rank: (2, 256))
    monkeypatch.setattr(hc, "u_slices", lambda rank: (2, 256))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert hc.u_plan(*shape, r, sms)[:2] == (2, 256)
    slices = _as_tuple(getattr(hc, fn)(*args))
    monkeypatch.setattr(_launch, "V_CLUSTER_MAX_RANK", 256)
    monkeypatch.setattr(_launch, "U_CLUSTER_MAX_RANK", 256)
    assert _launch.v_chunked(r) and _launch.u_chunked(r)
    assert hc.v_plan(*shape, r, sms).cluster == 0
    assert hc.u_plan(*shape, r, sms).cluster == 0
    assert (hc.v_splits(*shape, sms, 2)
            == hc.v_splits(*shape, sms, cluster=2))
    assert (hc.u_splits(*shape, sms, 2)
            == hc.u_splits(*shape, sms, cluster=2))
    chunks = _as_tuple(getattr(hc, fn)(*args))
    assert len(slices) == len(chunks)
    for a, b in zip(slices, chunks):
        if a.ndim == 1:
            torch.testing.assert_close(a, b, rtol=SCALAR_RTOL, atol=0)
        else:
            assert torch.equal(a, b), fn


# huber_contract_v's cluster kernel (r 257-2048, csrc/contract_v.cu): 2 to
# 8 blocks a column tile, each a rank slice of up to 256; one rank above it
# takes the chunk kernel.  Shapes: WIDE_SHAPES and three clients of 3001
# ragged rows in several row splits at every rank.
CLUSTER_RANKS = [257, 300, 448, 500, 512, 513, 600, 768, 1024, 2048, 2049]
CLUSTER_SHAPES = WIDE_SHAPES + [(3, 3001, 70)]
CLUSTER_IDS = ["x".join(map(str, s)) for s in CLUSTER_SHAPES]


def _contract_v_route(shape, r, sms):
    """The device kernel one huber_contract_v call launches at this rank,
    and its plan."""
    from repro_torch.kernels import _launch

    plan = hc.v_plan(*shape, r, sms)
    name = ("contract_v_chunk_kernel" if _launch.v_chunked(r)
            else "contract_v_cluster_kernel")
    return name, plan


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", CLUSTER_RANKS)
@pytest.mark.parametrize("shape", CLUSTER_SHAPES, ids=CLUSTER_IDS)
@pytest.mark.parametrize("mode", ["none", "dense", "packed"])
def test_cluster_ranks_match_plain(cuda, mode, shape, r, dtype):
    """huber_contract_v at every rank route above 256 (the cluster kernel
    at 2-8 slices, the chunk kernel one rank past them) in every mask mode
    and M type: one launch a call, within 2e-5 of the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, plan = _contract_v_route(shape, r, sms)
    assert (plan.cluster > 0) == (r <= 2048)
    assert plan.splits > 1 or shape != (3, 3001, 70)
    name = "huber_contract_v" + {"none": "", "dense": "_masked",
                                 "packed": "_packed"}[mode]
    before = ops.launch_counts()
    got, want = _kernel_and_plain(
        "huber_contract_v", mode,
        *_card_inputs(cuda, *shape, r, seed=r, dtype=dtype))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}
    _assert_close_new(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("r", CLUSTER_RANKS)
@pytest.mark.parametrize("shape", CLUSTER_SHAPES, ids=CLUSTER_IDS)
def test_cluster_ranks_keep_the_bit_exact_pairs(cuda, shape, r):
    """huber_contract_v at every rank route above 256: reruns, all-ones
    mask == no mask and packed == dense, bit for bit, in fp32 and bf16."""
    for dtype in (torch.float32, torch.bfloat16):
        u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=r + 1,
                                         dtype=dtype)
        none = hc.huber_contract_v(u, v, mat, lam)
        assert torch.equal(none, hc.huber_contract_v(u, v, mat, lam))
        assert torch.equal(none, hc.huber_contract_v(u, v, mat, lam,
                                                     torch.ones_like(w)))
        assert torch.equal(hc.huber_contract_v(u, v, mat, lam, w),
                           hc.huber_contract_v(u, v, mat, lam,
                                               bitmask.pack_mask(w)))


@pytest.mark.gpu
@pytest.mark.parametrize("slice_", [132, 256], ids=["rq5", "rq8"])
def test_cluster_slots_are_the_cards(cuda, slice_):
    """The resident clusters huber_contract_v's row splits and the
    row-stripe kernels' column splits are costed with (``cluster_slots``)
    are each cluster kernel's own cudaOccupancyMaxActiveClusters on a
    132-SM H100, and never more than the card's elsewhere."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for cluster in range(2, 9):
        for on_device in (hc.v_cluster_slots_on_device,
                          hc.u_cluster_slots_on_device):
            card = on_device(cuda, cluster, slice_)
            assert 1 <= card <= sms // cluster
            if sms == 132:
                assert hc.cluster_slots(cluster, sms) == card
            else:
                assert hc.cluster_slots(cluster, sms) >= card


STRIPE_IDS = ["huber_contract_u", "huber_contract_u_diag",
              "huber_dual_contract"]
# The row-stripe kernels' cluster shapes: CLUSTER_SHAPES (several column
# ranges at 1 x 700 x 650 up to four slices) and two clients of three
# ragged stripes, where the dual takes its one pass at every rank.
STRIPE_CLUSTER_SHAPES = CLUSTER_SHAPES + [(2, 130, 77)]
STRIPE_CLUSTER_IDS = ["x".join(map(str, s)) for s in STRIPE_CLUSTER_SHAPES]


def _stripe_names(fn, mode, shape, r):
    """The launch counters one call of a row-stripe flavour moves: its own,
    or past the dual's 4 MiB of out_v scratch the two passes'."""
    suffix = {"none": "", "dense": "_masked", "packed": "_packed"}[mode]
    if fn == "huber_dual_contract" and hc.dual_plan(*shape, r) is None:
        return ["huber_contract_v" + suffix, "huber_contract_u_diag" + suffix]
    return [fn + suffix]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("r", CLUSTER_RANKS)
@pytest.mark.parametrize("shape", STRIPE_CLUSTER_SHAPES,
                         ids=STRIPE_CLUSTER_IDS)
@pytest.mark.parametrize("mode", ["none", "dense", "packed"])
@pytest.mark.parametrize("fn", STRIPE_IDS)
def test_stripe_cluster_ranks_match_plain(cuda, fn, mode, shape, r, dtype):
    """The three row-stripe flavours at every rank route above 256 (the
    cluster kernel at 2-8 slices, the chunk kernel one rank past them) in
    every mask mode and M type: one launch a call (the dual's two passes
    past its scratch), within 2e-5 of the plain version and the scalars
    within 1e-5 relative."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = hc.u_plan(*shape, r, sms)
    assert (plan.cluster > 0) == (r <= 2048)
    if shape == (1, 700, 650) and r <= 1024:
        assert plan.splits > 1
    if shape == (2, 130, 77):
        assert hc.dual_plan(*shape, r) is not None
    names = _stripe_names(fn, mode, shape, r)
    before = ops.launch_counts()
    got, want = _kernel_and_plain(
        fn, mode, *_card_inputs(cuda, *shape, r, seed=r, dtype=dtype))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k in names) for k in after}
    _assert_close_new(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("r", CLUSTER_RANKS)
@pytest.mark.parametrize("shape", STRIPE_CLUSTER_SHAPES,
                         ids=STRIPE_CLUSTER_IDS)
def test_stripe_cluster_ranks_keep_the_bit_exact_pairs(cuda, shape, r):
    """The row-stripe flavours at every rank route above 256, in fp32 and
    bf16: reruns, all-ones mask == no mask and packed == dense; u == u_diag
    (off == diag) and the dual's out_u, obj and psi2 are u_diag's, bit for
    bit."""
    for dtype in (torch.float32, torch.bfloat16):
        u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=r + 1,
                                         dtype=dtype)
        packed = bitmask.pack_mask(w)
        for fn in STRIPE_IDS:
            f = getattr(hc, fn)
            none = _as_tuple(f(u, v, mat, lam))
            for a, b, c in zip(none, _as_tuple(f(u, v, mat, lam)),
                               _as_tuple(f(u, v, mat, lam,
                                           torch.ones_like(w)))):
                assert torch.equal(a, b) and torch.equal(a, c), fn
            for a, b in zip(_as_tuple(f(u, v, mat, lam, w)),
                            _as_tuple(f(u, v, mat, lam, packed))):
                assert torch.equal(a, b), fn
        for wm in (None, w, packed):
            out_u, obj, psi2 = hc.huber_contract_u_diag(u, v, mat, lam, wm)
            assert torch.equal(hc.huber_contract_u(u, v, mat, lam, wm),
                               out_u)
            _, dual_u, dual_obj, dual_psi2 = hc.huber_dual_contract(
                u, v, mat, lam, wm)
            assert torch.equal(dual_u, out_u)
            assert torch.equal(dual_obj, obj)
            assert torch.equal(dual_psi2, psi2)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [150, 300, 500, 600, 2048, 2049])
@pytest.mark.parametrize("shape", [(1, 700, 650), (3, 3001, 70)],
                         ids=["1x700x650", "3x3001x70"])
def test_stripe_is_one_kernel_node_a_call(cuda, shape, r):
    """A captured huber_contract_u_diag call is one graph kernel node of
    the stripe family, named for its rank route (stripe_kernel up to 256,
    the cluster kernel at 257-2048, the chunk kernel above), and one
    fixed-order sum (the diagnostics, with out_u's splits), nothing
    else."""
    from repro_torch.core import graph_nodes

    name = ("stripe_kernel" if r <= 256 else "stripe_cluster_kernel"
            if r <= 2048 else "stripe_chunk_kernel")
    u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=2)
    hc.huber_contract_u_diag(u, v, mat, lam, w)  # built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = hc.huber_contract_u_diag(u, v, mat, lam, w)
    nodes = graph_nodes.kernel_nodes(graph.raw_cuda_graph())
    assert ops.kernels_by_family(nodes) == {"contract_v": 0, "stripe": 1,
                                            "shrink": 0}
    stripe = [k for k in nodes if "stripe_" in k][0]
    assert stripe.count(name) == 1
    assert sum(c for k, c in nodes.items() if "sum_partials_kernel" in k) == 1
    assert sum(nodes.values()) == 2
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.isfinite(x).all() for x in out)


@pytest.mark.gpu
@pytest.mark.parametrize("r", [150, 300, 500, 600, 2048, 2049])
@pytest.mark.parametrize("shape", [(1, 700, 650), (3, 3001, 70)],
                         ids=["1x700x650", "3x3001x70"])
def test_contract_v_is_one_kernel_node_a_call(cuda, shape, r):
    """A captured huber_contract_v call is one graph kernel node of the
    contract_v family, named for its rank route (the cluster kernel at r
    257-2048, the chunk kernel above), plus the fixed-order sum of the
    row splits where there are several, and nothing else."""
    from repro_torch.core import graph_nodes

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    name, plan = _contract_v_route(shape, r, sms)
    if r <= 256:
        name = "contract_v_kernel"
    u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=2)
    hc.huber_contract_v(u, v, mat, lam, w)  # built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = hc.huber_contract_v(u, v, mat, lam, w)
    nodes = graph_nodes.kernel_nodes(graph.raw_cuda_graph())
    assert ops.kernels_by_family(nodes) == {"contract_v": 1, "stripe": 0,
                                            "shrink": 0}
    assert [k for k in nodes if "contract_v_" in k][0].count(name) == 1
    sums = sum(c for k, c in nodes.items() if "sum_partials_kernel" in k)
    assert sums == int(plan.splits > 1)
    assert sum(nodes.values()) == 1 + sums
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, hc.huber_contract_v(u, v, mat, lam, w))


@pytest.mark.gpu
@pytest.mark.parametrize("r", [150, 300, 600, 2049])
def test_shrink_is_one_kernel_node_a_call(cuda, r):
    """A captured residual_shrink call is one graph kernel node of the
    shrink family, named for its rank route (shrink_kernel up to 256,
    shrink_stream_kernel above), and nothing else."""
    from repro_torch.core import graph_nodes

    name = "shrink_kernel" if r <= 256 else "shrink_stream_kernel"
    u, v, mat, w, lam = _card_inputs(cuda, 1, 700, 650, r, seed=2)
    sh.residual_shrink(u, v, mat, lam, w)  # built and loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        out = sh.residual_shrink(u, v, mat, lam, w)
    nodes = graph_nodes.kernel_nodes(graph.raw_cuda_graph())
    assert ops.kernels_by_family(nodes) == {"contract_v": 0, "stripe": 0,
                                            "shrink": 1}
    assert sum(nodes.values()) == 1
    assert next(iter(nodes)).count(name) == 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, sh.residual_shrink(u, v, mat, lam, w))


def _assert_close_nan(got, want):
    """NaN where the plain version has NaN, and within 2e-5 of it
    elsewhere (planes relative to max|plain| over the finite entries)."""
    assert len(got) == len(want)
    for g, p in zip(got, want):
        assert g.shape == p.shape
        assert torch.equal(g.isnan(), p.isnan())
        ok = ~p.isnan()
        if g.ndim == 1:
            torch.testing.assert_close(g[ok], p[ok], rtol=SCALAR_RTOL,
                                       atol=0.0)
        elif ok.any():
            err = (g[ok] - p[ok]).abs().max().item()
            assert err <= NEW_PLANE_TOL * p[ok].abs().max().item(), err


@pytest.mark.gpu
@pytest.mark.parametrize("r", [64, 300, 600])
@pytest.mark.parametrize("fn,mode", CASES, ids=IDS)
def test_nan_inputs_give_the_plain_versions_nans(cuda, fn, mode, r):
    """A NaN row of client 0's U (a poisoned consensus payload) and a NaN
    entry of client 1's M: the kernels' Psi clip and shrink propagate NaN
    as torch.clamp and torch.sign do, so every output is NaN exactly where
    the plain version's is (client 0's obj and psi2, its out_v, one row of
    its out_u, S and Psi), and equal to it elsewhere."""
    u, v, mat, w, lam = _card_inputs(cuda, 2, 200, 133, r, seed=9)
    u[0, 17] = float("nan")
    mat[1, 5, 7] = float("nan")
    got, want = _kernel_and_plain(fn, mode, u, v, mat, w, lam)
    torch.cuda.synchronize()
    assert any(t.isnan().any() for t in want)
    _assert_close_nan(got, want)


# ---------------------------------------------------------------------------
# Batched solves and the wire consensus on the card
# ---------------------------------------------------------------------------
BATCH_SHAPE = (3, 64, 62, 3, 4)  # B, m, n (ragged over E), rank, E


def _batch_problems(cuda, observed=1.0, seed=0):
    from repro_torch.core import problems as prob

    b, m, n, r, _ = BATCH_SHAPE
    return [prob.generate_problem(seed + i, m, n, r, 0.05,
                                  observed_frac=observed, device=cuda)
            for i in range(b)]


def _batch_solve(cuda, problems, cfg, method="dcf", key=0, mask=False):
    from repro_torch import rpca

    m = torch.stack([p.m_obs for p in problems])
    w = torch.stack([p.mask for p in problems]) if mask else None
    kw = {"num_clients": BATCH_SHAPE[-1]} if method == "dcf" else {}
    return rpca.solve(m, method=method, cfg=cfg, mask=w, key=key,
                      device=cuda, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["none", "dense", "packed"])
@pytest.mark.parametrize("fused", ["diag", "dual", "off"])
def test_dcf_batch_matches_serial_on_the_card(cuda, fused, mode):
    """A ragged dcf batch on the kernel route, every fused mode and mask
    mode, against the card's serial solves (problem b from seed b): L and
    S within the reference's batch tolerance (1e-3)."""
    from repro_torch import rpca
    from repro_torch.core.factorized import DCFConfig

    masked = mode != "none"
    problems = _batch_problems(cuda, 0.8 if masked else 1.0)
    cfg = DCFConfig.masked(BATCH_SHAPE[3], 0.8, outer_iters=20, fused=fused,
                           pack_mask=mode == "packed")
    bat = _batch_solve(cuda, problems, cfg, mask=masked)
    for b, p in enumerate(problems):
        one = rpca.solve(p.m_obs, method="dcf", cfg=cfg, key=b,
                         mask=p.mask if masked else None,
                         num_clients=BATCH_SHAPE[-1], device=cuda)
        for x, y in ((bat.l[b], one.l), (bat.s[b], one.s)):
            assert (x - y).abs().max().item() <= 1e-3


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["cf", "apgm", "ialm"])
def test_other_batches_match_serial_on_the_card(cuda, method):
    """cf (the batch is the kernels' leading axis), APGM and IALM (one
    batched SVD an iteration) against the card's serial solves: 1e-3 for
    cf, 1e-5 relative for the convex solvers."""
    from repro_torch import rpca
    from repro_torch.core import APGMConfig, IALMConfig
    from repro_torch.core.factorized import DCFConfig

    problems = _batch_problems(cuda)
    cfg = {"cf": DCFConfig.tuned(BATCH_SHAPE[3], outer_iters=20),
           "apgm": APGMConfig(iters=40), "ialm": IALMConfig(iters=30)}[method]
    bat = _batch_solve(cuda, problems, cfg, method=method)
    for b, p in enumerate(problems):
        one = rpca.solve(p.m_obs, method=method, cfg=cfg, key=b, device=cuda)
        for x, y in ((bat.l[b], one.l), (bat.s[b], one.s)):
            if method == "cf":
                assert (x - y).abs().max().item() <= 1e-3
            else:
                assert (torch.linalg.norm(x - y)
                        / torch.linalg.norm(y)).item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("fused", ["diag", "dual"])
def test_batch_mates_leave_a_problems_bits_on_the_card(cuda, fused):
    """Problem 0's L, S, U, V and traces, bit for bit, whoever its
    batch-mates are (the splits depend on the batch's shape only)."""
    from repro_torch.core.factorized import DCFConfig

    cfg = DCFConfig.masked(BATCH_SHAPE[3], 0.8, outer_iters=15, fused=fused,
                           pack_mask=True)
    a_probs = _batch_problems(cuda, 0.8)
    b_probs = a_probs[:1] + _batch_problems(cuda, 0.6, seed=50)[1:]
    a = _batch_solve(cuda, a_probs, cfg, mask=True)
    b = _batch_solve(cuda, b_probs, cfg, mask=True)
    for x, y in ((a.l, b.l), (a.s, b.s), (a.u, b.u), (a.v, b.v),
                 (a.stats.residual, b.stats.residual)):
        assert torch.equal(x[0], y[0])
    assert not torch.equal(a.l[1], b.l[1])


@pytest.mark.gpu
@pytest.mark.parametrize("pair", ["ones_mask", "packed", "off"])
def test_bit_exact_pairs_hold_in_a_card_batch(cuda, pair):
    """Inside a batch on the card: an all-ones mask gives the bits of no
    mask, a packed mask those of the dense one, fused="off" those of
    "diag"."""
    import dataclasses

    from repro_torch.core.factorized import DCFConfig

    problems = _batch_problems(cuda, 0.8)
    cfg = DCFConfig.tuned(BATCH_SHAPE[3], outer_iters=10)
    if pair == "ones_mask":
        ones = [dataclasses.replace(p, mask=torch.ones_like(p.m_obs))
                for p in problems]
        a = _batch_solve(cuda, problems, cfg)
        b = _batch_solve(cuda, ones, cfg, mask=True)
    elif pair == "packed":
        a = _batch_solve(cuda, problems, cfg, mask=True)
        b = _batch_solve(cuda, problems,
                         dataclasses.replace(cfg, pack_mask=True), mask=True)
    else:
        a = _batch_solve(cuda, problems, cfg)
        b = _batch_solve(cuda, problems,
                         dataclasses.replace(cfg, fused="off"))
    assert torch.equal(a.l, b.l) and torch.equal(a.s, b.s)


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["dcf", "cf"])
def test_one_launch_per_sweep_for_the_batch(cuda, method):
    """A batch of B problems launches each kernel once a sweep for all of
    them: T·K·J / T·K / 1, as one serial solve."""
    from repro_torch.core.factorized import DCFConfig

    cfg = DCFConfig.tuned(BATCH_SHAPE[3], outer_iters=7)
    suffix = "_masked" if method == "dcf" else ""  # n = 62 is ragged
    problems = _batch_problems(cuda)
    ops.reset_launch_counts()
    _batch_solve(cuda, problems, cfg, method=method)
    local = cfg.outer_iters * cfg.local_iters
    want = {f"huber_contract_v{suffix}": local * cfg.inner_sweeps,
            f"huber_contract_u_diag{suffix}": local,
            f"residual_shrink{suffix}": 1}
    counts = ops.launch_counts()
    assert counts == {k: want.get(k, 0) for k in counts}


@pytest.mark.gpu
def test_wire_reconstruction_is_deterministic_without_atomics(cuda):
    """The top-k payloads of E clients scattered into one row each and
    summed in a fixed order: the same bits on every run and under
    PyTorch's deterministic mode (which warns about none of its
    operations), and the scatter-add sum of the reference within fp32
    rounding."""
    import warnings

    from repro_torch.distributed import grad_compress as gc

    g = torch.Generator(device=cuda).manual_seed(0)
    flat = torch.randn(10, 450_000, device=cuda, generator=g)
    k = 45_000

    def wire():
        vals, idx = gc.topk_sparsify(flat, k)
        return gc.topk_reconstruct(vals, idx, flat.shape[1]).sum(0)

    first = wire()
    assert all(torch.equal(first, wire()) for _ in range(5))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            again = wire()
        finally:
            torch.use_deterministic_algorithms(False)
    assert not [w for w in caught if "determinis" in str(w.message)]
    assert torch.equal(first, again)
    vals, idx = gc.topk_sparsify(flat, k)
    added = torch.zeros(flat.shape[1], device=cuda).index_add_(
        0, idx.reshape(-1).long(), vals.reshape(-1))
    assert (added - first).abs().max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("fused", ["diag", "dual", "off"])
def test_stale_guard_trips_on_a_nan_scalar_on_the_card(cuda, fused):
    """A NaN in one client's block makes the guard scalar (the kernels'
    ||Psi||_F^2, or the delta's energy under "off") NaN: the stale wire
    falls back to synchronous rounds at once and stays there."""
    import importlib

    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    dcf = importlib.import_module("repro_torch.core.dcf_pca")
    p = prob.generate_problem(0, 64, 64, 3, 0.05, device=cuda)
    cfg = DCFConfig.tuned(3, outer_iters=3, consensus_delay=1, fused=fused)
    problem = dcf.make_problem(p.m_obs, cfg, 4, 0, device=cuda)
    problem.blocks[1, 7, 2] = float("nan")
    solver = dcf.make_solver(cfg)
    c = solver.init(problem)
    for t in range(3):
        c = solver.step(problem, c,
                        torch.tensor(t, dtype=torch.int32, device=cuda))
        assert bool(c["sync"]) and not torch.isfinite(c["guard"])


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["delay", "topk", "topk_delay_median"])
def test_wire_solves_on_the_card_match_the_cpu(cuda, wire):
    """The wire solver on the kernel route against the plain route on the
    CPU, from one seed (64^2, rank 3, E = 4, 40 rounds): U within 1e-4
    relative; and a wire batch against its serial solves on the card."""
    from repro_torch import rpca
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.distributed.grad_compress import CompressConfig

    kw = {"delay": dict(consensus_delay=1),
          "topk": dict(consensus_compress=CompressConfig(topk_frac=0.1)),
          "topk_delay_median": dict(
              consensus_delay=1, aggregator="coordinate_median",
              consensus_compress=CompressConfig(topk_frac=0.25))}[wire]
    cfg = DCFConfig.tuned(4, outer_iters=40, **kw)
    p = prob.generate_problem(0, 64, 64, 3, 0.05, device="cpu")
    cpu = rpca.solve(p.m_obs, method="dcf", cfg=cfg, num_clients=4, key=1,
                     device="cpu")
    card = rpca.solve(p.m_obs.to(cuda), method="dcf", cfg=cfg,
                      num_clients=4, key=1, device=cuda)
    assert (torch.linalg.norm(card.u.cpu() - cpu.u)
            / torch.linalg.norm(cpu.u)).item() <= 1e-4
    problems = _batch_problems(cuda)
    bat = _batch_solve(cuda, problems, cfg)
    for b, q in enumerate(problems):
        one = rpca.solve(q.m_obs, method="dcf", cfg=cfg, key=b,
                         num_clients=BATCH_SHAPE[-1], device=cuda)
        assert (bat.l[b] - one.l).abs().max().item() <= 1e-3


# ---------------------------------------------------------------------------
# One captured round a solve, one captured step a decode
# ---------------------------------------------------------------------------
GRAPH_SHAPE = (192, 160, 8, 4, 12)  # m, n, rank, E, rounds


def _graph_case(cuda, case):
    """``(module, problem, cfg)`` of a small solve on the card: cf, dcf,
    off, dual (dense mask), compact (bf16 M, packed mask, lam_sample),
    ragged (n % E != 0), wire (top-k with error feedback, one-round
    stale), faulted (NaN clients and dropouts under the median)."""
    import importlib

    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.distributed.faults import FaultPlan
    from repro_torch.distributed.grad_compress import CompressConfig

    m, n, r, e, t = GRAPH_SHAPE
    masked = case in ("dual", "compact")
    p = prob.generate_problem(0, m, n - (case == "ragged"), r, 0.05,
                              observed_frac=0.8 if masked else 1.0,
                              device=cuda)
    kw = {"dual": dict(fused="dual"),
          "compact": dict(fused="dual", pack_mask=True, lam_sample=4096),
          "off": dict(fused="off"),
          "wire": dict(consensus_delay=1,
                       consensus_compress=CompressConfig(topk_frac=0.1)),
          "faulted": dict(aggregator="coordinate_median")}.get(case, {})
    cfg = DCFConfig.tuned(r, outer_iters=t, track_objective=True, **kw)
    if case == "cf":
        mod = importlib.import_module("repro_torch.core.cf_pca")
        return mod, mod.make_problem(p.m_obs, cfg, 0, device=cuda), cfg
    mod = importlib.import_module("repro_torch.core.dcf_pca")
    m_obs = p.m_obs.to(torch.bfloat16) if case == "compact" else p.m_obs
    extra = {}
    if case == "faulted":
        extra = dict(faults=FaultPlan.byzantine(t, e, (1,), kind="nan"),
                     participation=0.75)
    problem = mod.make_problem(m_obs, cfg, e, 0,
                               mask=p.mask if masked else None,
                               device=cuda, **extra)
    return mod, problem, cfg


def _solve_counted(solver, problem, rounds, run_cfg=None, eager=False,
                   batch=False):
    """One run through the runtime with the launch counts zeroed before:
    ``(finalize output, stats, counts, graph counts)``."""
    from repro_torch.core import runtime as rt

    run_cfg = run_cfg or rt.FIXED
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    if batch:
        out, _, stats = rt.solve_batch(solver, problem, rounds, run_cfg,
                                       eager=eager)
    else:
        carry, stats = rt.run(solver, problem, rounds, run_cfg, eager=eager)
        out = solver.finalize(problem, carry)
    torch.cuda.synchronize()
    return out, stats, ops.launch_counts(), dict(rt.graph_counts)


def _assert_same_bits(a, b):
    for x, y in zip(a, b, strict=True):
        assert torch.equal(x, y)


GRAPH_CASES = ["cf", "dcf", "off", "dual", "compact", "ragged", "wire",
               "faulted"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GRAPH_CASES)
def test_replayed_round_gives_the_eager_bits(cuda, case):
    """Each flavour's solve replays one captured round: L, S, U, V and the
    traces bit for bit as the eager rounds, the same launch counts
    (T·K·J / T·K / 1, added at each replay), one capture and T - 1
    replays."""
    mod, problem, cfg = _graph_case(cuda, case)
    solver = mod.make_solver(cfg)
    t = cfg.outer_iters
    want, wstats, wcounts, wgraphs = _solve_counted(solver, problem, t,
                                                    eager=True)
    got, gstats, gcounts, graphs = _solve_counted(solver, problem, t)
    _assert_same_bits(got, want)
    _assert_same_bits(gstats, wstats)
    assert gcounts == wcounts
    local = t * cfg.local_iters
    sweeps = local * (cfg.inner_sweeps - (cfg.fused == "dual"))
    assert sum(v for k, v in gcounts.items()
               if k.startswith("huber_contract_v")) == sweeps
    assert wgraphs["captures"] == 0 and wgraphs["replays"] == 0
    assert graphs["captures"] == 1 and graphs["replays"] == t - 1


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["chunk", "while", "scan"])
def test_replayed_batch_gives_the_eager_bits(cuda, mode):
    """A ragged dcf batch under the early-exit modes: the done mask and the
    freeze replay inside the graph, the host reads all(done) once a chunk
    (or round); outputs, traces, rounds and flags bit for bit as eagerly,
    launch counts equal."""
    import importlib

    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig

    dcf = importlib.import_module("repro_torch.core.dcf_pca")
    problems = _batch_problems(cuda)
    cfg = DCFConfig.tuned(BATCH_SHAPE[3], outer_iters=40)
    batch = dcf.make_batch(torch.stack([p.m_obs for p in problems]), cfg,
                           BATCH_SHAPE[-1], 0, device=cuda)
    run_cfg = rt.RunConfig(mode=mode, tol=1e-3, chunk_size=4)
    solver = dcf.make_solver(cfg)
    want, wstats, wcounts, _ = _solve_counted(solver, batch, 40, run_cfg,
                                              eager=True, batch=True)
    got, gstats, gcounts, graphs = _solve_counted(solver, batch, 40,
                                                  run_cfg, batch=True)
    _assert_same_bits(got, want)
    _assert_same_bits(gstats, wstats)
    assert gcounts == wcounts and graphs["captures"] == 1
    if mode != "scan":
        assert int(gstats.rounds.max()) < 40


@pytest.mark.gpu
def test_resumed_segmented_solve_replays_the_uninterrupted_bits(cuda,
                                                                tmp_path):
    """A checkpointed solve, interrupted after its first snapshot and
    resumed, replays its captured round between the snapshots: the bits
    of one eager unsegmented solve."""
    from repro_torch.core import runtime as rt

    mod, problem, cfg = _graph_case(cuda, "faulted")
    solver = mod.make_solver(cfg)
    t = cfg.outer_iters
    want, wstats, _, _ = _solve_counted(solver, problem, t, eager=True)

    class Interrupt(Exception):
        pass

    def stop(step, carry):
        raise Interrupt

    run_cfg = rt.RunConfig(checkpoint_every=5)
    with pytest.raises(Interrupt):
        rt.run_segmented(solver, problem, t, run_cfg,
                         checkpoint_dir=str(tmp_path), save_extra=stop)
    rt.reset_graph_counts()
    carry, stats = rt.run_segmented(solver, problem, t, run_cfg,
                                    checkpoint_dir=str(tmp_path),
                                    resume_from=str(tmp_path))
    _assert_same_bits(solver.finalize(problem, carry), want)
    _assert_same_bits(stats, wstats)
    assert rt.graph_counts["captures"] == 1
    assert rt.graph_counts["replays"] == t - 5 - 1


@pytest.mark.gpu
def test_a_capture_that_fails_raises(cuda):
    """A solver marked capturable whose round reads the card from the host
    fails its capture, and the run raises: nothing falls back to eager
    rounds.  (In a child process: a failed capture may leave the CUDA
    context unusable for the tests after it.)"""
    import os
    import subprocess
    import sys

    code = (
        "import torch\n"
        "from repro_torch.core import runtime as rt\n"
        "x = torch.ones(4, device='cuda')\n"
        "def step(p, c, t):\n"
        "    return c * 2 if bool(c.sum() > 0) else c\n"
        "s = rt.Solver(lambda p: p[0], step,\n"
        "              lambda p, c: rt.Diag(c.sum(), c.sum()),\n"
        "              lambda p, c: c, capturable=True)\n"
        "try:\n"
        "    rt.run(s, (x,), 4)\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, rt.graph_counts['replays'])\n"
        "else:\n"
        "    print('ran')\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(os.path.dirname(__file__), "..", "src"),
         env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.startswith("raised"), (out.stdout, out.stderr)
    assert out.stdout.split()[-1] == "0"


def _padded_eager(method, cfg, m_obs, mask, policy, device):
    """``(l, s)`` of the compile cache's padded problem for this spec,
    solved by ``runtime.run`` eagerly (no cache, no graph), finalized and
    trimmed: what a cached solve must give bit for bit."""
    from repro_torch import rpca
    from repro_torch.core import compile_cache as cc
    from repro_torch.core import runtime as rt

    entry = rpca.get_solver(method)
    spec = rpca.RPCASpec(m_obs, mask=mask)
    cfg = entry.aot.resolve_cfg(cfg, spec)
    m, n = spec.shape
    mb, nb = cc.bucket_shape(m, n, policy)
    solver, iters, make_problem = entry.aot.program(cfg, rt.FIXED)
    problem = make_problem(*cc._admit(entry.aot, spec, cfg, m, n, mb, nb,
                                      device))
    carry, _ = rt.run(solver, problem, iters, rt.FIXED, eager=True)
    l, s = solver.finalize(problem, carry)[:2]
    return l[:m, :n], s[:m, :n]


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["cf", "ialm"])
def test_repeat_bucket_builds_and_captures_nothing(cuda, method):
    """Three shapes in one bucket through compile_policy: one entry build
    (with one capture for cf; IALM's entry runs eagerly), then hits that
    build and capture nothing, each result the shape of its spec and bit
    for bit the eager solve of the same padded problem without the cache
    (a replay that kept anything of an earlier admission would differ),
    and a repeated admission bit for bit the first."""
    from repro_torch import rpca
    from repro_torch.core import compile_cache as cc
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.core.ialm import IALMConfig

    cache = cc.default_cache()
    cache.clear()
    policy = cc.CompilePolicy(bucket_min=32)
    cfg = (DCFConfig.tuned(4, outer_iters=10) if method == "cf"
           else IALMConfig(iters=10))
    p = prob.generate_problem(0, 48, 40, 4, 0.1, observed_frac=0.8,
                              device=cuda)
    rt.reset_graph_counts()
    before = cache.stats.snapshot()
    kw = dict(method=method, cfg=cfg, compile_policy=policy, device=cuda)
    first = rpca.solve(p.m_obs, mask=p.mask, **kw)
    assert first.cache_stats.compiles == before.compiles + 1
    assert rt.graph_counts["captures"] == (method == "cf")
    nbytes = cache.nbytes
    assert nbytes > 0
    for mt, nt in [(45, 37), (40, 33)]:
        res = rpca.solve(p.m_obs[:mt, :nt], mask=p.mask[:mt, :nt], **kw)
        assert res.l.shape == (mt, nt) and res.s.shape == (mt, nt)
        assert res.cache_stats.compiles == before.compiles + 1
        l, s = _padded_eager(method, cfg, p.m_obs[:mt, :nt],
                             p.mask[:mt, :nt], policy, cuda)
        assert torch.equal(res.l, l) and torch.equal(res.s, s)
    again = rpca.solve(p.m_obs, mask=p.mask, **kw)
    assert rt.graph_counts["captures"] == (method == "cf")
    assert again.cache_stats.hits == before.hits + 3
    assert torch.equal(again.l, first.l) and torch.equal(again.s, first.s)
    assert cache.nbytes == nbytes


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 0.8], ids=["greedy", "temp"])
def test_replayed_decode_gives_the_eager_tokens(cuda, temperature):
    """The llama3-8b smoke config (fp32, flash prefill): the replayed
    decode step gives the eager tokens, greedy and by temperature from one
    seeded card generator; one capture and max_new_tokens - 2 replays."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import runtime as rt
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeConfig, generate

    cfg = get_smoke_config("llama3-8b").replace(
        param_dtype="float32", compute_dtype="float32",
        flash_attention=True)
    model = get_model(cfg)
    params = model.init_params(seed=0, device=cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 33), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    scfg = ServeConfig(max_new_tokens=9, temperature=temperature)

    def tokens(eager):
        gen = torch.Generator(device=cuda).manual_seed(7)
        return generate(model, params, prompt, scfg, generator=gen,
                        eager=eager)

    want = tokens(True)
    rt.reset_graph_counts()
    got = tokens(False)
    assert torch.equal(got, want)
    assert got.dtype == want.dtype == torch.int32
    assert rt.graph_counts["captures"] == 1
    assert rt.graph_counts["replays"] == scfg.max_new_tokens - 2


# ---------------------------------------------------------------------------
# The slot service and the gateway on the card
# ---------------------------------------------------------------------------
SVC_M, SVC_N, SVC_R = 48, 40, 3


def _tenant(n_cols, seed, poison=False):
    g = torch.Generator().manual_seed(seed)
    low = torch.randn(SVC_M, SVC_R, generator=g) @ torch.randn(
        SVC_R, n_cols, generator=g)
    out = low + (torch.rand(SVC_M, n_cols, generator=g) < 0.05) * 3.0
    if poison:
        out[3, 5] = float("nan")
    return out.numpy()


def _service(cuda, eager=False, key=0, slots=3, **kw):
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.core.ialm import IALMConfig
    from repro_torch.serving import RPCAService, RPCAServiceConfig

    scfg = RPCAServiceConfig(slots=slots, rounds_per_tick=8, max_rounds=96,
                             **kw)
    return RPCAService(SVC_M, SVC_N, DCFConfig.tuned(SVC_R), scfg, key=key,
                       cfgs={"ialm": IALMConfig()}, device=cuda, eager=eager)


def _tick_until(svc, slots):
    out = {}
    for _ in range(64):
        svc.tick()
        for s in slots:
            if s not in out:
                r = svc.poll(s)
                if r is not None:
                    out[s] = r
        if len(out) == len(slots):
            return out
    raise AssertionError("the service did not finish")


def _same_response(a, b):
    assert a.method == b.method and a.rounds == b.rounds
    assert a.converged == b.converged and a.diverged == b.diverged
    for name in ("l", "s", "u", "v"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None and y is None) or torch.equal(x, y), name


@pytest.mark.gpu
def test_replayed_service_ticks_give_the_eager_bits(cuda):
    """A cf lane's replayed ticks (one captured slot-table round) against
    eager ticks, through continuous refill with a ragged, a masked and an
    ialm tenant: every response bit for bit."""
    mats = [_tenant(SVC_N, 0), _tenant(30, 1), _tenant(SVC_N, 2),
            _tenant(SVC_N, 3), _tenant(SVC_N, 4)]
    mask = (torch.rand(SVC_M, SVC_N, generator=torch.Generator()
                       .manual_seed(6)) < 0.8).float().numpy()
    runs = [_service(cuda, eager=eager).solve_all(
        mats, masks={2: mask}, methods={3: "ialm"}) for eager in (True,
                                                                  False)]
    for a, b in zip(*runs, strict=True):
        _same_response(a, b)


@pytest.mark.gpu
def test_a_tick_is_rounds_per_tick_replays_with_exact_counts(cuda):
    """One capture when the lane is built (its warm-up round moves no
    slot), then each tick replays the round rounds_per_tick times and adds
    one round's launches each time: J·K masked contract_v and K masked
    u_diag launches a round; one masked shrink a poll."""
    from repro_torch.core import compile_cache as cc
    from repro_torch.core import runtime as rt

    cc.default_cache().clear()
    rt.reset_graph_counts()
    svc = _service(cuda)
    assert rt.graph_counts["captures"] == 1
    for seed in range(2):
        svc.try_submit(_tenant(SVC_N, seed))
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    svc.tick()
    torch.cuda.synchronize()
    cfg = svc.cfg
    assert rt.graph_counts["captures"] == 0
    assert rt.graph_counts["replays"] == 8
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    per_round = cfg.local_iters
    assert counts == {
        "huber_contract_v_masked": 8 * per_round * cfg.inner_sweeps,
        "huber_contract_u_diag_masked": 8 * per_round}
    ops.reset_launch_counts()
    out = _tick_until(svc, [0, 1])
    assert ops.launch_counts()["residual_shrink_masked"] == len(out)


@pytest.mark.gpu
def test_a_second_service_of_one_geometry_captures_nothing(cuda):
    """Two services of one geometry share the tick's captured round:
    the second captures nothing, and ticking the two in turn (each tick
    hands the static buffers to its lane) gives each the bits it gives
    alone."""
    from repro_torch.core import runtime as rt

    alone = []
    for key in (0, 5):
        svc = _service(cuda, key=key)
        slots = [svc.try_submit(_tenant(SVC_N, key + i)) for i in range(2)]
        alone.append(_tick_until(svc, slots))
    rt.reset_graph_counts()
    a, b = _service(cuda, key=0), _service(cuda, key=5)
    for svc, key in ((a, 0), (b, 5)):
        for i in range(2):
            svc.try_submit(_tenant(SVC_N, key + i))
    got = [{}, {}]
    for _ in range(64):
        for svc, out in zip((a, b), got):
            svc.tick()
            for s in (0, 1):
                if s not in out:
                    r = svc.poll(s)
                    if r is not None:
                        out[s] = r
        if all(len(o) == 2 for o in got):
            break
    assert rt.graph_counts["captures"] == 0
    for out, want in zip(got, alone):
        for s in (0, 1):
            _same_response(out[s], want[s])


@pytest.mark.gpu
def test_a_quarantined_slots_neighbour_is_a_solo_run_on_the_card(cuda):
    """A NaN tenant beside a healthy one: quarantined (diverged, not
    converged), and the neighbour's bits those of a solo run (the
    kernels' splits depend on the slot count, not on the neighbours'
    data)."""
    solo = _service(cuda, key=21, slots=4)
    want = _tick_until(solo, [solo.try_submit(_tenant(SVC_N, 0))])[0]
    svc = _service(cuda, key=21, slots=4)
    good = svc.try_submit(_tenant(SVC_N, 0))
    bad = svc.try_submit(_tenant(SVC_N, 1, poison=True))
    out = _tick_until(svc, [good, bad])
    assert out[bad].diverged and not out[bad].converged
    assert svc.metrics()["diverged"] == 1
    _same_response(out[good], want)


@pytest.mark.gpu
def test_polled_results_survive_the_next_admission_on_the_card(cuda):
    """A response's tensors are not views of the lane's static buffers:
    the next admission into its slot and a tick leave them unchanged."""
    svc = _service(cuda, slots=1)
    first = _tick_until(svc, [svc.try_submit(_tenant(SVC_N, 0))])[0]
    kept = [x.clone() for x in (first.l, first.s, first.u, first.v)]
    svc.release(0)
    svc.try_submit(_tenant(SVC_N, 1))
    svc.tick()
    torch.cuda.synchronize()
    for x, y in zip((first.l, first.s, first.u, first.v), kept):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_single_page_gateway_is_the_service_on_the_card(cuda):
    """page_cols = n: the gateway's one full-width lane gives the
    service's bits (same key, same admission order, same planes)."""
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.serving import GatewayConfig, RPCAGateway

    mats = [_tenant(SVC_N, 1), _tenant(30, 2), _tenant(SVC_N, 3)]
    direct = _service(cuda, key=7, slots=4).solve_all(list(mats))
    gw = RPCAGateway(SVC_M, SVC_N, DCFConfig.tuned(SVC_R),
                     GatewayConfig(slots=4, rounds_per_tick=8, max_rounds=96),
                     key=7, device=cuda)
    via = gw.solve_all(list(mats))
    for d, g in zip(direct, via, strict=True):
        _same_response(g, d)


# ---------------------------------------------------------------------------
# The sharded engine on the card: one rank a process
# ---------------------------------------------------------------------------
_SHARDED_CARD = """
import hashlib, json
import torch
import torch.distributed as dist
from repro_torch import rpca
from repro_torch.core import metrics
from repro_torch.core import problems as prob
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
p = prob.generate_problem(0, 500, 500, 8, 0.05, device=dev)
mesh = _mh.multihost_mesh(device=dev)
ops.reset_launch_counts()
rt.reset_graph_counts()
res = rpca.solve(rpca.RPCASpec(p.m_obs, mesh=mesh), method="dcf_sharded",
                 cfg=DCFConfig.tuned(8), device=dev)
torch.cuda.synchronize()
print("CARD " + json.dumps(dict(
    backend=str(dist.get_backend()),
    err=metrics.relative_error(res.l, res.s, p.l0, p.s0).item(),
    u=hashlib.sha256(res.u.cpu().numpy().tobytes()).hexdigest(),
    launches={k: c for k, c in ops.launch_counts().items() if c},
    captures=int(rt.graph_counts["captures"]),
    replays=int(rt.graph_counts["replays"]), shape=list(res.l.shape))))
"""
#: A rank's launches in a solve of tuned(8): J K T, K T and one shrink.
_SHARDED_WANT = {"huber_contract_v": 600, "huber_contract_u_diag": 200,
                 "residual_shrink": 1}


def _card_cohort(ranks: int, backend: str) -> list[dict]:
    """A cohort of ``ranks`` processes on the card solving 500 x 500 (rank
    8, 5%) through ``rpca.solve(method="dcf_sharded")``; each rank's row.
    The kernels are built here first, so the workers load one library."""
    from repro_torch.distributed import multihost as mh
    from repro_torch.kernels import _build

    _build.build_all()
    outs = mh.launch_workers(_SHARDED_CARD, num_processes=ranks,
                             backend=backend, timeout=600)
    return [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("CARD "))[len("CARD "):])
            for out in outs]


@pytest.mark.gpu
def test_two_gloo_ranks_share_the_card(cuda):
    """Two gloo ranks on the one card (CUDA tensors staged through the
    host): the same U bytes on both, each rank's exact launch counts on
    its 500 x 250 block, the Fig. 1 bar, and eager rounds (gloo runs its
    collectives on the host, so a round is not captured)."""
    rows = _card_cohort(2, "gloo")
    assert len({r["u"] for r in rows}) == 1
    for r in rows:
        assert r["backend"] == "gloo" and r["launches"] == _SHARDED_WANT
        assert r["err"] < 1e-4 and r["shape"] == [500, 500]
        assert r["captures"] == 0 and r["replays"] == 0


@pytest.mark.gpu
def test_one_nccl_rank_replays_its_captured_round(cuda):
    """One NCCL rank (world size 1): the round, its all-reduce included,
    is captured once and replayed T - 1 times, with exact launch counts
    and the Fig. 1 bar."""
    (r,) = _card_cohort(1, "nccl")
    assert r["backend"] == "nccl" and r["launches"] == _SHARDED_WANT
    assert r["err"] < 1e-4
    assert r["captures"] == 1 and r["replays"] == 99



# ---------------------------------------------------------------------------
# Dense-LM serving over a model axis: two gloo ranks on the card
# ---------------------------------------------------------------------------
_TP_CARD = """
import json
import torch
from repro_torch import configs
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeConfig, generate

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
cfg = configs.get_smoke_config("llama3-8b").replace(
    param_dtype="float32", compute_dtype="float32", flash_attention=True)
mesh = _mh.multihost_mesh(("data", "model"), (1, 2), device=dev)
rules = rules_for_mesh(mesh)
model = get_model(cfg)
params = model.init_params(0, dev, rules=rules)
prompt = torch.randint(0, cfg.vocab, (2, 16),
                       generator=torch.Generator().manual_seed(1)).to(dev)
ops.reset_launch_counts()
tokens, info = generate(model, params, prompt, ServeConfig(max_new_tokens=8),
                        rules=rules, return_info=True)
torch.cuda.synchronize()
print("CARD " + json.dumps(dict(
    tokens=tokens.cpu().tolist(), info=info,
    launches={k: c for k, c in ops.launch_counts().items() if c},
    wq=list(params.layers[0].mixer.wq.shape))))
"""


@pytest.mark.gpu
def test_two_gloo_ranks_serve_over_a_model_axis(cuda):
    """The smoke Llama in fp32 over a (1, 2) mesh, two gloo ranks sharing
    the card, each drawing the single-device weights and keeping its
    slices: every rank's greedy tokens are the single-device run's on the
    card, its flash kernel ran once a layer on half the heads, and the
    decode ran eagerly (gloo), saying so."""
    from repro_torch import configs
    from repro_torch.distributed import multihost as mh
    from repro_torch.kernels import _build
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeConfig, generate

    _build.build_all()
    cfg = configs.get_smoke_config("llama3-8b").replace(
        param_dtype="float32", compute_dtype="float32", flash_attention=True)
    model = get_model(cfg)
    params = model.init_params(0, cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    want = generate(model, params, prompt.to(cuda),
                    ServeConfig(max_new_tokens=8)).cpu().tolist()
    outs = mh.launch_workers(_TP_CARD, num_processes=2, backend="gloo",
                             timeout=600)
    rows = [json.loads(next(ln for ln in out.splitlines()
                            if ln.startswith("CARD "))[len("CARD "):])
            for out in outs]
    for r in rows:
        assert r["tokens"] == want
        assert r["launches"] == {"flash_attention": cfg.n_layers}
        assert r["wq"] == [cfg.d_model, cfg.n_heads * cfg.hd // 2]
        assert r["info"]["decode"] == "eager"
        assert "gloo" in r["info"]["why"]

# ---------------------------------------------------------------------------
# The SSM, hybrid, MLA, VLM and encoder-decoder families over a model axis
# ---------------------------------------------------------------------------
TP_FAMILY_ARCHS = ["mamba2-780m", "jamba-1.5-large-398b", "deepseek-v2-236b",
                   "llama-3.2-vision-11b", "whisper-small"]
_TP_FAMILY_CARD = """
import json, os
import torch
from repro_torch import configs
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeConfig, generate

torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
env = json.loads(os.environ["TP_FAMILY_ENV"])
rules = rules_for_mesh(_mh.multihost_mesh(("data", "model"), (1, 2),
                                          device=dev))
rank = _mh.MeshComm(rules.mesh, ("data",), "model").model_index
for arch in env["archs"]:
    cfg = configs.get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32", flash_attention=True)
    model = get_model(cfg)
    params = model.init_params(0, dev, rules=rules)
    inputs = torch.load(os.path.join(env["dir"], f"{arch}.pt"))
    with torch.no_grad():
        for layer in params.layers:
            if hasattr(layer, "gate"):
                layer.gate.fill_(0.5)
    prompt = inputs["prompt"].to(dev)
    ctx = None if inputs["ctx"] is None else inputs["ctx"].to(dev)
    s = prompt.shape[1]
    caches = model.init_cache(2, s + 4, dev, rules=rules)
    ops.reset_launch_counts()
    logits, _ = model.prefill(params, prompt, caches, ctx=ctx, rules=rules)
    launches = {k: c for k, c in ops.launch_counts().items() if c}
    steps = [model.decode_step(params, inputs["decode"][:, i:i + 1].to(dev),
                               caches, s + i, rules=rules)[0]
             for i in range(3)]
    tokens, info = generate(model, params, prompt,
                            ServeConfig(max_new_tokens=6), ctx=ctx,
                            rules=rules, return_info=True)
    torch.save(dict(logits=logits.cpu(), steps=torch.stack(steps).cpu(),
                    tokens=tokens.cpu(), info=info, launches=launches),
               os.path.join(env["dir"], f"{arch}-{rank}.pt"))
"""


@pytest.fixture(scope="module")
def tp_families(tmp_path_factory):
    """{arch: (one rank's run on the card, [rank 0's, rank 1's])}: each
    family's smoke config in fp32, the ranks one cohort of 2 gloo ranks
    sharing the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from repro_torch import configs
    from repro_torch.distributed import multihost as mh
    from repro_torch.kernels import _build
    from repro_torch.models import CONTEXT_FAMILIES, get_model
    from repro_torch.models.lm import ctx_len
    from repro_torch.serving.engine import ServeConfig, generate

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    tmp = tmp_path_factory.mktemp("tp_families")
    ones = {}
    for arch in TP_FAMILY_ARCHS:
        cfg = configs.get_smoke_config(arch).replace(
            param_dtype="float32", compute_dtype="float32",
            flash_attention=True)
        gen = torch.Generator().manual_seed(1)
        inputs = dict(
            prompt=torch.randint(0, cfg.vocab, (2, 24), generator=gen),
            decode=torch.randint(0, cfg.vocab, (2, 3), generator=gen),
            ctx=torch.randn(2, ctx_len(cfg), cfg.d_model, generator=gen)
            if cfg.family in CONTEXT_FAMILIES else None)
        torch.save(inputs, tmp / f"{arch}.pt")
        model = get_model(cfg)
        params = model.init_params(0, dev)
        with torch.no_grad():
            for layer in params.layers:
                if hasattr(layer, "gate"):
                    layer.gate.fill_(0.5)
        prompt = inputs["prompt"].to(dev)
        ctx = None if inputs["ctx"] is None else inputs["ctx"].to(dev)
        caches = model.init_cache(2, 28, dev)
        logits, _ = model.prefill(params, prompt, caches, ctx=ctx)
        steps = [model.decode_step(params, inputs["decode"][:, i:i + 1].to(
            dev), caches, 24 + i)[0] for i in range(3)]
        tokens = generate(model, params, prompt, ServeConfig(max_new_tokens=6),
                          ctx=ctx)
        ones[arch] = dict(logits=logits.cpu(), steps=torch.stack(steps).cpu(),
                          tokens=tokens.cpu(), cfg=cfg)
        del params, caches
    mh.launch_workers(_TP_FAMILY_CARD, num_processes=2, backend="gloo",
                      timeout=600, extra_env={"TP_FAMILY_ENV": json.dumps(
                          dict(dir=str(tmp), archs=TP_FAMILY_ARCHS))})
    return {arch: (ones[arch], [torch.load(tmp / f"{arch}-{r}.pt")
                                for r in range(2)])
            for arch in TP_FAMILY_ARCHS}


@pytest.mark.gpu
@pytest.mark.parametrize("arch", TP_FAMILY_ARCHS,
                         ids=["ssm", "hybrid", "mla", "vlm", "encdec"])
def test_family_model_axis_matches_one_rank(tp_families, arch):
    """Each family's smoke config in fp32 over a (1, 2) mesh, two gloo
    ranks sharing the card, each drawing one rank's weights and keeping
    its slices: the prefill's and 3 decode steps' logits within 1e-4 of
    one rank's on the card, the greedy tokens the same, one flash launch
    a self-attention layer in the prefill (none for the SSD mixer, MLA,
    cross-attention or the encoder), the decode eager (gloo)."""
    from repro_torch.models import get_model

    one, ranks = tp_families[arch]
    cfg = one["cfg"]
    want = sum(m == "attn" for m, _ in get_model(cfg).layer_plan())
    for r in ranks:
        for got, ref in ((r["logits"], one["logits"]),
                         (r["steps"], one["steps"])):
            assert torch.allclose(got, ref, rtol=1e-4, atol=1e-4), (
                (got - ref).abs().max())
        assert torch.equal(r["tokens"], one["tokens"])
        assert r["launches"] == ({"flash_attention": want} if want else {})
        assert r["info"]["decode"] == "eager" and "gloo" in r["info"]["why"]


#: Families served over 2 ranks with one device's bits, each cut in depth
#: (every width whole): (arch, config cut).
BITS_CUTS = [("mamba2-780m", {"n_layers": 4}), ("llama3-8b", {"n_layers": 2}),
             ("llama-3.2-vision-11b", {"n_layers": 5}),
             ("whisper-small", {"n_layers": 2})]
_BITS_CARD = """
import json, os
import torch
from repro_torch import configs
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.models import get_model

dev = torch.device("cuda")
env = json.loads(os.environ["BITS_ENV"])
rules = rules_for_mesh(_mh.multihost_mesh(("data", "model"), (1, 2),
                                          device=dev))
rank = _mh.MeshComm(rules.mesh, ("data",), "model").model_index
model = get_model(configs.get_config(env["arch"]).replace(**env["cut"]))
params = model.init_params(0, dev, rules=rules)
with torch.no_grad():
    for layer in params.layers:
        if hasattr(layer, "gate"):
            layer.gate.fill_(0.5)
inputs = torch.load(os.path.join(env["dir"], "inputs.pt"))
tokens = inputs["tokens"].to(dev)
ctx = None if inputs["ctx"] is None else inputs["ctx"].to(dev)
prompt, fed = tokens[:, :env["prompt"]], tokens[:, env["prompt"]:]
caches = model.init_cache(*tokens.shape, dev, rules=rules)
logits = [model.prefill(params, prompt, caches, ctx=ctx, rules=rules)[0]]
for i in range(fed.shape[1]):
    logits.append(model.decode_step(params, fed[:, i:i + 1], caches,
                                    env["prompt"] + i, rules=rules)[0])
torch.save(torch.stack(logits).cpu(),
           os.path.join(env["dir"], f"rank-{rank}.pt"))
"""


@pytest.mark.gpu
@pytest.mark.parametrize("arch,cut", BITS_CUTS,
                         ids=["ssm", "dense", "vlm", "encdec"])
def test_bf16_over_two_ranks_is_one_devices_bits(cuda, tmp_path, arch, cut):
    """A family at full width, cut in depth, in bf16 over a (1, 2) mesh,
    two gloo ranks sharing the card: the prefill's logits of a 300-token
    prompt (mamba2: two chunks, the second padded) and of 3 decode steps
    are one device's, bit for bit.  One device computes what the ranks
    split by the halves that they hold (``ssm._head_parts``,
    ``attention._halves``, the MLP's and the logits' halves): in bf16 any
    bit that differs grows, layer by layer, to the logits' whole bf16
    noise."""
    from repro_torch import configs
    from repro_torch.distributed import multihost as mh
    from repro_torch.models import CONTEXT_FAMILIES, get_model
    from repro_torch.models.lm import ctx_len

    prompt, steps = 300, 3
    model = get_model(configs.get_config(arch).replace(**cut))
    cfg = model.cfg
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, cfg.vocab, (2, prompt + steps), generator=gen)
    ctx = (torch.randn(2, ctx_len(cfg), cfg.d_model, generator=gen).to(
        cfg.cdtype) if cfg.family in CONTEXT_FAMILIES else None)
    torch.save(dict(tokens=tokens, ctx=ctx), tmp_path / "inputs.pt")
    params = model.init_params(0, cuda)
    with torch.no_grad():
        for layer in params.layers:
            if hasattr(layer, "gate"):
                layer.gate.fill_(0.5)
    caches = model.init_cache(*tokens.shape, cuda)
    on_card = tokens.to(cuda)
    card_ctx = None if ctx is None else ctx.to(cuda)
    want = [model.prefill(params, on_card[:, :prompt], caches,
                          ctx=card_ctx)[0]]
    for i in range(steps):
        want.append(model.decode_step(
            params, on_card[:, prompt + i:prompt + i + 1], caches,
            prompt + i)[0])
    want = torch.stack(want).cpu()
    del params, caches
    mh.launch_workers(_BITS_CARD, num_processes=2, backend="gloo",
                      timeout=600, extra_env={"BITS_ENV": json.dumps(
                          dict(dir=str(tmp_path), arch=arch, cut=cut,
                               prompt=prompt))})
    for rank in range(2):
        got = torch.load(tmp_path / f"rank-{rank}.pt")
        assert torch.equal(got, want), (got - want).abs().max()


# ---------------------------------------------------------------------------
# LM training: the train step, the robust aggregation, the probe
# ---------------------------------------------------------------------------
def _smoke_f32(**kw):
    from repro_torch.configs import get_smoke_config

    return get_smoke_config("tinyllama-1.1b").replace(
        param_dtype="float32", compute_dtype="float32", **kw)


def _one_train_step(cfg, params, batch, **ocfg):
    from repro_torch.models import get_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step

    step = make_train_step(get_model(cfg), opt.AdamWConfig(
        warmup_steps=1, total_steps=10, **ocfg))
    return step(params, opt.init(params), batch)


@pytest.mark.gpu
def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One fp32 step of the smoke LM on the card against the CPU from the
    same parameters and batch: the loss within 1e-5 relative, every
    parameter within 1e-5 of its max |p| (lr 1e-4, eps 1e-6: Adam divides
    each gradient entry's fp32 noise by |g| + eps)."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import get_model
    from repro_torch.training.data import SyntheticData

    cfg = _smoke_f32()
    cpu = get_model(cfg).init_params(0, "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    batch = SyntheticData(cfg, ShapeSpec("t", 32, 8, "train"),
                          device="cpu").batch_at(0)
    ocfg = dict(lr=1e-4, eps=1e-6)
    cpu, _, want = _one_train_step(cfg, cpu, batch, **ocfg)
    card, _, got = _one_train_step(
        cfg, card, {k: x.to(cuda) for k, x in batch.items()}, **ocfg)
    assert abs(float(got["loss"]) - float(want["loss"])) <= 1e-5 * abs(
        float(want["loss"]))
    for (name, a), b in zip(card.named_parameters(), cpu.parameters()):
        diff = (a.detach().cpu() - b.detach()).abs().max()
        assert float(diff) <= 1e-5 * float(b.detach().abs().max()), name


@pytest.mark.gpu
def test_training_never_launches_the_flash_kernel(cuda):
    """A train step with the config's flash attention on launches no
    kernel of the port (training takes the chunked attention); the flash
    wrapper refuses CUDA inputs that require grad with grad mode on."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import get_model
    from repro_torch.training.data import SyntheticData

    cfg = _smoke_f32(flash_attention=True)
    params = get_model(cfg).init_params(0, cuda)
    batch = SyntheticData(cfg, ShapeSpec("t", 32, 4, "train"),
                          device=cuda).batch_at(0)
    ops.reset_launch_counts()
    _one_train_step(cfg, params, batch)
    assert not any(ops.launch_counts().values())
    q = torch.randn(1, 64, 2, 32, device=cuda, requires_grad=True)
    k, v = torch.randn(1, 64, 2, 32, device=cuda), torch.randn(
        1, 64, 2, 32, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        fa.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == 1


class _OneRank:
    """A data group of one rank (no process group): the collectives are
    the identity, as over a group of one."""

    clients, client = 1, 0

    @staticmethod
    def all_reduce(x, over="data"):
        return x.clone()

    @staticmethod
    def all_gather(x, over="data"):
        return x[None].clone()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(256, 192), (192, 640)])
def test_robust_aggregation_kernels_match_the_plain_route(cuda, shape):
    """``consensus_compress`` of one gradient leaf through the card's
    kernels (``CompressConfig.dcf()``'s impl "auto") against the plain
    route on the CPU from the same sketch: within 1e-4 of max |out|, and
    exactly rounds x J huber_contract_v and rounds huber_contract_u_diag
    launches (K = 1)."""
    from repro_torch.distributed import grad_compress as gc

    g = torch.Generator().manual_seed(3)
    m, k = shape
    grad = torch.randn(m, 8, generator=g) @ torch.randn(8, k, generator=g)
    grad += 0.01 * torch.randn(m, k, generator=g)
    grad[torch.rand(m, k, generator=g) < 0.02] += 100.0
    omega = torch.randn(k, 8, generator=g)
    ccfg = gc.CompressConfig()
    want = gc.consensus_compress(grad, _OneRank, ccfg, omega=omega)
    ops.reset_launch_counts()
    got = gc.consensus_compress(grad.to(cuda), _OneRank, ccfg,
                                omega=omega.to(cuda)).cpu()
    counts = ops.launch_counts()
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())
    assert counts["huber_contract_v"] == ccfg.rounds * ccfg.inner_sweeps
    assert counts["huber_contract_u_diag"] == ccfg.rounds
    assert counts["residual_shrink"] == 0


@pytest.mark.gpu
def test_probe_launches_and_statistics_on_the_card(cuda):
    """``activation_probe`` on the card: exactly 6 T huber_contract_v, 2 T
    huber_contract_u_diag and one residual_shrink (tuned: K 2, J 3), and
    its statistics within 1e-3 of the CPU's from the same input and
    seed."""
    from repro_torch.training.probes import activation_probe

    g = torch.Generator().manual_seed(0)
    h = torch.randn(4, 64, 32, generator=g)
    u = torch.randn(32, 3, generator=g)
    h = h @ u @ u.T + torch.where(torch.rand(h.shape, generator=g) < 0.01,
                                  50.0, 0.0)
    want = activation_probe(h, rank=4, num_clients=4, outer_iters=30)
    ops.reset_launch_counts()
    got = activation_probe(h.to(cuda), rank=4, num_clients=4,
                           outer_iters=30)
    counts = ops.launch_counts()
    assert counts["huber_contract_v"] == 180
    assert counts["huber_contract_u_diag"] == 60
    assert counts["residual_shrink"] == 1
    for key in ("energy_low_rank", "energy_sparse", "outlier_fraction",
                "residual"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-3, key


# ---------------------------------------------------------------------------
# The SSM, MoE and hybrid families on the card
# ---------------------------------------------------------------------------
FAMILY_ARCHS = ["mamba2-780m", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS, ids=["ssm", "moe", "hybrid"])
def test_family_replayed_decode_gives_the_eager_tokens(cuda, arch):
    """Each family's smoke model in fp32 with flash prefill: the replayed
    decode step (routing, gathered experts and the SSM state updated in
    place, all inside the graph) gives the eager tokens; one capture and
    max_new_tokens - 2 replays; one flash launch per attention layer a
    prefill; the card's prefill logits within 1e-4 of max |logits| of the
    CPU's from the same weights."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import runtime as rt
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeConfig, generate

    cfg = get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32",
        flash_attention=True)
    model = get_model(cfg)
    cpu_params = model.init_params(seed=0, device="cpu")
    params = copy.deepcopy(cpu_params).to(cuda)
    prompt = torch.randint(0, cfg.vocab, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    scfg = ServeConfig(max_new_tokens=9)
    want = generate(model, params, prompt.to(cuda), scfg, eager=True)
    rt.reset_graph_counts()
    got = generate(model, params, prompt.to(cuda), scfg)
    assert torch.equal(got, want)
    assert rt.graph_counts["captures"] == 1
    assert rt.graph_counts["replays"] == scfg.max_new_tokens - 2
    before = fa.launches["flash_attention"]
    logits, _ = model.prefill(params, prompt.to(cuda))
    attention = sum(hasattr(layer.mixer, "wq") for layer in params.layers)
    assert fa.launches["flash_attention"] == before + attention
    cpu_logits, _ = model.prefill(cpu_params, prompt)
    rel = ((logits.cpu() - cpu_logits).abs().max()
           / cpu_logits.abs().max()).item()
    assert rel <= 1e-4, rel


@pytest.mark.gpu
@pytest.mark.parametrize("h", [16, 64], ids=["moe", "hybrid"])
def test_flash_bf16_at_the_families_prefill_shapes(cuda, h):
    """qwen2-moe-a2.7b's prefill (4, 2048, 16, 128) and the jamba cut's
    (4, 2048, 64, 128), causal, bf16: each query row within its bar."""
    q, k, v = _flash_inputs(cuda, 4, 2048, 2048, h, 128, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=True)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs().amax(dim=(2, 3))
    row_err = diff / want.abs().amax(dim=(2, 3))
    assert row_err.max().item() <= FLASH_TOL[torch.bfloat16]


@pytest.mark.gpu
def test_flash_bf16_at_the_moe_model_axis_shape(cuda):
    """qwen2-moe-a2.7b's prefill on one of 2 model ranks: 8 of its 16
    heads, (4, 2048, 8, 128), causal, bf16: each query row within its
    bar."""
    q, k, v = _flash_inputs(cuda, 4, 2048, 2048, 8, 128, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=True)
    torch.cuda.synchronize()
    diff = (got.float() - want).abs().amax(dim=(2, 3))
    row_err = diff / want.abs().amax(dim=(2, 3))
    assert row_err.max().item() <= FLASH_TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# The MLA, cross-attention and encoder-decoder families on the card
# ---------------------------------------------------------------------------
CONTEXT_ARCHS = ["deepseek-v2-236b", "llama-3.2-vision-11b", "whisper-small"]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", CONTEXT_ARCHS, ids=["mla", "vlm", "encdec"])
def test_context_family_replayed_decode_gives_the_eager_tokens(cuda, arch):
    """Each family's smoke model in fp32 with flash prefill (the VLM's
    gates at 0.5, a context where the family takes one): the card's
    prefill and decode logits within 1e-4 of max |logits| of the CPU's
    from the same weights; one flash launch per self-attention layer a
    prefill (none for MLA, the cross layers or the encoder); a decode step
    leaves the context K/V's bytes as the prefill wrote them; the replayed
    decode gives the eager tokens, with one capture and max_new_tokens - 2
    replays."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import runtime as rt
    from repro_torch.models import CONTEXT_FAMILIES, get_model
    from repro_torch.models.lm import ctx_len
    from repro_torch.serving.engine import ServeConfig, generate

    cfg = get_smoke_config(arch).replace(
        param_dtype="float32", compute_dtype="float32",
        flash_attention=True)
    model = get_model(cfg)
    cpu_params = model.init_params(seed=0, device="cpu")
    with torch.no_grad():
        for layer in cpu_params.layers:
            if hasattr(layer, "gate"):
                layer.gate.fill_(0.5)
    params = copy.deepcopy(cpu_params).to(cuda)
    g = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (2, 40), generator=g)
    ctx = (torch.randn(2, ctx_len(cfg), cfg.d_model, generator=g)
           if cfg.family in CONTEXT_FAMILIES else None)
    on_card = None if ctx is None else ctx.to(cuda)

    def rel(got, want):
        return ((got.cpu() - want).abs().max() / want.abs().max()).item()

    before = fa.launches["flash_attention"]
    caches = model.init_cache(2, 41, cuda)
    logits, _ = model.prefill(params, prompt.to(cuda), caches, ctx=on_card)
    self_layers = sum(hasattr(layer.mixer, "wq")
                      and not hasattr(layer, "gate")
                      for layer in params.layers)
    assert self_layers == {"moe": 0, "vlm": 2, "encdec": 2}[cfg.family]
    assert fa.launches["flash_attention"] == before + self_layers
    cpu_caches = model.init_cache(2, 41, "cpu")
    cpu_logits, _ = model.prefill(cpu_params, prompt, cpu_caches, ctx=ctx)
    assert rel(logits, cpu_logits) <= 1e-4

    def context_kv(cs):
        """Copies of the cross layers' context K/V (none for MLA)."""
        if cfg.family == "encdec":
            return [x.clone() for c in cs for x in c[2:]]
        return [x.clone() for c, layer in zip(cs, params.layers)
                if hasattr(layer, "gate") for x in c]

    kept = context_kv(caches)
    assert len(kept) == {"moe": 0, "vlm": 4, "encdec": 4}[cfg.family]
    tok = prompt[:, :1]
    step, _ = model.decode_step(params, tok.to(cuda), caches, 40)
    cpu_step, _ = model.decode_step(cpu_params, tok, cpu_caches, 40)
    assert rel(step, cpu_step) <= 1e-4
    assert all(torch.equal(a, b)
               for a, b in zip(kept, context_kv(caches), strict=True))

    scfg = ServeConfig(max_new_tokens=9)
    want = generate(model, params, prompt.to(cuda), scfg, eager=True,
                    ctx=on_card)
    rt.reset_graph_counts()
    got = generate(model, params, prompt.to(cuda), scfg, ctx=on_card)
    assert torch.equal(got, want)
    assert rt.graph_counts["captures"] == 1
    assert rt.graph_counts["replays"] == scfg.max_new_tokens - 2


@pytest.mark.gpu
def test_flash_bf16_at_the_whisper_decoder_shape(cuda):
    """whisper-small's decoder self-attention (4, 416, 12, 64), causal,
    bf16 (416 rows end in a part tile): each query row within its bar,
    and a rerun gives the same bits."""
    q, k, v = _flash_inputs(cuda, 4, 416, 416, 12, 64, torch.bfloat16)
    got = fa.flash_attention(q, k, v, causal=True)
    again = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=True)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    diff = (got.float() - want).abs().amax(dim=(2, 3))
    row_err = diff / want.abs().amax(dim=(2, 3))
    assert row_err.max().item() <= FLASH_TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# Graph kernel nodes, the sanitizer and the dry run (the tooling slice)
# ---------------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("case", ["cf", "dcf", "dual", "compact"])
def test_captured_round_kernel_nodes_match_its_counts(cuda, case):
    """A captured round's kernel nodes, read from the graph itself, by
    family equal what its capture counted (``CapturedRound.counts``), and
    the replays' node tally equals the counters' share; the instantiate
    time, now an explicit call after capture_end, is still nonzero."""
    from repro_torch.core import runtime as rt

    mod, problem, cfg = _graph_case(cuda, case)
    solver = mod.make_solver(cfg)
    state = rt.single_state(solver, problem, cfg.outer_iters)
    rt.reset_graph_counts()
    rounds = rt.Rounds(rt.single_body(solver, problem), state, cuda, True)
    rounds.advance(cfg.outer_iters)
    torch.cuda.synchronize()
    captured = rounds.captured
    counted = ops.family_launches(captured.counts["launches"])
    assert captured.kernel_nodes == counted
    assert sum(counted.values()) > 0
    replays = rt.graph_counts["replays"]
    assert replays == cfg.outer_iters - 1
    assert rt.replayed_kernels["nodes"] == {
        fam: n * replays for fam, n in counted.items()}
    assert rt.replayed_kernels["counted"] == rt.replayed_kernels["nodes"]
    assert rt.graph_counts["instantiate_s"] > 0


@pytest.mark.gpu
def test_strict_sanitizer_passes_a_scan_solve_and_stops_a_host_read(cuda):
    """Under strict sanitizing a scan-mode solve (one eager round, then
    replays; no host read while the rounds run) raises nothing and keeps
    the bits of an unsanitized solve, and a ``.item()`` planted in an
    eager round raises; ``disable`` restores the sync debug mode."""
    from repro_torch import debug
    from repro_torch.core import runtime as rt

    mod, problem, cfg = _graph_case(cuda, "dcf")
    solver = mod.make_solver(cfg)
    want, _ = rt.run(solver, problem, cfg.outer_iters)
    before = torch.cuda.get_sync_debug_mode()
    debug.enable("strict")
    try:
        got, _ = rt.run(solver, problem, cfg.outer_iters)

        def reading_step(p, c, t):
            float(c.u.sum().item())
            return solver.step(p, c, t)

        reader = solver._replace(step=reading_step)
        with pytest.raises(RuntimeError, match="synchroniz"):
            rt.run(reader, problem, 3, eager=True)
    finally:
        debug.disable()
    torch.cuda.synchronize()
    assert torch.cuda.get_sync_debug_mode() == before
    _assert_same_bits(rt.leaves(got), rt.leaves(want))


@pytest.mark.gpu
def test_dry_run_weight_bytes_match_the_materialised_model(cuda):
    """The meta pass's weight bytes for tinyllama-1.1b equal the
    materialised model's sum of numel x element_size."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    from repro_torch.models import get_model

    cfg = get_config("tinyllama-1.1b")
    params = get_model(cfg).init_params(seed=0, device=cuda)
    made = sum(p.numel() * p.element_size() for p in params.parameters())
    assert dryrun.weight_bytes(cfg) == made
