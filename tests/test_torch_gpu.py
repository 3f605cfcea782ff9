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
    with pytest.raises(ValueError, match="z axis"):  # two halves, 2 E > 65535
        e = 40000
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


# Ranks 257 .. 512: two rank halves (csrc/tile64.cuh), RQH = ceil(r / 64)
# register groups each (5, 5, 6, 7, 8, 8), on a small grid and on one with
# several row ranges (v_splits) and column ranges (u_splits) at E = 1.
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


# Ranks above 512: chunks of 256 staged in turn (csrc/tile64.cuh), three
# (513, 600, 768) and four (1024), the last one narrow but at 768 and 1024.
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
    """At r 449-512 the two halves are two chunks of 256: the chunked
    kernels (forced by lowering the two-half limit) give the two-half
    kernels' bits."""
    from repro_torch.kernels import _launch

    u, v, mat, w, lam = _card_inputs(cuda, *shape, r, seed=r)
    args = (u, v, mat, lam, _mask(w, mode))
    halves = _as_tuple(getattr(hc, fn)(*args))
    monkeypatch.setattr(_launch, "TWO_HALVES_MAX_RANK", 256)
    assert _launch.chunked(r)
    chunks = _as_tuple(getattr(hc, fn)(*args))
    for a, b in zip(halves, chunks):
        assert torch.equal(a, b), fn


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
    assert rt.graph_counts["captures"] == 1
    assert rt.graph_counts["replays"] == scfg.max_new_tokens - 2
