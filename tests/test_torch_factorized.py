"""The port's solver pieces against the JAX reference, on the CPU.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: threshold calibration rtol 1e-6 (the medians select the same
entries; only the final fp32 products may round differently); one local
round 1e-5 (the gate of ROADMAP.md Queue 1 item 3: fp32 GEMMs and r x r
solves in another order, over K * J = 6 dependent sweeps).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import factorized as jfz
from repro.core import metrics as jmetrics
from repro.core import ops as jops
from repro.core import problems as jprob
from repro.core import validate as jval
from repro.kernels import bitmask as jbitmask
from repro_torch.core import factorized as fz
from repro_torch.core import metrics
from repro_torch.core import ops
from repro_torch.core import problems as prob
from repro_torch.core import validate as val
from repro_torch.kernels import bitmask

ROUND_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("use_mask", [False, True])
@pytest.mark.parametrize("shape,sample", [((31, 17), None), ((32, 16), None),
                                          ((40, 30), 100), ((41, 29), 101)])
def test_robust_lam_matches_reference(shape, sample, use_mask):
    """Odd and even counts (the even median averages the middle pair),
    masked and not, exact and strided-sample."""
    rng = np.random.default_rng(sum(shape))
    m = rng.standard_normal(shape).astype(np.float32)
    m[rng.random(shape) < 0.05] = 40.0
    mask = (rng.random(shape) < 0.7).astype(np.float32) if use_mask else None
    want = float(jfz.robust_lam(jnp.asarray(m), mask=None if mask is None
                                else jnp.asarray(mask), sample=sample))
    got = float(fz.robust_lam(_t(m), mask=None if mask is None else _t(mask),
                              sample=sample))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("n,clients", [(160, 8), (157, 8), (9, 4), (30, 1)])
def test_column_split_matches_reference(n, clients):
    mat = np.arange(6 * n, dtype=np.float32).reshape(6, n)
    want = np.asarray(jprob.split_columns(jnp.asarray(mat), clients))
    got = prob.split_columns(_t(mat), clients)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(prob.merge_columns(got, n).numpy(), mat)
    assert np.array_equal(
        prob.merge_columns(got).numpy(),
        np.asarray(jprob.merge_columns(jnp.asarray(want))))
    assert (prob.client_column_counts(n, clients)
            == jprob.client_column_counts(n, clients))


def _cfg_dict(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("preset", ["default", "paper", "tuned", "tuned_hard",
                                    "masked", "elastic"])
def test_config_fields_defaults_and_presets_match(preset):
    names = [f.name for f in dataclasses.fields(jfz.DCFConfig)]
    assert [f.name for f in dataclasses.fields(fz.DCFConfig)] == names
    if preset == "default":
        mine, theirs = fz.DCFConfig(rank=7), jfz.DCFConfig(rank=7)
    else:
        mine = getattr(fz.DCFConfig, preset)(7)
        theirs = getattr(jfz.DCFConfig, preset)(7)
    assert _cfg_dict(mine) == _cfg_dict(theirs)


@pytest.mark.parametrize("preset", ["paper", "tuned"])
def test_schedules_match_reference(preset):
    mine = getattr(fz.DCFConfig, preset)(5, lr_schedule="decay")
    theirs = getattr(jfz.DCFConfig, preset)(5, lr_schedule="decay")
    ts = np.arange(0, 120, 7, dtype=np.int32)
    lam0 = np.float32(3.7)
    for t in ts:
        tt = torch.tensor(int(t), dtype=torch.int32)
        np.testing.assert_allclose(float(mine.lr(tt)), float(theirs.lr(t)),
                                   rtol=1e-6)
        np.testing.assert_allclose(
            float(mine.lam_at(torch.tensor(lam0), tt)),
            float(theirs.lam_at(lam0, t)), rtol=1e-6)


def _round_inputs(e=3, m=40, n=24, r=5, seed=0):
    rng = np.random.default_rng(seed)
    l0 = rng.standard_normal((m, r)) @ rng.standard_normal((r, e * n))
    mat = l0.astype(np.float32)
    mat[rng.random(mat.shape) < 0.05] = 25.0
    blocks = np.stack(np.split(mat, e, axis=1))
    u = (rng.standard_normal((m, r)) / np.sqrt(r)).astype(np.float32)
    v = (rng.standard_normal((e, n, r)) / np.sqrt(r)).astype(np.float32)
    w = (rng.random(blocks.shape) < 0.7).astype(np.float32)
    return u, v, blocks, w


@pytest.mark.parametrize("inner,precondition,masked", [
    ("altmin", "lipschitz", False), ("altmin", "lipschitz", True),
    ("huber_gd", "lipschitz", False), ("altmin", "newton", False),
    ("altmin", "raw", False),
])
def test_local_round_matches_reference(inner, precondition, masked):
    """One local round from identical (U, V, M, lam) for every client.
    The raw (unconditioned) step takes the paper's eta0 = 0.05; the
    conditioned ones the tuned preset's 0.5."""
    u, v, blocks, w = _round_inputs()
    e = blocks.shape[0]
    lam, n_frac = 1.5, 1.0 / e
    eta = 0.05 if precondition == "raw" else 0.5
    kw = dict(inner=inner, precondition=precondition)
    mine_cfg, ref_cfg = fz.DCFConfig.tuned(5, **kw), jfz.DCFConfig.tuned(5, **kw)
    u_i, v_i, diag = fz.local_round(
        _t(u), _t(v), _t(blocks), cfg=mine_cfg,
        lam=torch.full((e,), lam), n_frac=n_frac, eta=torch.tensor(eta),
        w=_t(w) if masked else None)
    for k in range(e):
        ru, rv, rdiag = jfz.local_round(
            jnp.asarray(u), jnp.asarray(v[k]), jnp.asarray(blocks[k]),
            cfg=ref_cfg, lam=lam, n_frac=n_frac, eta=jnp.float32(eta),
            w=jnp.asarray(w[k]) if masked else None)
        np.testing.assert_allclose(u_i[k].numpy(), np.asarray(ru),
                                   rtol=ROUND_TOL, atol=ROUND_TOL)
        np.testing.assert_allclose(v_i[k].numpy(), np.asarray(rv),
                                   rtol=ROUND_TOL, atol=ROUND_TOL)
        for got, want in zip(diag, rdiag):
            np.testing.assert_allclose(float(got[k]), float(want),
                                       rtol=ROUND_TOL)


# (fused, masked, packed, bf16): the dual and off rounds, the packed mask
# and the bf16 data plane, alone and together.
FLAVOURS = [("dual", False, False, False), ("dual", True, False, False),
            ("off", False, False, False), ("off", True, False, False),
            ("diag", True, True, False), ("dual", True, True, False),
            ("off", True, True, False), ("diag", False, False, True),
            ("dual", True, True, True), ("off", False, False, True)]


@pytest.mark.parametrize("fused,masked,packed,bf16", FLAVOURS)
def test_local_round_flavours_match_reference(fused, masked, packed, bf16):
    """One local round under each round flavour and data plane, from
    identical inputs; bf16 M is cast on each side from the same fp32
    array."""
    u, v, blocks, w = _round_inputs(seed=5)
    e = blocks.shape[0]
    lam, n_frac, eta = 1.5, 1.0 / e, 0.5
    mine_cfg = fz.DCFConfig.tuned(5, fused=fused, pack_mask=packed)
    ref_cfg = jfz.DCFConfig.tuned(5, fused=fused, pack_mask=packed)
    m_port, m_ref = _t(blocks), jnp.asarray(blocks)
    if bf16:
        m_port, m_ref = m_port.to(torch.bfloat16), m_ref.astype(jnp.bfloat16)
    w_port = _t(w) if masked else None
    if masked and packed:
        w_port = bitmask.pack_mask(w_port)
    u_i, v_i, diag = fz.local_round(
        _t(u), _t(v), m_port, cfg=mine_cfg, lam=torch.full((e,), lam),
        n_frac=n_frac, eta=torch.tensor(eta), w=w_port)
    assert (diag is None) == (fused == "off")
    for k in range(e):
        w_ref = jnp.asarray(w[k]) if masked else None
        if masked and packed:
            w_ref = jbitmask.pack_mask(w_ref)
        ru, rv, rdiag = jfz.local_round(
            jnp.asarray(u), jnp.asarray(v[k]), m_ref[k], cfg=ref_cfg,
            lam=lam, n_frac=n_frac, eta=jnp.float32(eta), w=w_ref)
        np.testing.assert_allclose(u_i[k].numpy(), np.asarray(ru),
                                   rtol=ROUND_TOL, atol=ROUND_TOL)
        np.testing.assert_allclose(v_i[k].numpy(), np.asarray(rv),
                                   rtol=ROUND_TOL, atol=ROUND_TOL)
        for got, want in zip(diag or (), rdiag or ()):
            np.testing.assert_allclose(float(got[k]), float(want),
                                       rtol=ROUND_TOL)


@pytest.mark.parametrize("sample", [None, 300])
def test_robust_lam_bf16_data_matches_reference(sample):
    """The threshold calibrated on a bf16 data plane (masked, and from a
    strided sample), cast on each side from the same fp32 array."""
    rng = np.random.default_rng(11)
    m = (rng.standard_normal((40, 30)) * 3).astype(np.float32)
    m[rng.random(m.shape) < 0.05] = 40.0
    mask = (rng.random(m.shape) < 0.7).astype(np.float32)
    want = float(jfz.robust_lam(jnp.asarray(m).astype(jnp.bfloat16),
                                mask=jnp.asarray(mask), sample=sample))
    got = float(fz.robust_lam(_t(m).to(torch.bfloat16), mask=_t(mask),
                              sample=sample))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_consensus_matches_reference():
    rng = np.random.default_rng(1)
    u_i = rng.standard_normal((8, 12, 3)).astype(np.float32)
    n_cols = np.array(prob.client_column_counts(157, 8), np.float32)
    cfg, jcfg = fz.DCFConfig(rank=3), jfz.DCFConfig(rank=3)
    for cols in (None, n_cols):
        got, wsum = fz.aggregate_stacked(
            cfg, _t(u_i), _t(u_i[0]),
            n_cols=None if cols is None else _t(cols), num_clients=8)
        assert wsum is None
        want, _ = jfz.aggregate_stacked(
            jcfg, jnp.asarray(u_i), jnp.asarray(u_i[0]),
            n_cols=None if cols is None else jnp.asarray(cols), num_clients=8)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)


def test_local_objective_and_finalize_match_reference():
    u, v, blocks, w = _round_inputs(seed=2)
    lam = 1.5
    got = fz.local_objective(_t(u), _t(v), _t(blocks), 0.01, lam, 0.25,
                             w=_t(w))
    # A packed mask and a bf16 plane of the same (bf16-exact) data give
    # the same objective.
    exact = _t(blocks).to(torch.bfloat16)
    assert torch.equal(
        fz.local_objective(_t(u), _t(v), exact, 0.01, lam, 0.25,
                           w=bitmask.pack_mask(_t(w))),
        fz.local_objective(_t(u), _t(v), exact.float(), 0.01, lam, 0.25,
                           w=_t(w)))
    l, s = fz.finalize(_t(u), _t(v), _t(blocks), lam, "auto", w=_t(w))
    for k in range(blocks.shape[0]):
        want = jfz.local_objective(jnp.asarray(u), jnp.asarray(v[k]),
                                   jnp.asarray(blocks[k]), 0.01, lam, 0.25,
                                   w=jnp.asarray(w[k]))
        np.testing.assert_allclose(float(got[k]), float(want), rtol=1e-5)
        rl, rs = jfz.finalize(jnp.asarray(u), jnp.asarray(v[k]),
                              jnp.asarray(blocks[k]), lam, "ref",
                              w=jnp.asarray(w[k]))
        np.testing.assert_allclose(l[k].numpy(), np.asarray(rl), rtol=2e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(s[k].numpy(), np.asarray(rs), rtol=2e-5,
                                   atol=2e-5)


def _message(fn, *args, **kw):
    with pytest.raises(ValueError) as info:
        fn(*args, **kw)
    return str(info.value)


def test_validation_messages_identical():
    data = np.zeros((4, 5), np.float32)
    for mask in (np.zeros((4, 6), np.float32), np.zeros((4, 5), np.uint8)):
        assert (_message(val.check_mask, _t(mask), data.shape)
                == _message(jval.check_mask, jnp.asarray(mask), data.shape))
    warm = (np.zeros((4, 2)), np.zeros((3, 2)))
    args = (("U", "V"), ((4, 2), (5, 2)), ("(m, rank)", "(n, rank)"))
    assert (_message(val.check_warm_shapes, warm, *args)
            == _message(jval.check_warm_shapes, warm, *args))
    assert (_message(val.check_warm_shapes, (1, 2, 3), *args)
            == _message(jval.check_warm_shapes, (1, 2, 3), *args))


def test_core_ops_and_metrics_match_reference():
    """Elementary operators, objectives and metrics (fp32, rtol 1e-5)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((20, 12)) * 3).astype(np.float32)
    u, v, s = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((20, 3), (12, 3), (20, 12)))
    w = (rng.random((20, 12)) < 0.6).astype(np.float32)
    lam, rho = 1.2, 0.05
    pairs = [
        (ops.soft_threshold(_t(x), lam), jops.soft_threshold(x, lam)),
        (ops.huber_clip(_t(x), lam), jops.huber_clip(x, lam)),
        (ops.huber_loss(_t(x), lam), jops.huber_loss(x, lam)),
        (ops.masked_huber_loss(_t(x), lam, _t(w)),
         jops.masked_huber_loss(x, lam, w)),
        (ops.factored_objective(_t(u), _t(v), _t(s), _t(x), rho, lam, _t(w)),
         jops.factored_objective(u, v, s, x, rho, lam, w)),
        (ops.eliminated_objective(_t(u), _t(v), _t(x), rho, lam),
         jops.eliminated_objective(u, v, x, rho, lam)),
        (ops.spectral_norm_ub_gram(_t(u.T @ u)),
         jops.spectral_norm_ub_gram(jnp.asarray(u.T @ u))),
        (metrics.relative_error(_t(x), _t(s), _t(u @ v.T), _t(w)),
         jmetrics.relative_error(x, s, u @ v.T, w)),
        (metrics.low_rank_relative_error(_t(x), _t(s)),
         jmetrics.low_rank_relative_error(x, s)),
        *zip(metrics.completion_errors(_t(x), _t(s), _t(w)),
             jmetrics.completion_errors(x, s, w)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
