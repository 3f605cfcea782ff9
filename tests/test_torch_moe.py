"""The port's mixture-of-experts FFN against the JAX reference on the CPU.

The reference materialises the ``qwen2-moe-a2.7b`` smoke config's weights
(d_model 128, 8 experts of 64, top-2, a shared expert of 128) in fp32 from
``PRNGKey(0)``; the port takes layer 0's FFN through
``convert.lm_params_from_reference``.  Inputs come from numpy.

Tolerances (fp32): routing weights and the aux loss 1e-6 (one softmax and
a division); expert outputs 1e-5 (fp32 sums over d_model and d_ff in
another order).  Expert ids are equal, ties included: both packages take
the lower expert first.
"""
import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.distributed.sharding import SINGLE_DEVICE
from repro.models import moe as jmoe
from repro.models import params as jpm
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import moe

ARCH = "qwen2-moe-a2.7b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
ROUTE_TOL, TOL = 1e-6, 1e-5
BATCH = 2


def _configs(**moe_kw):
    jcfg = jconfigs.get_smoke_config(ARCH).replace(**F32)
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    return (jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw)),
            cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)))


@pytest.fixture(scope="module")
def ffn():
    """(reference config, reference layer-0 FFN params, port config, port
    layer-0 FFN params)."""
    jcfg, cfg = _configs()
    jparams = jpm.materialize(jmodels.get_model(jcfg).specs(),
                              jax.random.PRNGKey(0))
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                      cfg, "cpu")
    jffn = jax.tree.map(lambda x: x[0], jparams["segments"][0]["ffn"])
    return jcfg, jffn, cfg, params.layers[0].ffn


def _x(s, seed=0, d=128):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, s, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _route_both(jffn, params, jcfg, cfg, x):
    jw, jids, jaux = jax.jit(functools.partial(jmoe._route, cfg=jcfg))(
        jffn, jnp.asarray(x))
    w, ids, aux = moe._route(params, torch.from_numpy(x), cfg)
    return (jw, jids, jaux), (w, ids, aux)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
def test_route_matches_reference(ffn, ties):
    """Expert ids equal, weights and the aux loss within 1e-6.  With
    ``ties`` three router columns are equal, so every token's
    probabilities tie three ways: the lower expert comes first in both."""
    jcfg, jffn, cfg, params = ffn
    if ties:
        router = np.array(jffn["router"])
        router[:, 3] = router[:, 5] = router[:, 1]
        jffn = {**jffn, "router": jnp.asarray(router)}
        params = copy.deepcopy(params)
        params.router.copy_(torch.from_numpy(router))
    x = _x(24)
    (jw, jids, jaux), (w, ids, aux) = _route_both(jffn, params, jcfg, cfg,
                                                  x)
    assert np.array_equal(ids.numpy(), np.asarray(jids))
    _close(w, jw, ROUTE_TOL)
    _close(aux, jaux, ROUTE_TOL)
    if ties:  # the tie shows: some token's top-2 holds two of 1, 3, 5
        tied = np.isin(np.asarray(jids), (1, 3, 5)).sum(-1) == 2
        assert tied.any()


def test_grouped_dispatch_drops_the_references_assignments():
    """``capacity_factor=0.5`` at S = 64: each expert takes 8 of about 16
    assignments a row.  The kept set is the reference's (read from its
    output with one assignment weighted at a time) and the output is
    within 1e-5."""
    jcfg, cfg = _configs(capacity_factor=0.5)
    jparams = jpm.materialize(jmodels.get_model(jcfg).specs(),
                              jax.random.PRNGKey(0))
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                      cfg, "cpu").layers[0].ffn
    jffn = jax.tree.map(lambda x: x[0], jparams["segments"][0]["ffn"])
    x = _x(64, seed=1)
    (jw, jids, _), (w, ids, _) = _route_both(jffn, params, jcfg, cfg, x)
    grouped = jax.jit(functools.partial(jmoe._moe_grouped, cfg=jcfg,
                                        rules=SINGLE_DEVICE))
    want = grouped(jffn, jnp.asarray(x), jw, jids)
    got = moe._moe_grouped(params, torch.from_numpy(x), w, ids, cfg)
    _close(got, want)

    k = cfg.moe.top_k
    ref_kept = np.stack([
        np.abs(np.asarray(grouped(jffn, jnp.asarray(x),
                                  jnp.eye(k, dtype=jnp.float32)[j]
                                  * jnp.ones_like(jw), jids))).max(-1) > 0
        for j in range(k)], axis=-1)  # (B, S, k)
    _, keep = moe._slots(ids, cfg)
    keep = keep.reshape(ref_kept.shape).numpy()
    assert moe.capacity(cfg, 64) == 8
    assert 0 < keep.sum() < keep.size
    assert np.array_equal(keep, ref_kept)


@pytest.mark.parametrize("s", [1, 5])
def test_gather_dispatch_matches_reference(ffn, s):
    """Every token's top-k experts' weights gathered and contracted, at one
    token a row (decode) and at five."""
    jcfg, jffn, cfg, params = ffn
    x = _x(s, seed=2)
    (jw, jids, _), (w, ids, _) = _route_both(jffn, params, jcfg, cfg, x)
    want = jax.jit(functools.partial(jmoe._moe_gather, cfg=jcfg,
                                     rules=SINGLE_DEVICE))(
        jffn, jnp.asarray(x), jw, jids)
    got = moe._moe_gather(params, torch.from_numpy(x), w, ids, cfg)
    _close(got, want)


@pytest.mark.parametrize("dispatch", ["grouped", "gather", None])
def test_moe_ffn_with_the_shared_expert_matches_reference(ffn, dispatch):
    """The routed experts plus the shared one, and the aux loss, by each
    dispatch and by shape (S = 16: grouped)."""
    jcfg, jffn, cfg, params = ffn
    x = _x(16, seed=3)
    jy, jaux = jax.jit(functools.partial(
        jmoe.moe_ffn, cfg=jcfg, rules=SINGLE_DEVICE, dispatch=dispatch))(
            jffn, jnp.asarray(x))
    y, aux = moe.moe_ffn(params, torch.from_numpy(x), cfg,
                         dispatch=dispatch)
    assert cfg.moe.num_shared and hasattr(params, "shared")
    _close(y, jy)
    _close(aux, jaux, ROUTE_TOL)


def test_capacity_is_the_references_expression():
    """``max(8, int(S k / E cf + 0.999) // 8 * 8)``: 168 for qwen2-moe at
    S = 2048, 320 for jamba, the floor of 8 for short rows."""
    assert moe.capacity(configs.get_config(ARCH), 2048) == 168
    assert moe.capacity(configs.get_config("jamba-1.5-large-398b"),
                        2048) == 320
    assert moe.capacity(configs.get_smoke_config(ARCH), 16) == 8
