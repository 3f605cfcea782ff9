"""The port's Mamba-2 SSD mixer against the JAX reference on the CPU.

The reference materialises the ``mamba2-780m`` smoke config's weights
(d_model 128, 4 SSD heads of 64, d_state 16, chunk 32) in fp32 from
``PRNGKey(0)``; the port takes layer 0's mixer through
``convert.lm_params_from_reference``.  Inputs come from numpy.  Every
reference function is jitted once for the module and shape.

Tolerances (fp32): 1e-5 on outputs and states (rtol and atol; fp32 sums
in another order), 1e-6 on the causal conv (four products a channel, added
in the reference's order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.distributed.sharding import SINGLE_DEVICE
from repro.models import blocks as jblocks
from repro.models import params as jpm
from repro.models import ssm as jssm
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import ssm

ARCH = "mamba2-780m"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL, CONV_TOL = 1e-5, 1e-6
BATCH, DECODE_STEPS = 2, 8


@pytest.fixture(scope="module")
def mixer():
    """(reference config, reference layer-0 mixer params, port config,
    port layer-0 mixer params)."""
    jcfg = jconfigs.get_smoke_config(ARCH).replace(**F32)
    jparams = jpm.materialize(jmodels.get_model(jcfg).specs(),
                              jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    params = lm_params_from_reference(jax.tree.map(np.asarray, jparams),
                                      cfg, "cpu")
    jmix = jax.tree.map(lambda x: x[0], jparams["segments"][0]["mixer"])
    return jcfg, jmix, cfg, params.layers[0].mixer


def _h(s, seed=0, d=128):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, s, d)).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _steps(params, h, state, cfg):
    """``h`` (B, S, d) fed one token at a time through the port's decode."""
    outs = []
    for t in range(h.shape[1]):
        y, state = ssm.ssd_decode(params, h[:, t:t + 1], state, cfg)
        outs.append(y)
    return torch.cat(outs, dim=1), state


@pytest.mark.parametrize("s", [64, 37], ids=["aligned", "unaligned"])
def test_ssd_output_and_final_state_match_reference(mixer, s):
    """At S = 64 (two chunks of 32) and S = 37 (a chunk and 27 padded
    steps): the output and the final state.  At 37 the reference pads the
    raw dt before softplus, so each padded step decays the final state:
    the port reproduces that state, and it is not the state of the same
    tokens decoded one at a time (an aligned prompt's is)."""
    jcfg, jmix, cfg, params = mixer
    h = _h(s)
    jout, jstate = jax.jit(functools.partial(
        jssm.ssd, cfg=jcfg, rules=SINGLE_DEVICE, return_state=True))(
            jmix, jnp.asarray(h))
    out, state = ssm.ssd(params, torch.from_numpy(h), cfg, return_state=True)
    assert out.shape == (BATCH, s, cfg.d_model)
    assert state.dtype == torch.float32
    _close(out, jout)
    _close(state, jstate)
    _, stepped = _steps(params, torch.from_numpy(h), ssm.ssd_init_state(
        cfg, BATCH, "cpu"), cfg)
    gap = (stepped.ssm - state).abs().max().item()
    if s % cfg.ssm.chunk:
        assert gap > 0.5 * stepped.ssm.abs().max().item()
    else:
        assert gap <= 1e-4 * stepped.ssm.abs().max().item()


def test_ssd_decode_steps_match_reference(mixer):
    """A 32-token prefill's decode-ready state (the reference's
    ``blocks._ssm_prefill_state``: the pre-conv tail and the final state),
    then 8 ``ssd_decode`` steps: each output, and the conv and SSM states
    after every step, updated in place."""
    jcfg, jmix, cfg, params = mixer
    h = _h(32 + DECODE_STEPS, seed=1)
    prompt, rest = h[:, :32], h[:, 32:]

    @jax.jit
    def ref_prefill(p, x):
        _, final = jssm.ssd(p, x, jcfg, SINGLE_DEVICE, return_state=True)
        return jblocks._ssm_prefill_state(p, x, final, jcfg)

    jstate = ref_prefill(jmix, jnp.asarray(prompt))
    _, state = ssm.ssd_prefill(params, torch.from_numpy(prompt), cfg)
    _close(state.conv, jstate.conv)
    _close(state.ssm, jstate.ssm)
    bufs = state
    step = jax.jit(functools.partial(jssm.ssd_decode, cfg=jcfg,
                                     rules=SINGLE_DEVICE))
    for t in range(DECODE_STEPS):
        jy, jstate = step(jmix, jnp.asarray(rest[:, t:t + 1]), jstate)
        y, state = ssm.ssd_decode(params, torch.from_numpy(
            rest[:, t:t + 1]), state, cfg)
        assert state.conv is bufs.conv and state.ssm is bufs.ssm
        _close(y, jy)
        _close(state.conv, jstate.conv)
        _close(state.ssm, jstate.ssm)


def test_ssd_init_state_matches_reference(mixer):
    jcfg, _, cfg, _ = mixer
    jstate = jssm.ssd_init_state(jcfg, BATCH)
    state = ssm.ssd_init_state(cfg, BATCH, "cpu")
    for got, want in zip(state, jstate, strict=True):
        assert tuple(got.shape) == want.shape
        assert str(got.dtype).split(".")[-1] == want.dtype.name
        assert not got.any()


def test_causal_conv_matches_reference(mixer):
    _, jmix, _, params = mixer
    x = _h(40, seed=2, d=256)
    want = jax.jit(jssm._causal_conv)(jnp.asarray(x), jmix["conv_x"])
    got = ssm._causal_conv(torch.from_numpy(x), params.conv_x)
    _close(got, want, CONV_TOL)


def test_ssd_from_an_initial_state_matches_reference(mixer):
    """``initial_state``: the chunk scan starts from a given (B, H, N, P)
    state (an earlier prompt's), as the reference's."""
    jcfg, jmix, cfg, params = mixer
    h, first = _h(40, seed=3), _h(32, seed=4)
    run = jax.jit(functools.partial(jssm.ssd, cfg=jcfg, rules=SINGLE_DEVICE,
                                    return_state=True))
    _, jmid = run(jmix, jnp.asarray(first))
    jout, jend = run(jmix, jnp.asarray(h), initial_state=jmid)
    _, mid = ssm.ssd(params, torch.from_numpy(first), cfg, return_state=True)
    out, end = ssm.ssd(params, torch.from_numpy(h), cfg, initial_state=mid,
                       return_state=True)
    _close(out, jout)
    _close(end, jend)
