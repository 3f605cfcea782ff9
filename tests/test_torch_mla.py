"""The port's MLA (DeepSeek-V2's latent attention) against the JAX reference
on the CPU: the mixer alone, and the deepseek-v2 smoke model (one dense
layer, one MoE layer) through prefill, decode, ``generate`` and the loss.

The reference materialises the weights from ``PRNGKey(0)`` and the port
takes them through ``convert.lm_params_from_reference``; prompts come from
numpy: 2 x 40 tokens, attended in query chunks of 16 (the reference pads
the last chunk, the port runs it short).  Each reference function is
jitted once for the module.  MLA takes no flash kernel in either package.

Tolerances: fp32 logits and caches 1e-4 (tests/test_torch_lm.py's), bf16
8e-2 (tests/test_models_smoke.py:100); greedy tokens equal (fp32); the
loss 1e-5, gradients 1e-5 of each leaf's max |g|; the absorbed decode
against the training path 5e-2 in bf16 (tests/test_attention.py:76-99)
and 1e-5 in fp32.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.distributed.sharding import SINGLE_DEVICE
from repro.models import attention as jattention
from repro.models import params as jpm
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import (
    _layer_node, lm_grads_from_reference, lm_params_from_reference,
)
from repro_torch.models import attention, get_model, lm
from repro_torch.models.layers import padded_vocab
from repro_torch.models.params import Params
from repro_torch.serving.engine import ServeConfig, generate

ARCH = "deepseek-v2-236b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
TOL, BF16_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 8e-2, 1e-5, 1e-5
BATCH, PROMPT, NEW, STEPS, Q_CHUNK = 2, 40, 8, 3, 16


def _tokens(cfg, s=PROMPT, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, s)).astype(np.int32)


class Pair:
    """The reference's and the port's deepseek-v2 smoke model, weights and
    jitted functions in fp32 or bf16."""

    def __init__(self, kind: str):
        kw = dict(q_chunk=Q_CHUNK, **(F32 if kind == "f32" else {}))
        self.kind = kind
        self.tol = TOL if kind == "f32" else BF16_TOL
        self.jmodel = jmodels.get_model(
            jconfigs.get_smoke_config(ARCH).replace(**kw))
        self.jparams = jpm.materialize(self.jmodel.specs(),
                                       jax.random.PRNGKey(0))
        self.cfg = configs.get_smoke_config(ARCH).replace(**kw)
        self.model = get_model(self.cfg)
        self.params = lm_params_from_reference(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        self.prompt = _tokens(self.cfg)
        self.jprefill = jax.jit(lambda p, t: self.jmodel.prefill(
            p, {"tokens": t}, SINGLE_DEVICE))
        self.jdecode = jax.jit(lambda p, t, c, pos: self.jmodel.decode_step(
            p, t, c, pos, SINGLE_DEVICE))

    def assert_caches_close(self, caches, jcaches, start=0):
        """Every layer's latent and rope caches from sequence position
        ``start`` on."""
        for layer, got in enumerate(caches):
            node, i = _layer_node({"segments": jcaches}, self.cfg, layer)
            for g, w in zip(got, node["mixer"], strict=True):
                np.testing.assert_allclose(
                    g.to(torch.float32).numpy()[:, start:],
                    np.asarray(w, np.float32)[i][:, start:],
                    rtol=self.tol, atol=self.tol)


_PAIRS: dict = {}


def _pair(kind):
    if kind not in _PAIRS:
        _PAIRS[kind] = Pair(kind)
    return _PAIRS[kind]


@pytest.fixture(scope="module", params=["f32", "bf16"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("f32")


def test_stack_is_mla_with_a_dense_first_layer():
    cfg = configs.get_config(ARCH)
    plan = lm.layer_plan(cfg)
    assert plan[0] == ("mla", "mlp") and len(plan) == 60
    assert set(plan[1:]) == {("mla", "moe")}
    assert lm.stack_plan(cfg) == [lm.Segment("mla", "mlp", 1),
                                  lm.Segment("mla", "moe", 59)]


def test_prefill_matches_reference(pair):
    """Last-position logits and every layer's latent (B, S, kv_lora) and
    rope (B, S, rope_dim) caches."""
    jlogits, jcaches = pair.jprefill(pair.jparams, jnp.asarray(pair.prompt))
    logits, caches = pair.model.prefill(pair.params,
                                        torch.from_numpy(pair.prompt))
    assert logits.shape == (BATCH, padded_vocab(pair.cfg.vocab))
    mla = pair.cfg.mla
    assert [tuple(c.shape) for c in caches[0]] == [
        (BATCH, PROMPT, mla.kv_lora_rank), (BATCH, PROMPT, mla.qk_rope_dim)]
    np.testing.assert_allclose(logits.to(torch.float32).numpy(),
                               np.asarray(jlogits, np.float32),
                               rtol=pair.tol, atol=pair.tol)
    pair.assert_caches_close(caches, jcaches)


def test_decode_steps_match_reference(pair):
    """Three absorbed decode steps at a 0-d int32 position into caches of
    s_max = prompt + NEW (the reference's padded caches): the logits of
    each, and the caches updated in place at the new positions."""
    s_max = PROMPT + NEW  # the greedy test's, so one decode compile
    _, jcaches = pair.jprefill(pair.jparams, jnp.asarray(pair.prompt))
    jcaches = jengine._pad_caches(pair.jmodel, jcaches, BATCH, PROMPT, s_max)
    caches = pair.model.init_cache(BATCH, s_max, "cpu")
    pair.model.prefill(pair.params, torch.from_numpy(pair.prompt), caches)
    bufs = [tuple(c) for c in caches]
    tok = _tokens(pair.cfg, s=STEPS, seed=9)
    for step in range(STEPS):
        t = tok[:, step:step + 1]
        jlogits, jcaches = pair.jdecode(pair.jparams, jnp.asarray(t),
                                        jcaches, jnp.int32(PROMPT + step))
        logits, caches = pair.model.decode_step(
            pair.params, torch.from_numpy(t), caches,
            torch.tensor(PROMPT + step, dtype=torch.int32))
        np.testing.assert_allclose(logits.to(torch.float32).numpy(),
                                   np.asarray(jlogits, np.float32),
                                   rtol=pair.tol, atol=pair.tol)
    for cache, buf in zip(caches, bufs, strict=True):
        assert all(a is b for a, b in zip(cache, buf, strict=True))
    pair.assert_caches_close(caches, jcaches, start=PROMPT)


def test_greedy_tokens_match_reference(f32_pair):
    """The port's ``generate`` against the reference's prefill and argmax
    decode steps (its ``generate`` at temperature 0, through the jitted
    functions the other tests compile)."""
    p = f32_pair
    logits, caches = p.jprefill(p.jparams, jnp.asarray(p.prompt))
    caches = jengine._pad_caches(p.jmodel, caches, BATCH, PROMPT,
                                 PROMPT + NEW)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    want = [tok]
    for i in range(NEW - 1):
        logits, caches = p.jdecode(p.jparams, tok, caches,
                                   jnp.int32(PROMPT + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        want.append(tok)
    got = generate(p.model, p.params, torch.from_numpy(p.prompt),
                   ServeConfig(max_new_tokens=NEW))
    assert got.shape == (BATCH, NEW) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(jnp.concatenate(want, axis=1)))


def test_loss_and_gradients_match_reference(f32_pair):
    """``Model.loss`` (cross-entropy plus the router's aux term) through
    the training MLA, and its gradients, against ``jax.value_and_grad`` of
    the reference's loss."""
    p = f32_pair
    tokens = _tokens(p.cfg, seed=3)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    (jloss, jmets), jgrads = jax.jit(jax.value_and_grad(
        lambda params, batch: p.jmodel.loss(params, batch, SINGLE_DEVICE),
        has_aux=True))(p.jparams, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)})
    module = copy.deepcopy(p.params)
    names, leaves = zip(*module.named_parameters())
    for x in leaves:
        x.requires_grad_(True)
    loss, mets = p.model.loss(module, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    np.testing.assert_allclose(mets["aux"].item(), float(jmets["aux"]),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    want = lm_grads_from_reference(jax.tree.map(np.asarray, jgrads), p.cfg,
                                   "cpu")
    assert any("wkv_b" in n for n in names)
    for name, g in zip(names, grads, strict=True):
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
        assert err <= GRAD_TOL, (name, err)


# ---------------------------------------------------------------------------
# The mixer alone
# ---------------------------------------------------------------------------
def _mixer(dtype: str):
    """The smoke config's MLA weights from ``PRNGKey(3)`` in both packages
    and an input (2, 16, d) from ``PRNGKey(4)``, as
    tests/test_attention.py:test_mla_decode_matches_train_path."""
    kw = F32 if dtype == "f32" else {}
    jcfg = jconfigs.get_smoke_config(ARCH).replace(**kw)
    cfg = configs.get_smoke_config(ARCH).replace(**kw)
    jp = jpm.materialize(jattention.mla_specs(jcfg), jax.random.PRNGKey(3))
    x = jax.random.normal(jax.random.PRNGKey(4), (2, 16, cfg.d_model),
                          jnp.float32).astype(jcfg.cdtype)
    params = Params(attention.mla_specs(cfg), "cpu")
    with torch.no_grad():
        for name, t in params.named_parameters():
            t.copy_(torch.from_numpy(np.array(jp[name], np.float32)))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(cfg.cdtype)
    return jcfg, jp, x, cfg, params, xt


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_absorbed_decode_matches_the_training_path(dtype):
    """The port's absorbed decode of the last token over the latent cache
    of the first 15 equals its own non-absorbed attention at that
    position, and the reference's decode."""
    jcfg, jp, x, cfg, params, xt = _mixer(dtype)
    b, s = xt.shape[:2]
    positions = torch.arange(s).expand(b, s)
    with torch.no_grad():
        y_full, _ = attention.mla_attention(params, xt, positions, cfg)
        _, (ckv, krope) = attention.mla_attention(
            params, xt[:, :-1], positions[:, :-1], cfg)
        cache_c = torch.zeros(b, s, cfg.mla.kv_lora_rank, dtype=cfg.cdtype)
        cache_r = torch.zeros(b, s, cfg.mla.qk_rope_dim, dtype=cfg.cdtype)
        cache_c[:, :-1], cache_r[:, :-1] = ckv, krope
        y_dec = attention.mla_attention_decode(
            params, xt[:, -1:], cache_c, cache_r,
            torch.tensor(s - 1, dtype=torch.int32), cfg)
    tol = 1e-5 if dtype == "f32" else 5e-2
    np.testing.assert_allclose(y_dec[:, 0].float().numpy(),
                               y_full[:, -1].float().numpy(), rtol=tol,
                               atol=tol)
    # The decode wrote the last token's latent and rope at s - 1.
    np.testing.assert_allclose(cache_c[:, :-1].float().numpy(),
                               ckv.float().numpy())
    jpad = [jnp.asarray(c.float().numpy()).astype(jcfg.cdtype)
            for c in (cache_c, cache_r)]
    jpad = [j.at[:, -1].set(0) for j in jpad]
    jy, (jc, jr) = jax.jit(jattention.mla_attention_decode,
                           static_argnums=(5, 6))(
        jp, x[:, -1:], *jpad, jnp.asarray(s - 1), jcfg, SINGLE_DEVICE)
    ptol = TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(y_dec.float().numpy(),
                               np.asarray(jy, np.float32), rtol=ptol,
                               atol=ptol)
    np.testing.assert_allclose(cache_c.float().numpy(),
                               np.asarray(jc, np.float32), rtol=ptol,
                               atol=ptol)
    np.testing.assert_allclose(cache_r.float().numpy(),
                               np.asarray(jr, np.float32), rtol=ptol,
                               atol=ptol)


def test_mla_scale_is_the_query_width():
    """1/sqrt(nope + rope): 1/sqrt(192) at full width, where ``cfg.hd`` is
    128."""
    cfg = configs.get_config(ARCH)
    assert cfg.hd == 128
    assert attention._mla_scale(cfg) == 1.0 / 192 ** 0.5
