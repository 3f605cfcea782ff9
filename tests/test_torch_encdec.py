"""The port's encoder-decoder (whisper-small: a bidirectional encoder over
the frame context, a decoder of causal self-attention, cross-attention and
MLP layers) against the JAX reference on the CPU, through the encoder,
prefill, decode, greedy generation and the loss.

The reference materialises the smoke config's weights from ``PRNGKey(0)``
(2 encoder and 2 decoder layers; a context of 64 frames) and the port
takes them through ``convert.lm_params_from_reference`` (``encoder``,
``ln_enc``, and ``decoder`` as the port's ``layers``).  Prompts (2 x 24
tokens) and the context (2 x 64 x d_model, standard normal) come from
numpy.  The decoder's self-attention takes the flash path (the
reference's Pallas kernel in interpret mode, the port's plain version);
the encoder (training mode) and the cross-attention are plain in both.
The reference's ``generate`` passes no context, so the port's
``generate(..., ctx=)`` is held to the reference's prefill and decode
steps driven with argmax (the body of its ``generate`` at temperature 0).

Tolerances: fp32 logits, caches and encoder output 1e-4
(tests/test_torch_lm.py's), bf16 8e-2 (tests/test_models_smoke.py:100);
greedy tokens equal (fp32); the loss 1e-5, gradients 1e-5 of each leaf's
max |g|.
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
from repro.models import encdec as jencdec
from repro.models import params as jpm
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import (
    lm_grads_from_reference, lm_params_from_reference,
)
from repro_torch.launch import serve
from repro_torch.models import blocks, encdec, get_model
from repro_torch.serving.engine import ServeConfig, generate

ARCH = "whisper-small"
F32 = dict(param_dtype="float32", compute_dtype="float32",
           flash_attention=True)
TOL, BF16_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 8e-2, 1e-5, 1e-5
BATCH, PROMPT, NEW, STEPS = 2, 24, 6, 3


def _tokens(cfg, s=PROMPT, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, s)).astype(np.int32)


def _ctx(cfg, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.encdec.n_context_tokens, cfg.d_model)).astype(np.float32)


class Pair:
    """The reference's and the port's whisper smoke model, weights, inputs
    and jitted functions in fp32 or bf16."""

    def __init__(self, kind: str):
        kw = F32 if kind == "f32" else dict(flash_attention=True)
        self.kind = kind
        self.tol = TOL if kind == "f32" else BF16_TOL
        self.jcfg = jconfigs.get_smoke_config(ARCH).replace(**kw)
        self.jmodel = jmodels.get_model(self.jcfg)
        self.jparams = jpm.materialize(self.jmodel.specs(),
                                       jax.random.PRNGKey(0))
        self.cfg = configs.get_smoke_config(ARCH).replace(**kw)
        self.model = get_model(self.cfg)
        self.params = lm_params_from_reference(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        self.prompt = _tokens(self.cfg)
        self.ctx = _ctx(self.cfg)
        self.jctx = jnp.asarray(self.ctx).astype(self.jcfg.cdtype)
        self.tctx = torch.from_numpy(self.ctx).to(self.cfg.cdtype)
        self.jprefill = jax.jit(lambda p, t, c: self.jmodel.prefill(
            p, {"tokens": t, "ctx": c}, SINGLE_DEVICE))
        self.jdecode = jax.jit(lambda p, t, c, pos: self.jmodel.decode_step(
            p, t, c, pos, SINGLE_DEVICE))

    def prefill(self, params=None, ctx=None, caches=None):
        return self.model.prefill(
            self.params if params is None else params,
            torch.from_numpy(self.prompt), caches,
            ctx=self.tctx if ctx is None else ctx)

    def assert_caches_close(self, caches, jcaches, start=0):
        """Every decoder layer's cache: the self K/V from sequence
        position ``start`` on, the context K/V whole."""
        for layer, got in enumerate(caches):
            assert isinstance(got, blocks.SelfCrossCache)
            want = [np.asarray(w, np.float32)[layer]
                    for w in (*jcaches["mixer"], *jcaches["cross"])]
            for j, (g, w) in enumerate(zip(got, want, strict=True)):
                g = g.to(torch.float32).numpy()
                if j < 2:
                    g, w = g[:, start:], w[:, start:]
                np.testing.assert_allclose(g, w, rtol=self.tol,
                                           atol=self.tol)


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


def test_encoder_matches_reference(pair):
    """The bidirectional encoder's output (after ``ln_enc``), and that it
    is bidirectional: the last frame moves the first position's output."""
    want = jax.jit(lambda p, c: jencdec.encode(p, c, pair.jcfg,
                                               SINGLE_DEVICE))(
        pair.jparams, pair.jctx)
    with torch.no_grad():
        got = encdec.encode(pair.params, pair.tctx, pair.cfg)
        moved = pair.tctx.clone()
        moved[:, -1] += 1
        other = encdec.encode(pair.params, moved, pair.cfg)
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=pair.tol,
                               atol=pair.tol)
    assert not torch.equal(got[:, 0], other[:, 0])


def test_prefill_matches_reference(pair):
    """Last-position logits and every decoder layer's ``SelfCrossCache``:
    the prompt's K/V and the encoder output's (B, T, KV, hd) K/V."""
    jlogits, jcaches = pair.jprefill(pair.jparams, jnp.asarray(pair.prompt),
                                     pair.jctx)
    logits, caches = pair.prefill()
    cfg = pair.cfg
    assert tuple(caches[0].cross_k.shape) == (
        BATCH, cfg.encdec.n_context_tokens, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(logits.to(torch.float32).numpy(),
                               np.asarray(jlogits, np.float32),
                               rtol=pair.tol, atol=pair.tol)
    pair.assert_caches_close(caches, jcaches)


def test_decode_steps_match_reference(pair):
    """Three decode steps at a 0-d int32 position into caches of s_max =
    prompt + 3: the logits of each; the self K/V written in place at the
    new positions, the context K/V the same bytes as after the prefill."""
    s_max = PROMPT + NEW  # the greedy test's, so one decode compile
    _, jcaches = pair.jprefill(pair.jparams, jnp.asarray(pair.prompt),
                               pair.jctx)
    jcaches = jengine._pad_caches(pair.jmodel, jcaches, BATCH, PROMPT, s_max)
    caches = pair.model.init_cache(BATCH, s_max, "cpu")
    pair.prefill(caches=caches)
    cross_before = [(c.cross_k.clone(), c.cross_v.clone()) for c in caches]
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
    for (k, v), c in zip(cross_before, caches, strict=True):
        assert torch.equal(k, c.cross_k) and torch.equal(v, c.cross_v)
    pair.assert_caches_close(caches, jcaches, start=PROMPT)


def _reference_greedy(p, new=NEW):
    """The reference's prefill, then argmax decode steps from caches
    padded to prompt + ``new`` (its ``generate`` at temperature 0)."""
    logits, caches = p.jprefill(p.jparams, jnp.asarray(p.prompt), p.jctx)
    caches = jengine._pad_caches(p.jmodel, caches, BATCH, PROMPT,
                                 PROMPT + new)
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(new - 1):
        logits, caches = p.jdecode(p.jparams, tok, caches,
                                   jnp.int32(PROMPT + i))
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_greedy_tokens_match_reference(f32_pair):
    p = f32_pair
    got = generate(p.model, p.params, torch.from_numpy(p.prompt),
                   ServeConfig(max_new_tokens=NEW), ctx=p.tctx)
    assert got.shape == (BATCH, NEW) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), _reference_greedy(p))
    eager = generate(p.model, p.params, torch.from_numpy(p.prompt),
                     ServeConfig(max_new_tokens=NEW), eager=True,
                     ctx=p.tctx)
    assert torch.equal(got, eager)


def test_loss_and_gradients_match_reference(f32_pair):
    """``Model.loss`` of a batch with a ``ctx`` and its gradients (the
    encoder's included) against ``jax.value_and_grad`` of the
    reference's."""
    p = f32_pair
    tokens = _tokens(p.cfg, seed=3)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda params, batch: p.jmodel.loss(params, batch, SINGLE_DEVICE),
        has_aux=True))(p.jparams, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels),
                                   "ctx": p.jctx})
    module = copy.deepcopy(p.params)
    names, leaves = zip(*module.named_parameters())
    for x in leaves:
        x.requires_grad_(True)
    loss, _ = p.model.loss(module, {"tokens": torch.from_numpy(tokens),
                                    "labels": torch.from_numpy(labels),
                                    "ctx": p.tctx})
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_TOL,
                               atol=LOSS_TOL)
    want = lm_grads_from_reference(jax.tree.map(np.asarray, jgrads), p.cfg,
                                   "cpu")
    assert {"encoder.0.mixer.wq", "ln_enc", "layers.1.cross.wk"} <= set(names)
    for name, g in zip(names, grads, strict=True):
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
        assert err <= GRAD_TOL, (name, err)


def test_context_moves_the_logits_and_decode_never_encodes(f32_pair):
    """Another context moves the prefill's logits; a decode step reads the
    context only through the caches: with every encoder weight NaN after
    the prefill, its logits are the same bits."""
    p = f32_pair
    a, _ = p.prefill()
    b, _ = p.prefill(ctx=torch.from_numpy(_ctx(p.cfg, seed=5)))
    assert float((a - b).abs().max()) > 1e-3
    caches = p.model.init_cache(BATCH, PROMPT + 1, "cpu")
    p.prefill(caches=caches)
    again = [blocks.SelfCrossCache(*(x.clone() for x in c)) for c in caches]
    tok = torch.from_numpy(_tokens(p.cfg, s=1, seed=9))
    want, _ = p.model.decode_step(p.params, tok, caches, PROMPT)
    broken = copy.deepcopy(p.params)
    with torch.no_grad():
        for x in (*broken.encoder.parameters(), broken.ln_enc):
            x.fill_(float("nan"))
    got, _ = p.model.decode_step(broken, tok, again, PROMPT)
    assert torch.equal(got, want)


def test_prefill_without_a_ctx_raises():
    """``Model.prefill`` without a context, and the serve launcher (which
    makes none), raise ``ValueError`` naming the family."""
    model = get_model(configs.get_smoke_config(ARCH))
    params = model.init_params(device="cpu")
    with pytest.raises(ValueError, match="'encdec' family"):
        model.prefill(params, torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs a ctx"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
