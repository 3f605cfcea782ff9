"""The port's VLM (llama-3.2-vision: gated cross-attention layers between
self-attention layers) against the JAX reference on the CPU, through
prefill, decode, greedy generation and the loss.

The reference materialises the smoke config's weights from ``PRNGKey(0)``
(4 layers: 2 groups of one self and one cross layer; a context of 16
patches) and the port takes them through
``convert.lm_params_from_reference``.  The reference initialises each
cross layer's ``gate`` to 0, and ``tanh(0) = 0`` would hide every fault of
the cross path, so both packages run with the gates set to (0.5, -0.7)
in the reference's tree before it crosses.  Prompts (2 x 24 tokens) and
the context (2 x 16 x d_model, standard normal) come from numpy.  The
self layers take the flash path (the reference's Pallas kernel in
interpret mode, the port's plain version); the cross layers are plain in
both.  The reference's ``generate`` passes no context, so the port's
``generate(..., ctx=)`` is held to the reference's prefill and decode
steps driven with argmax (the body of its ``generate`` at temperature 0).

Tolerances: fp32 logits and caches 1e-4 (tests/test_torch_lm.py's), bf16
8e-2 (tests/test_models_smoke.py:100); greedy tokens equal (fp32); the
loss 1e-5, gradients 1e-5 of each leaf's max |g|.
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
from repro.models import params as jpm
from repro.models import vision as jvision
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import (
    _layer_node, lm_grads_from_reference, lm_params_from_reference,
)
from repro_torch.launch import serve
from repro_torch.models import get_model, vision
from repro_torch.serving.engine import ServeConfig, generate

ARCH = "llama-3.2-vision-11b"
F32 = dict(param_dtype="float32", compute_dtype="float32",
           flash_attention=True)
TOL, BF16_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 8e-2, 1e-5, 1e-5
BATCH, PROMPT, NEW, STEPS = 2, 24, 6, 3
GATES = (0.5, -0.7)


def _tokens(cfg, s=PROMPT, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, s)).astype(np.int32)


def _ctx(cfg, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, cfg.cross.n_context_tokens, cfg.d_model)).astype(np.float32)


def _with_gates(jparams, gates):
    """The reference's tree with every group's cross ``gate`` set."""
    out = jax.tree.map(lambda x: x, jparams)
    out["groups"]["cross"]["gate"] = jnp.asarray(gates, jnp.float32)
    return out


class Pair:
    """The reference's and the port's VLM smoke model (gates nonzero),
    weights, inputs and jitted functions in fp32 or bf16."""

    def __init__(self, kind: str):
        kw = F32 if kind == "f32" else dict(flash_attention=True)
        self.kind = kind
        self.tol = TOL if kind == "f32" else BF16_TOL
        jcfg = jconfigs.get_smoke_config(ARCH).replace(**kw)
        self.jmodel = jmodels.get_model(jcfg)
        self.jparams = _with_gates(
            jpm.materialize(self.jmodel.specs(), jax.random.PRNGKey(0)),
            GATES)
        self.cfg = configs.get_smoke_config(ARCH).replace(**kw)
        self.model = get_model(self.cfg)
        self.params = lm_params_from_reference(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        self.prompt = _tokens(self.cfg)
        self.ctx = _ctx(self.cfg)
        self.jctx = jnp.asarray(self.ctx).astype(jcfg.cdtype)
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
        """Every layer's cache: a self layer's K/V from sequence position
        ``start`` on, a cross layer's context K/V whole."""
        for layer, got in enumerate(caches):
            node, i = _layer_node({"groups": jcaches}, self.cfg, layer)
            cross = isinstance(i, int)
            for g, w in zip(got, node["mixer"], strict=True):
                g = g.to(torch.float32).numpy()
                w = np.asarray(w, np.float32)[i]
                if not cross:
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


@pytest.mark.parametrize("get", ["get_config", "get_smoke_config"])
def test_layer_plan_matches_the_reference_groups(get):
    """Layer L is group L // k, position L % k; the cross layer closes
    each group (full width: 8 groups of 4 self layers and 1 cross)."""
    cfg = getattr(configs, get)(ARCH)
    n_groups, n_self = jvision._group_shape(getattr(jconfigs, get)(ARCH))
    plan = vision.layer_plan(cfg)
    assert len(plan) == cfg.n_layers == n_groups * (n_self + 1)
    cross = [i for i, (m, _) in enumerate(plan) if m == "cross"]
    assert cross == [g * (n_self + 1) + n_self for g in range(n_groups)]
    if get == "get_config":
        assert (n_groups, n_self) == (8, 4)


def test_prefill_matches_reference(pair):
    """Last-position logits and every layer's cache: the prompt's K/V for
    the self layers, the context's K/V (B, T, KV, hd) for the cross ones."""
    jlogits, jcaches = pair.jprefill(pair.jparams, jnp.asarray(pair.prompt),
                                     pair.jctx)
    logits, caches = pair.prefill()
    cfg = pair.cfg
    assert tuple(caches[1][0].shape) == (
        BATCH, cfg.cross.n_context_tokens, cfg.n_kv_heads, cfg.hd)
    np.testing.assert_allclose(logits.to(torch.float32).numpy(),
                               np.asarray(jlogits, np.float32),
                               rtol=pair.tol, atol=pair.tol)
    pair.assert_caches_close(caches, jcaches)


def test_decode_steps_match_reference(pair):
    """Three decode steps at a 0-d int32 position into caches of s_max =
    prompt + 3: the logits of each; the self K/V written in place at the
    new positions, the cross K/V left as the prefill wrote them (the
    same bytes)."""
    s_max = PROMPT + NEW  # the greedy test's, so one decode compile
    _, jcaches = pair.jprefill(pair.jparams, jnp.asarray(pair.prompt),
                               pair.jctx)
    jcaches = jengine._pad_caches(pair.jmodel, jcaches, BATCH, PROMPT, s_max)
    caches = pair.model.init_cache(BATCH, s_max, "cpu")
    pair.prefill(caches=caches)
    cross_before = [c[0].clone() for c in caches[1::2]]
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
    assert all(torch.equal(a, c[0])
               for a, c in zip(cross_before, caches[1::2], strict=True))
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
    gates' included) against ``jax.value_and_grad`` of the reference's."""
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
    assert "layers.1.gate" in names
    for name, g in zip(names, grads, strict=True):
        w = want[name].numpy()
        err = float(np.abs(g.numpy() - w).max()) / max(
            float(np.abs(w).max()), 1e-30)
        assert err <= GRAD_TOL, (name, err)


def test_context_moves_the_logits_only_through_a_nonzero_gate(f32_pair):
    """With the gates at (0.5, -0.7) another context moves the logits;
    with the reference's initial gates (0) the logits are the same bits
    whatever the context."""
    p = f32_pair
    other = torch.from_numpy(_ctx(p.cfg, seed=5))
    a, _ = p.prefill()
    b, _ = p.prefill(ctx=other)
    assert float((a - b).abs().max()) > 1e-3
    closed = copy.deepcopy(p.params)
    with torch.no_grad():
        for layer in closed.layers[1::2]:
            layer.gate.zero_()
    a, _ = p.prefill(params=closed)
    b, _ = p.prefill(params=closed, ctx=other)
    assert torch.equal(a, b)


def test_prefill_without_a_ctx_raises():
    """``Model.prefill`` without a context, and the serve launcher (which
    makes none), raise ``ValueError`` naming the family."""
    cfg = configs.get_smoke_config(ARCH)
    model = get_model(cfg)
    params = model.init_params(device="cpu")
    assert float(params.layers[1].gate) == 0.0
    assert params.layers[1].gate.dtype == torch.float32
    with pytest.raises(ValueError, match="'vlm' family"):
        model.prefill(params, torch.zeros(1, 4, dtype=torch.int32))
    with pytest.raises(ValueError, match="needs a ctx"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
