"""The port's SSM, MoE and hybrid language models against the JAX
reference on the CPU, through prefill, decode, ``generate`` and the loss,
and the hybrid's layer pattern.

For each of the ``mamba2-780m``, ``qwen2-moe-a2.7b`` and
``jamba-1.5-large-398b`` smoke configs the reference materialises the
weights from ``PRNGKey(0)`` and the port takes them through
``convert.lm_params_from_reference`` (every segment, or the hybrid's
groups); prompts come from numpy: 2 x 40 tokens (a chunk of 32 and a
padded one for the SSD mixers).  Each reference function is jitted once
for the module.  The attention layers take the flash path (the
reference's Pallas kernel in interpret mode, the port's plain version).

Tolerances: fp32 logits and caches 1e-4 (tests/test_torch_lm.py's), bf16
8e-2 (tests/test_models_smoke.py:100); greedy tokens equal (fp32); the
loss and its aux term 1e-5, gradients 1e-4 of each leaf's max |g|.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.distributed.sharding import SINGLE_DEVICE
from repro.models import hybrid as jhybrid
from repro.models import params as jpm
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import (
    _layer_node, lm_grads_from_reference, lm_params_from_reference,
)
from repro_torch.models import get_model, hybrid, lm
from repro_torch.models.layers import padded_vocab
from repro_torch.serving.engine import ServeConfig, generate

ARCHS = ["mamba2-780m", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"]
IDS = ["ssm", "moe", "hybrid"]
F32 = dict(param_dtype="float32", compute_dtype="float32",
           flash_attention=True)
TOL, BF16_TOL, LOSS_TOL, GRAD_TOL = 1e-4, 8e-2, 1e-5, 1e-4
BATCH, PROMPT, NEW = 2, 40, 8


def _prompt(cfg, s=PROMPT, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (BATCH, s)).astype(np.int32)


class Pair:
    """The reference's and the port's model, parameters and jitted
    functions for one smoke config in fp32 or bf16."""

    def __init__(self, arch: str, kind: str):
        kw = F32 if kind == "f32" else dict(flash_attention=True)
        self.kind = kind
        self.tol = TOL if kind == "f32" else BF16_TOL
        jcfg = jconfigs.get_smoke_config(arch).replace(**kw)
        self.jmodel = jmodels.get_model(jcfg)
        self.jparams = jpm.materialize(self.jmodel.specs(),
                                       jax.random.PRNGKey(0))
        self.cfg = configs.get_smoke_config(arch).replace(**kw)
        self.model = get_model(self.cfg)
        self.params = lm_params_from_reference(
            jax.tree.map(np.asarray, self.jparams), self.cfg, "cpu")
        self.prompt = _prompt(self.cfg)
        plan = (hybrid.layer_plan(self.cfg) if self.cfg.family == "hybrid"
                else lm.layer_plan(self.cfg))
        #: Layers whose inputs pass no router: up to the first MoE layer,
        #: whose own mixer cache comes before its FFN.
        self.unrouted = next((i + 1 for i, (_, f) in enumerate(plan)
                              if f == "moe"), len(plan))
        self.jprefill = jax.jit(lambda p, t: self.jmodel.prefill(
            p, {"tokens": t}, SINGLE_DEVICE))
        self.jdecode = jax.jit(lambda p, t, c, pos: self.jmodel.decode_step(
            p, t, c, pos, SINGLE_DEVICE))

    def ref_layer_caches(self, jcaches) -> list[tuple[np.ndarray, ...]]:
        """The reference's caches (stacked by segment or group) as one
        tuple of arrays a layer, in the port's layer order."""
        key = "groups" if self.cfg.family == "hybrid" else "segments"
        out = []
        for layer in range(self.cfg.n_layers):
            node, i = _layer_node({key: jcaches}, self.cfg, layer)
            out.append(tuple(np.asarray(x, np.float32)[i]
                             for x in node["mixer"]))
        return out

    def assert_caches_close(self, caches, jcaches, start=0, upto=None):
        """Every layer's cache leaves (the first ``upto``) within the
        tolerance: K/V from sequence position ``start`` on, an SSM state
        whole."""
        for got, want in list(zip(caches, self.ref_layer_caches(jcaches),
                                  strict=True))[:upto]:
            kv = type(got) is tuple
            for g, w in zip(got, want, strict=True):
                g = g.to(torch.float32).numpy()
                if kv:
                    g, w = g[:, start:], w[:, start:]
                np.testing.assert_allclose(g, w, rtol=self.tol,
                                           atol=self.tol)


def _clone(cache):
    leaves = [x.clone() for x in cache]
    return tuple(leaves) if type(cache) is tuple else type(cache)(*leaves)


_PAIRS: dict = {}


@pytest.fixture(scope="module", params=[(a, k) for a in ARCHS
                                        for k in ("f32", "bf16")],
                ids=[f"{i}-{k}" for i in IDS for k in ("f32", "bf16")])
def pair(request):
    return _pair(*request.param)


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def f32_pair(request):
    return _pair(request.param, "f32")


def _pair(arch, kind):
    if (arch, kind) not in _PAIRS:
        _PAIRS[arch, kind] = Pair(arch, kind)
    return _PAIRS[arch, kind]


def test_prefill_matches_reference(pair):
    """Last-position logits and the layers' caches: the prompt's K/V for
    attention, the conv tail and the SSM state for SSD.  In bf16 the
    caches after a MoE layer are not compared: the two frameworks round
    the residual stream differently by an ulp, which moves a token whose
    top-k probabilities nearly tie to another expert, and its K/V in later
    layers then differs by far more than bf16 rounding (in fp32 every
    layer's cache is held)."""
    jlogits, jcaches = pair.jprefill(pair.jparams, jnp.asarray(pair.prompt))
    logits, caches = pair.model.prefill(pair.params,
                                        torch.from_numpy(pair.prompt))
    assert logits.shape == (BATCH, padded_vocab(pair.cfg.vocab))
    assert logits.dtype == pair.cfg.cdtype
    np.testing.assert_allclose(logits.to(torch.float32).numpy(),
                               np.asarray(jlogits, np.float32),
                               rtol=pair.tol, atol=pair.tol)
    pair.assert_caches_close(caches, jcaches, upto=None
                             if pair.kind == "f32" else pair.unrouted)


def test_greedy_tokens_match_reference(f32_pair):
    p = f32_pair
    want = jengine.generate(p.jmodel, p.jparams, jnp.asarray(p.prompt),
                            SINGLE_DEVICE,
                            jengine.ServeConfig(max_new_tokens=NEW))
    got = generate(p.model, p.params, torch.from_numpy(p.prompt),
                   ServeConfig(max_new_tokens=NEW))
    assert got.shape == (BATCH, NEW) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))
    eager = generate(p.model, p.params, torch.from_numpy(p.prompt),
                     ServeConfig(max_new_tokens=NEW), eager=True)
    assert torch.equal(got, eager)


def test_decode_at_a_tensor_position_matches_reference(f32_pair):
    """Two decode steps at a 0-d int32 position into caches of s_max =
    prompt + 2 (the reference's padded caches): the logits, and every
    cache updated in place (K/V at the new positions, the SSM states
    whole), within the tolerance; the same bits as an int position."""
    p = f32_pair
    s_max = PROMPT + 2
    _, jcaches = p.jprefill(p.jparams, jnp.asarray(p.prompt))
    jcaches = jengine._pad_caches(p.jmodel, jcaches, BATCH, PROMPT, s_max)
    caches = p.model.init_cache(BATCH, s_max, "cpu")
    p.model.prefill(p.params, torch.from_numpy(p.prompt), caches)
    bufs = [tuple(c) for c in caches]
    by_int = [_clone(c) for c in caches]
    tok = _prompt(p.cfg, s=2, seed=9)
    for step in range(2):
        pos = PROMPT + step
        jlogits, jcaches = p.jdecode(p.jparams,
                                     jnp.asarray(tok[:, step:step + 1]),
                                     jcaches, jnp.int32(pos))
        t = torch.from_numpy(tok[:, step:step + 1])
        logits, caches = p.model.decode_step(
            p.params, t, caches, torch.tensor(pos, dtype=torch.int32))
        plain, by_int = p.model.decode_step(p.params, t, by_int, pos)
        assert torch.equal(logits, plain)
        np.testing.assert_allclose(logits.numpy(),
                                   np.asarray(jlogits, np.float32),
                                   rtol=TOL, atol=TOL)
    for cache, buf, other in zip(caches, bufs, by_int, strict=True):
        assert all(a is b for a, b in zip(cache, buf, strict=True))
        assert all(torch.equal(a, b) for a, b in zip(cache, other,
                                                     strict=True))
    p.assert_caches_close(caches, jcaches, start=PROMPT)


def test_loss_and_gradients_match_reference(f32_pair):
    """``Model.loss`` (cross-entropy plus the routers' aux term) and its
    gradients against ``jax.value_and_grad`` of the reference's loss."""
    p = f32_pair
    tokens = _prompt(p.cfg, seed=3)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1

    def ref_loss(params, batch):
        return p.jmodel.loss(params, batch, SINGLE_DEVICE)

    (jloss, jmets), jgrads = jax.jit(jax.value_and_grad(
        ref_loss, has_aux=True))(p.jparams, {"tokens": jnp.asarray(tokens),
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
    if p.cfg.moe is not None:
        assert mets["aux"].item() > 0
    want = lm_grads_from_reference(jax.tree.map(np.asarray, jgrads), p.cfg,
                                   "cpu")
    for name, g in zip(names, grads, strict=True):
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max()) / scale
        assert err <= GRAD_TOL, (name, err)


# ---------------------------------------------------------------------------
# Building the families
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_get_model_builds_the_full_and_smoke_configs(arch):
    """The full config's parameters (on the meta device: jamba's 398B
    are not allocated) and the smoke config's: the reference's parameter
    count, and each layer's cache kind."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        cfg, jcfg = get(arch), jget(arch)
        model = get_model(cfg)
        params = model.empty_params("meta")
        assert sum(x.numel() for x in params.parameters()) == \
            jpm.count_params(jmodels.get_model(jcfg).specs())
        caches = model.init_cache(2, 8, "meta")
        assert len(caches) == cfg.n_layers
        kinds = {type(c).__name__ for c in caches}
        want = {"ssm": {"SSMState"}, "moe": {"tuple"},
                "hybrid": {"SSMState", "tuple"}}[cfg.family]
        assert kinds == want


@pytest.mark.parametrize("get", [configs.get_config,
                                 configs.get_smoke_config],
                         ids=["full", "smoke"])
def test_hybrid_pattern_matches_reference(get):
    """Jamba's (mixer, ffn) pattern inside a period group, and the port's
    flat layer order: layer L is group L // period, position L % period."""
    cfg = get("jamba-1.5-large-398b")
    jcfg = dict(full=jconfigs.get_config,
                smoke=jconfigs.get_smoke_config)[
        "full" if get is configs.get_config else "smoke"](
            "jamba-1.5-large-398b")
    assert hybrid._pattern(cfg) == jhybrid._pattern(jcfg)
    assert hybrid._n_groups(cfg) == jhybrid._n_groups(jcfg)
    plan = hybrid.layer_plan(cfg)
    assert len(plan) == cfg.n_layers
    assert all(plan[layer] == jhybrid._pattern(jcfg)[layer % cfg.attn_period]
               for layer in range(cfg.n_layers))
    if get is configs.get_config:
        assert [i for i, (m, _) in enumerate(plan) if m == "attn"][:2] == \
            [4, 12]
        assert sum(f == "moe" for _, f in plan) == cfg.n_layers // 2


def test_the_serve_launcher_runs_each_family_on_the_cpu(capsys):
    from repro_torch.launch import serve

    for arch in ARCHS:
        out = serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "8",
                          "--new-tokens", "3", "--flash-attention"])
        assert out["tokens_per_s"] > 0
        assert capsys.readouterr().out.startswith("generated (2, 3) in ")


def test_jamba_cut_keeps_its_widths_and_layer_kinds():
    """The card's cut of jamba (two layers, period 2): one SSD + MLP layer
    and one attention + MoE layer at the full widths."""
    full = configs.get_config("jamba-1.5-large-398b")
    cut = full.replace(n_layers=2, attn_period=2)
    assert hybrid.layer_plan(cut) == [("ssm", "mlp"), ("attn", "moe")]
    params = get_model(cut).empty_params("meta")
    ffn = params.layers[1].ffn
    assert tuple(ffn.w_gate.shape) == (16, 8192, 24576)
    assert tuple(params.layers[0].mixer.w_x.shape) == (8192, 16384)
    assert dataclasses.asdict(cut.moe) == dataclasses.asdict(full.moe)
