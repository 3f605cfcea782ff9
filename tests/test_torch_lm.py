"""The port's dense LM serving path against the JAX reference on the CPU.

The reference materialises the ``llama3-8b`` smoke config's weights (2
layers, d_model 128, 4 heads, 2 KV heads) and the port takes them through
``convert.lm_params_from_reference``; prompts come from numpy.  Both sides
run with ``flash_attention=True`` (the reference's Pallas kernel in
interpret mode, the port's plain version).

Tolerances: rtol = atol = 1e-4 on fp32 logits and caches (fp32 sums over
d_model = 128 in another order, and the attention tolerance of
tests/test_torch_flash.py); 8e-2 in bf16 (tests/test_models_smoke.py:100,
bf16 rounding of every activation in two frameworks); greedy tokens equal.
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.distributed.sharding import SINGLE_DEVICE
from repro.models import params as jpm
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.models import blocks, get_model
from repro_torch.models.layers import padded_vocab
from repro_torch.models.params import ParamSpec, Params, materialize
from repro_torch.serving.engine import ServeConfig, generate

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3-8b"
F32 = dict(param_dtype="float32", compute_dtype="float32",
           flash_attention=True)
TOL, BF16_TOL = 1e-4, 8e-2
BATCH, PROMPT, NEW = 2, 16, 8


def _prompt(cfg, b=BATCH, s=PROMPT, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _pair(kind: str):
    """(kind, reference model, its params, port model, port params, prompt)
    at the smoke config in fp32 or bf16, flash attention on."""
    kw = F32 if kind == "f32" else dict(flash_attention=True)
    jcfg = jconfigs.get_smoke_config(ARCH).replace(**kw)
    jmodel = jmodels.get_model(jcfg)
    jparams = jpm.materialize(jmodel.specs(), jax.random.PRNGKey(0))
    cfg = configs.get_smoke_config(ARCH).replace(**kw)
    params = lm_params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return kind, jmodel, jparams, get_model(cfg), params, _prompt(cfg)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def f32_pair():
    return _pair("f32")


def test_prefill_matches_reference(pair):
    kind, jmodel, jparams, model, params, prompt = pair
    jlogits, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                      SINGLE_DEVICE)
    logits, caches = model.prefill(params, torch.from_numpy(prompt).long())
    tol = TOL if kind == "f32" else BF16_TOL
    assert logits.shape == (BATCH, padded_vocab(model.cfg.vocab))
    assert logits.dtype == model.cfg.cdtype
    np.testing.assert_allclose(logits.to(torch.float32).numpy(),
                               np.asarray(jlogits, np.float32), rtol=tol,
                               atol=tol)
    jk, jv = jcaches[0]["mixer"]  # (L, B, S, KV, hd)
    for i, (k, v) in enumerate(caches):
        for mine, theirs in ((k, jk[i]), (v, jv[i])):
            np.testing.assert_allclose(mine.to(torch.float32).numpy(),
                                       np.asarray(theirs, np.float32),
                                       rtol=tol, atol=tol)


def test_greedy_tokens_match_reference(f32_pair):
    """In fp32 (bf16 logits are held within 8e-2 above)."""
    _, jmodel, jparams, model, params, prompt = f32_pair
    want = jengine.generate(jmodel, jparams, jnp.asarray(prompt),
                            SINGLE_DEVICE,
                            jengine.ServeConfig(max_new_tokens=NEW))
    got = generate(model, params, torch.from_numpy(prompt).long(),
                   ServeConfig(max_new_tokens=NEW))
    assert got.shape == (BATCH, NEW)
    assert got.dtype == torch.int32 and np.asarray(want).dtype == np.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_decode_at_a_tensor_position_matches_reference(pair):
    """Two decode steps with the position a 0-d int32 tensor (the
    reference's traced ``pos``, as the engine's captured step takes it):
    logits and the caches written at that position within the tolerances
    of the reference's decode_step, and the same bits as a Python int
    position."""
    kind, jmodel, jparams, model, params, prompt = pair
    tol = TOL if kind == "f32" else BF16_TOL
    s_max = PROMPT + 2
    _, jcaches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                SINGLE_DEVICE)
    jcaches = jengine._pad_caches(jmodel, jcaches, BATCH, PROMPT, s_max)
    caches = model.init_cache(BATCH, s_max, "cpu")
    model.prefill(params, torch.from_numpy(prompt).long(), caches)
    by_int = [tuple(x.clone() for x in c) for c in caches]
    tok = _prompt(model.cfg, s=2, seed=9)
    for step in range(2):
        pos = PROMPT + step
        jlogits, jcaches = jmodel.decode_step(
            jparams, jnp.asarray(tok[:, step:step + 1]), jcaches,
            jnp.int32(pos), SINGLE_DEVICE)
        t = torch.from_numpy(tok[:, step:step + 1]).long()
        logits, caches = model.decode_step(
            params, t, caches, torch.tensor(pos, dtype=torch.int32))
        plain, by_int = model.decode_step(params, t, by_int, pos)
        assert torch.equal(logits, plain)
        np.testing.assert_allclose(logits.to(torch.float32).numpy(),
                                   np.asarray(jlogits, np.float32),
                                   rtol=tol, atol=tol)
    # The reference stacks its layers' caches: ((L, B, S, KV, hd), ...).
    jk_all, jv_all = jcaches[0]["mixer"]
    for (k, v), jk, jv, (ik, iv) in zip(caches, jk_all, jv_all, by_int,
                                        strict=True):
        assert torch.equal(k, ik) and torch.equal(v, iv)
        for got, want in ((k, jk), (v, jv)):
            np.testing.assert_allclose(
                got[:, PROMPT:].to(torch.float32).numpy(),
                np.asarray(want, np.float32)[:, PROMPT:], rtol=tol,
                atol=tol)


def test_engine_steps_one_decode_function_on_the_cpu(f32_pair):
    """On the CPU ``generate`` runs the step it captures on the card,
    eagerly: eager=True changes nothing there, and greedy tokens are the
    reference's for a longer run."""
    _, jmodel, jparams, model, params, prompt = f32_pair
    scfg = ServeConfig(max_new_tokens=12)
    want = jengine.generate(jmodel, jparams, jnp.asarray(prompt),
                            SINGLE_DEVICE,
                            jengine.ServeConfig(max_new_tokens=12))
    got = generate(model, params, torch.from_numpy(prompt).long(), scfg)
    eager = generate(model, params, torch.from_numpy(prompt).long(), scfg,
                     eager=True)
    assert torch.equal(got, eager)
    assert got.dtype == eager.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_full_forward(dtype, flash):
    """Prefill s-1 tokens, decode token s-1: the logits of the prefill over
    all s tokens (tests/test_models_smoke.py:63-105, on the port alone)."""
    cfg = configs.get_smoke_config(ARCH).replace(
        param_dtype=dtype, compute_dtype=dtype, flash_attention=flash)
    model = get_model(cfg)
    params = model.init_params(seed=0, device="cpu")
    tokens = torch.from_numpy(_prompt(cfg, s=33, seed=2)).long()
    full, _ = model.prefill(params, tokens)
    caches = model.init_cache(BATCH, 33, "cpu")
    model.prefill(params, tokens[:, :32], caches)
    dec, _ = model.decode_step(params, tokens[:, 32:], caches, 32)
    tol = TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(dec.to(torch.float32).numpy(),
                               full.to(torch.float32).numpy(), rtol=tol,
                               atol=tol)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


def test_flash_and_chunked_prefill_agree():
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    model = get_model(cfg)
    params = model.init_params(seed=3, device="cpu")
    tokens = torch.from_numpy(_prompt(cfg)).long()
    flash, _ = model.prefill(params, tokens)
    chunked, _ = get_model(cfg.replace(flash_attention=False)).prefill(
        params, tokens)
    np.testing.assert_allclose(flash.numpy(), chunked.numpy(), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------
def test_model_config_fields_and_defaults_match_reference():
    from repro.configs import base as jbase
    from repro_torch.configs import base

    for name in ("ModelConfig", "MoEConfig", "MLAConfig", "SSMConfig",
                 "CrossAttnConfig", "EncDecConfig", "ShapeSpec"):
        mine = [(f.name, f.default) for f in
                dataclasses.fields(getattr(base, name))]
        theirs = [(f.name, f.default) for f in
                  dataclasses.fields(getattr(jbase, name))]
        assert mine == theirs, name
    assert {k: dataclasses.astuple(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.SHAPES.items()}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_every_config_matches_reference(arch):
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        mine, theirs = get(arch), jget(arch)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.hd == theirs.hd
        assert mine.pdtype == getattr(torch, theirs.pdtype.name)
        assert mine.cdtype == getattr(torch, theirs.cdtype.name)
        for shape in jconfigs.SHAPES.values():
            assert configs.supports_shape(mine, shape) == \
                jconfigs.supports_shape(theirs, shape)


@pytest.mark.parametrize("arch", [
    a for a in jconfigs.ARCH_IDS
    if jconfigs.get_config(a).family in ("vlm", "encdec")
    or jconfigs.get_config(a).mla is not None])
def test_other_families_raise_when_built(arch):
    """The MLA and cross-attention families (deepseek-v2,
    llama-3.2-vision, whisper) build without raising: the full config's
    parameters (on the meta device) count the reference's, and the smoke
    config runs a prefill (with a context where the family takes one)
    to finite logits (tests/test_torch_mla.py, test_torch_vlm.py and
    test_torch_encdec.py hold them to the reference)."""
    for get, jget in ((configs.get_config, jconfigs.get_config),
                      (configs.get_smoke_config, jconfigs.get_smoke_config)):
        params = get_model(get(arch)).empty_params("meta")
        assert sum(x.numel() for x in params.parameters()) == \
            jpm.count_params(jmodels.get_model(jget(arch)).specs())
    cfg = configs.get_smoke_config(arch)
    model = get_model(cfg)
    params = model.init_params(device="cpu")
    ctx = None
    if cfg.family in ("vlm", "encdec"):
        t = (cfg.cross or cfg.encdec).n_context_tokens
        ctx = torch.randn(1, t, cfg.d_model,
                          generator=torch.Generator().manual_seed(0))
    logits, caches = model.prefill(params, torch.from_numpy(
        _prompt(cfg, 1, 8)), ctx=ctx)
    assert logits.shape == (1, padded_vocab(cfg.vocab))
    assert torch.isfinite(logits.float()).all()
    assert len(caches) == cfg.n_layers


def test_train_mode_and_other_mixers_raise():
    """The MLA and cross-attention mixers build and run a training layer;
    an unknown mixer raises ``ValueError``, as in the reference;
    ``Model.loss`` and ``mode="train"`` run (ROADMAP.md Queue 1 item 7)."""
    cfg = configs.get_smoke_config(ARCH)
    with pytest.raises(ValueError, match="unknown mixer"):
        blocks.layer_specs(cfg, mixer="rnn")
    mla_cfg = configs.get_smoke_config("deepseek-v2-236b")
    for mixer, c in (("mla", mla_cfg), ("cross", cfg)):
        layer = materialize(Params(blocks.layer_specs(c, mixer=mixer),
                                   "cpu"), torch.Generator().manual_seed(0))
        x = torch.ones(1, 2, c.d_model, dtype=c.cdtype)
        y, aux, kv = blocks.layer_apply(
            layer, x, cfg=c, mode="train", mixer=mixer,
            positions=torch.arange(2)[None],
            ctx=torch.ones(1, 3, c.d_model, dtype=c.cdtype))
        assert y.shape == x.shape and torch.isfinite(y.float()).all()
        assert kv is None and aux.item() == 0.0
    model = get_model(cfg)
    params = model.init_params(device="cpu")
    tokens = torch.from_numpy(_prompt(cfg, 1, 8))
    loss, mets = model.loss(params, {"tokens": tokens, "labels": tokens})
    assert torch.isfinite(loss) and set(mets) == {"ce", "aux"}
    x, aux, kv = blocks.layer_apply(params.layers[0],
                                    torch.zeros(1, 2, cfg.d_model,
                                                dtype=cfg.cdtype),
                                    cfg=cfg, mode="train",
                                    positions=torch.arange(2)[None])
    assert x.shape == (1, 2, cfg.d_model) and kv is None
    assert aux.item() == 0.0


def test_refusals_name_the_roadmap_item():
    """Nothing of the LM stack refuses any more: no ``not_ported`` is left,
    deepseek-v2's MLA stack builds, and training (item 7) refuses nothing:
    ``Model.loss`` and ``mode="train"`` run."""
    assert not hasattr(blocks, "not_ported")
    assert not hasattr(blocks, "FAMILIES_ITEM")
    get_model(configs.get_smoke_config("deepseek-v2-236b")).specs()
    cfg = configs.get_smoke_config(ARCH)
    params = get_model(cfg).init_params(device="cpu")
    tokens = torch.from_numpy(_prompt(cfg, 1, 4))
    get_model(cfg).loss(params, {"tokens": tokens, "labels": tokens})
    blocks.layer_apply(params.layers[0], torch.zeros(1, 2, cfg.d_model,
                                                     dtype=cfg.cdtype),
                       cfg=cfg, mode="train",
                       positions=torch.arange(2)[None])


def test_decoded_tokens_feed_back_as_int32():
    """The embedding gathers at int32 indices (the tokens ``generate``
    feeds back) as at int64 ones: the same logits."""
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    model = get_model(cfg)
    params = model.init_params(seed=0, device="cpu")
    prompt = torch.from_numpy(_prompt(cfg))
    assert prompt.dtype == torch.int32
    a, _ = model.prefill(params, prompt)
    b, _ = model.prefill(params, prompt.long())
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Parameters and the launcher
# ---------------------------------------------------------------------------
def test_init_follows_reference_distribution():
    """Truncated normal at +-2 sigma times 1/sqrt(fan_in) (scale 1 for the
    embedding table), ones for the norms, one parameter count with the
    reference, and a seed gives the same weights twice."""
    cfg = configs.get_smoke_config("tinyllama-1.1b").replace(vocab=4096)
    model = get_model(cfg)
    params = model.init_params(seed=0, device="cpu")
    jcfg = jconfigs.get_smoke_config("tinyllama-1.1b").replace(vocab=4096)
    assert sum(p.numel() for p in params.parameters()) == jpm.count_params(
        jmodels.get_model(jcfg).specs())
    trunc_std = 0.87962566  # std of a standard normal truncated at +-2
    for w, scale in ((params.embed.table, 1.0),
                     (params.layers[0].ffn.w_down, cfg.d_ff ** -0.5),
                     (params.embed.unembed, cfg.d_model ** -0.5)):
        x = w.to(torch.float32)
        assert abs(x.std().item() / scale - trunc_std) < 0.02
        assert x.abs().max().item() <= 2.0 * scale * (1 + 2 ** -7)
    assert torch.equal(params.ln_f, torch.ones(cfg.d_model))
    again = model.init_params(seed=0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(params.parameters(), again.parameters()))


def test_param_spec_initializers():
    g = torch.Generator().manual_seed(0)
    assert torch.equal(ParamSpec((3,), torch.float32, "zeros").initializer(
        g, "cpu"), torch.zeros(3))
    v = ParamSpec((4000,), torch.float32).initializer(g, "cpu")
    assert v.abs().max().item() <= 2.0 / 4000 ** 0.5


def test_serve_launcher_runs_on_cpu(capsys):
    from repro_torch.launch import serve

    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "8", "--new-tokens",
                      "4", "--flash-attention"])
    assert out["tokens_per_s"] > 0
    printed = capsys.readouterr().out
    assert printed.startswith("generated (2, 4) in ")
    assert "first row:" in printed


def test_sampling_with_temperature_uses_the_generator():
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    model = get_model(cfg)
    params = model.init_params(seed=0, device="cpu")
    prompt = torch.from_numpy(_prompt(cfg)).long()
    runs = [generate(model, params, prompt, ServeConfig(max_new_tokens=4,
                                                        temperature=1.0),
                     generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert runs[0].dtype == torch.int32
    assert runs[0].max().item() < padded_vocab(cfg.vocab)
    eager = generate(model, params, prompt, ServeConfig(max_new_tokens=4,
                                                        temperature=1.0),
                     generator=torch.Generator().manual_seed(5), eager=True)
    assert torch.equal(eager, runs[0])


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, names JAX or the
    reference package in an import (test_torch_solve.py checks the loaded
    modules; this reads the sources)."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    offenders = [str(p) for p in files if pattern.search(p.read_text())]
    assert offenders == []
    assert len(files) >= 35
