"""The SSM, hybrid, MLA, VLM and encoder-decoder families served over a
model axis against the JAX reference on the CPU.

Pure tests: every one of the five families' shipped configs builds over
model = 2 on the meta device (one process, no process group), each
parameter a rank holds of the shape that the reference's ``spec_tree(...,
SINGLE_POD.resolve)`` and divisibility guard (``repro/models/params.py:
81-107``) give on a (1, 2) mesh, each cache the rank's part of the
single-device cache (attention and cross K/V by KV head, an SSD state by
head, MLA's latent whole); no shipped SSD or MLA config cuts a head or a
B/C group at t = 2, 4 or 8; the SSD mixer (``ssm.ssd(..., tp=)``, its
prefill and decode) on t simulated ranks (threads whose all-reduce adds
every rank's tensor) equals the single-rank mixer for t = 2 and 4 and 1,
2 or 4 B/C groups, where a gated norm over the rank's own slice would
not; and rules over a (1, 1) mesh are the single-device path, bit for
bit.

Ranks: one cohort of 2 gloo CPU processes (``multihost.launch_workers``)
serves the five smoke configs in fp32 on a (1, 2) mesh, with the
reference's weights through numpy (``convert.lm_params_from_reference(
..., rules=)``; the VLM's cross gates set to 0.5, so the context reaches
the logits; prompts of 40 tokens, so the SSD scan carries its state
across a chunk of 32).  The prefill's last logits, the ranks' caches
after the prefill and after 4 decode steps (each rank's part of the
reference's),
the 4 steps' logits and 6 greedy tokens are held to the reference's
single-device prefill and ``decode_step`` (argmax-driven for the tokens,
the reference's ``generate`` at temperature 0; it takes no context)
within fp32 1e-4 (tests/test_torch_lm.py's tolerance), the tokens
exactly; MLA's latent caches are equal on both ranks, bit for bit; and
each forward makes the all-reduces its layers need.
"""
import dataclasses
import json
import pickle
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.distributed.sharding import SINGLE_DEVICE, SINGLE_POD
from repro.models import params as jpm
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import _layer_node
from repro_torch.distributed import sharding
from repro_torch.models import CONTEXT_FAMILIES, get_model, lm, ssm
from repro_torch.models.attention import head_layout, mla_heads
from repro_torch.models.params import (
    Params, materialize, module_specs, shard_specs, shard_tensor,
)
from repro_torch.models.parallel import TensorParallel

TOL = 1e-4
BATCH, PROMPT, NEW, STEPS = 2, 40, 6, 4
RANKS = 2
GATE = 0.5
F32 = dict(param_dtype="float32", compute_dtype="float32",
           flash_attention=True)
ARCHS = ["mamba2-780m", "jamba-1.5-large-398b", "deepseek-v2-236b",
         "llama-3.2-vision-11b", "whisper-small"]
IDS = ["ssm", "hybrid", "mla", "vlm", "encdec"]


def _mesh(names, shape):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=torch.zeros(shape, dtype=torch.int64))


def _rules(t: int) -> sharding.ShardingRules:
    return sharding.rules_for_mesh(_mesh(("data", "model"), (1, t)))


def _meta_rules(monkeypatch, t: int, index: int):
    """Rules over a (1, t) mesh whose rank sits at model ``index``, for a
    build on the meta device in one process (no process group: nothing
    runs a collective)."""
    from repro_torch.distributed import multihost as mh

    monkeypatch.setattr(mh, "_axes_group", lambda mesh, axes: None)
    mesh = _mesh(("data", "model"), (1, t))
    mesh.get_coordinate = lambda: [0, index]
    return sharding.rules_for_mesh(mesh)


def _reference_leaf(tree, name: str, cfg):
    """The reference's leaf that port parameter ``name`` stands for, and
    the count of its stacked leading axes."""
    parts = name.split(".")
    if parts[0] in ("layers", "encoder"):
        node, index = (_layer_node(tree, cfg, int(parts[1]))
                       if parts[0] == "layers"
                       else (tree["encoder"], int(parts[1])))
        lead = len(index) if isinstance(index, tuple) else 1
        parts = parts[2:]
    else:
        node, lead = tree, 0
    for part in parts:
        node = node[part]
    return node, lead


def _cache_kinds(cfg) -> list[str]:
    """Each layer's cache kind: ``attn`` (self K/V), ``cross`` (context
    K/V), ``self_cross`` (a whisper decoder layer's four), ``mla`` or
    ``ssm``."""
    if cfg.family == "encdec":
        return ["self_cross"] * cfg.n_layers
    return [m for m, _ in get_model(cfg).layer_plan()]


def _rank_part(cfg, kind: str, leaves, rank: int, t: int = RANKS):
    """The part of one layer's whole cache ``leaves`` (arrays or tensors)
    that rank ``rank`` of ``t`` holds."""
    if kind == "mla":
        return list(leaves)
    if kind == "ssm":
        lay = ssm.head_split(cfg, t, rank)
        conv, state = leaves
        d_in = ssm._dims(cfg)[0]
        cat = np.concatenate if isinstance(conv, np.ndarray) else torch.cat
        conv = cat([conv[..., lay.channels(cfg.ssm.head_dim)],
                    conv[..., d_in:]], -1)
        return [conv, state[:, lay.h0:lay.h0 + lay.heads]]
    lay = head_layout(cfg, t, rank)
    heads = slice(lay.kv0, lay.kv0 + lay.kv_heads)
    return [x[:, :, heads] for x in leaves]


# ---------------------------------------------------------------------------
# Pure: the builds, the splits, the SSD mixer on simulated ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_family_builds_over_the_model_axis(arch, monkeypatch):
    """The shipped config over model = 2 on the meta device, at each rank:
    every parameter of the reference's per-rank shape (``spec_tree`` under
    ``SINGLE_POD`` and its divisibility guard), every cache the rank's part
    of the single-device cache."""
    cfg = configs.get_config(arch)
    jtree = jmodels.get_model(jconfigs.get_config(arch)).specs()
    pspecs = jpm.spec_tree(jtree, SINGLE_POD.resolve)
    model = get_model(cfg)
    sizes = {"data": 1, "model": RANKS}
    whole = model.init_cache(1, 8, "meta")
    kinds = _cache_kinds(cfg)
    split = 0
    for rank in range(RANKS):
        rules = _meta_rules(monkeypatch, RANKS, rank)
        for name, p in model.empty_params("meta", rules=rules
                                          ).named_parameters():
            ref, lead = _reference_leaf(jtree, name, cfg)
            pspec, _ = _reference_leaf(pspecs, name, cfg)
            want = []
            for size, axes in zip(ref.shape, pspec):
                names = (() if axes is None else (axes,)
                         if isinstance(axes, str) else tuple(axes))
                extent = int(np.prod([sizes[a] for a in names]))
                want.append(size // extent if size % extent == 0 else size)
            assert tuple(p.shape) == tuple(want[lead:]), name
            split += tuple(p.shape) != tuple(ref.shape[lead:])
        caches = model.init_cache(1, 8, "meta", rules=rules)
        for kind, got, full in zip(kinds, caches, whole, strict=True):
            want = _rank_part(cfg, kind, list(full), rank)
            assert [tuple(x.shape) for x in got] == [tuple(x.shape)
                                                    for x in want], kind
    assert split > 0


@pytest.mark.parametrize("t", [2, 4, 8])
def test_no_shipped_config_cuts_an_ssd_or_mla_head(t):
    """Every shipped SSD config splits its inner width into whole heads
    that hold whole B/C groups or lie inside one, and every MLA config
    its heads, at t = 2, 4 and 8."""
    seen = 0
    for arch in configs.ARCH_IDS:
        cfg = configs.get_config(arch)
        if cfg.ssm is not None:
            lay = ssm.head_split(cfg, t, t - 1)
            assert lay.split and lay.heads * t == ssm._dims(cfg)[1], arch
            seen += 1
        if cfg.mla is not None:
            assert mla_heads(cfg, t) * t == cfg.n_heads, arch
            seen += 1
    assert seen == 3


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_one_rank_is_the_single_device_path_bit_for_bit(arch):
    """Rules over a (1, 1) mesh give no tensor-parallel context: the
    prefill and a decode step are the single-device path's bits."""
    cfg = configs.get_smoke_config(arch).replace(**F32)
    model = get_model(cfg)
    rules = _rules(1)
    assert model.tensor_parallel(rules) is None
    params = model.init_params(seed=0, device="cpu", rules=rules)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab, (BATCH, 12), generator=gen)
    ctx = (torch.randn(BATCH, lm.ctx_len(cfg), cfg.d_model, generator=gen)
           if cfg.family in CONTEXT_FAMILIES else None)
    outs = []
    for kw in ({}, {"rules": rules}):
        caches = model.init_cache(BATCH, 13, "cpu", **kw)
        logits, caches = model.prefill(params, prompt, caches, ctx=ctx, **kw)
        step, _ = model.decode_step(params, prompt[:, :1], caches, 12, **kw)
        outs.append((logits, step))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


class _ThreadComm:
    """A model axis of ``size`` threads: ``all_reduce`` adds every
    thread's tensor, in rank order."""

    def __init__(self, size: int, index: int, board: dict):
        self.model_size, self.model_index, self.board = size, index, board
        self.calls = 0

    def all_reduce(self, x, over):
        assert over == "model"
        self.calls += 1
        self.board["parts"][self.model_index] = x.clone()
        self.board["barrier"].wait()
        out = self.board["parts"][0].clone()
        for i in range(1, self.model_size):
            out = out + self.board["parts"][i]
        self.board["barrier"].wait()
        return out


def _ssd_config(groups: int):
    """The mamba2 smoke config in fp32 with 8 heads of 32 and ``groups``
    B/C groups."""
    cfg = configs.get_smoke_config("mamba2-780m").replace(**F32)
    return cfg.replace(ssm=dataclasses.replace(cfg.ssm, head_dim=32,
                                               n_groups=groups))


def _ssd_params(cfg):
    """The mixer's whole weights (seed 0), its per-head vectors and norm
    scale drawn too, so that a rank taking another head's entry shows."""
    params = materialize(Params(ssm.ssm_specs(cfg), "cpu"),
                         torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for name in ("a_log", "dt_bias", "d_skip", "gate_norm"):
            p = getattr(params, name)
            p.copy_(0.5 * torch.randn(p.shape, generator=gen) + (
                1.0 if name == "gate_norm" else 0.0))
    return params


def _ssd_on_ranks(cfg, whole, t: int, h: torch.Tensor):
    """The prefill and one decode step of the SSD mixer on t simulated
    ranks, each holding its slices of ``whole``: every rank's outputs,
    states and all-reduce count."""
    board = dict(parts={}, barrier=threading.Barrier(t))
    outs = {}
    named = dict(whole.named_parameters())

    def rank(i):
        local = Params(shard_specs(ssm.ssm_specs(cfg), _rules(t),
                                   {"data": 0, "model": i}), "cpu")
        specs = module_specs(local)
        with torch.no_grad():
            for name, p in local.named_parameters():
                p.copy_(shard_tensor(named[name], specs[name]))
        comm = _ThreadComm(t, i, board)
        tp = TensorParallel(comm)
        out, state = ssm.ssd_prefill(local, h[:, :-1], cfg, tp)
        step, state = ssm.ssd_decode(local, h[:, -1:], state, cfg, tp)
        outs[i] = (out, step, state, comm.calls)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [outs[i] for i in range(t)]


@pytest.mark.parametrize("t,groups", [(2, 1), (2, 2), (2, 4), (4, 1),
                                      (4, 2)])
def test_ssd_on_simulated_ranks_is_the_single_rank_mixer(t, groups):
    """The SSD prefill and decode over t ranks equal one rank's within fp32
    1e-4: the same output on every rank, each rank's state its heads of
    the whole state (the conv state its x channels and B, C whole), two
    all-reduces a call (the norm's sum of squares, ``out_proj``); the
    prefill's 64 tokens are two chunks of 32, so the state crosses a
    chunk.  At (2, 4) a rank holds two whole groups, at (4, 2) a rank's
    heads lie inside one."""
    cfg = _ssd_config(groups)
    lay = ssm.head_split(cfg, t, 0)
    assert lay.heads == 8 // t and lay.groups == max(1, groups // t)
    whole = _ssd_params(cfg)
    h = torch.randn(BATCH, 65, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want_out, state = ssm.ssd_prefill(whole, h[:, :-1], cfg)
    want_step, state = ssm.ssd_decode(whole, h[:, -1:], state, cfg)
    ranks = _ssd_on_ranks(cfg, whole, t, h)
    for i, (out, step, got, calls) in enumerate(ranks):
        for g, w in ((out, want_out), (step, want_step),
                     *zip(got, _rank_part(cfg, "ssm", state, i, t))):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL,
                                       atol=TOL)
        assert torch.equal(out, ranks[0][0])
        assert torch.equal(step, ranks[0][1])
        assert calls == 4


def test_a_norm_over_the_ranks_slice_would_be_wrong(monkeypatch):
    """The gated RMSNorm spans the whole inner width: with each rank
    normalising its own slice (no all-reduce of the sum of squares) the
    mixer runs without error and gives other outputs, far past the
    tolerance that the port's norm meets."""
    from repro_torch.models.layers import rmsnorm

    cfg = _ssd_config(1)
    whole = _ssd_params(cfg)
    h = torch.randn(BATCH, 65, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want, _ = ssm.ssd_prefill(whole, h[:, :-1], cfg)

    def slice_norm(params, y, z, cfg, lay, tp):
        w = ssm._mine(params.gate_norm, lay, cfg.ssm.head_dim)
        y = rmsnorm(w, y * torch.nn.functional.silu(z), cfg.norm_eps)
        return tp.row_parallel(y, params.out_proj)

    monkeypatch.setattr(ssm, "_gated_out", slice_norm)
    wrong = _ssd_on_ranks(cfg, whole, 2, h)[0][0]
    assert (wrong - want).abs().max() > 100 * TOL


# ---------------------------------------------------------------------------
# Two gloo ranks against the reference
# ---------------------------------------------------------------------------
_WORKER = r"""
import json, os, pickle
import torch
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.models import get_model
from repro_torch.serving.engine import ServeConfig, generate

torch.set_num_threads(1)
env = json.loads(os.environ["TP_ENV"])
mesh = _mh.multihost_mesh(("data", "model"), (1, env["ranks"]), device="cpu")
rules = rules_for_mesh(mesh)
rank = _mh.MeshComm(mesh, ("data",), "model").model_index
for arch in env["archs"]:
    cfg = configs.get_smoke_config(arch).replace(**env["f32"])
    model = get_model(cfg)
    with open(os.path.join(env["dir"], f"{arch}.pkl"), "rb") as f:
        ref = pickle.load(f)
    params = lm_params_from_reference(ref["params"], cfg, "cpu", rules=rules)
    prompt = torch.from_numpy(ref["prompt"]).long()
    ctx = None if ref["ctx"] is None else torch.from_numpy(ref["ctx"])
    caches = model.init_cache(env["batch"], env["s_max"], "cpu", rules=rules)
    _mh.wire_counts(reset=True)
    logits, caches = model.prefill(params, prompt, caches, ctx=ctx,
                                   rules=rules)
    wire = _mh.wire_counts(reset=True)
    prefill_caches = [[x.clone() for x in c] for c in caches]
    steps = []
    for i in range(env["steps"]):
        tok = torch.from_numpy(ref["decode"][:, i:i + 1]).long()
        step, _ = model.decode_step(params, tok, caches,
                                    env["prompt"] + i, rules=rules)
        steps.append(step)
    step_wire = _mh.wire_counts(reset=True)
    tokens, info = generate(model, params, prompt,
                            ServeConfig(max_new_tokens=env["new"]), ctx=ctx,
                            rules=rules, return_info=True)
    torch.save(dict(logits=logits, prefill_caches=prefill_caches,
                    caches=[list(c) for c in caches],
                    steps=torch.stack(steps), tokens=tokens, info=info,
                    wire=wire, step_wire=step_wire),
               os.path.join(env["dir"], f"{arch}-{rank}.pt"))
"""


def _layer_caches(cfg, jcaches) -> list[list[np.ndarray]]:
    """The reference's caches as one list of arrays a layer, in the port's
    layer order and leaf order."""
    if cfg.family == "encdec":
        return [[np.asarray(x)[layer] for x in (*jcaches["mixer"],
                                                 *jcaches["cross"])]
                for layer in range(cfg.n_layers)]
    key = "groups" if cfg.family in ("hybrid", "vlm") else "segments"
    out = []
    for layer in range(cfg.n_layers):
        node, i = _layer_node({key: jcaches}, cfg, layer)
        out.append([np.asarray(x)[i] for x in node["mixer"]])
    return out


def _reference_inputs(arch: str, tmp):
    """The reference's model and params of one smoke config in fp32 (the
    VLM's cross gates set) and the inputs, pickled (numpy) for the
    ranks."""
    jmodel = jmodels.get_model(jconfigs.get_smoke_config(arch).replace(**F32))
    specs = jmodel.specs()
    jparams = jax.jit(lambda key: jpm.materialize(specs, key))(
        jax.random.PRNGKey(0))  # jitted: the same bits, a third less time
    if jmodel.cfg.family == "vlm":
        gates = jparams["groups"]["cross"]["gate"]
        jparams["groups"]["cross"]["gate"] = jnp.full_like(gates, GATE)
    cfg = configs.get_smoke_config(arch).replace(**F32)
    rng = np.random.default_rng(5)
    inputs = dict(
        prompt=rng.integers(0, cfg.vocab, (BATCH, PROMPT)).astype(np.int32),
        decode=rng.integers(0, cfg.vocab, (BATCH, STEPS)).astype(np.int32),
        ctx=(rng.standard_normal((BATCH, lm.ctx_len(cfg), cfg.d_model))
             .astype(np.float32) if cfg.family in CONTEXT_FAMILIES
             else None))
    with open(tmp / f"{arch}.pkl", "wb") as f:
        pickle.dump(dict(params=jax.tree.map(np.asarray, jparams),
                         **inputs), f)
    return cfg, jmodel, jparams, inputs


def _reference_run(cfg, jmodel, jparams, inputs) -> dict:
    """The reference's single-device run of one smoke config."""
    prompt, decode, ctx = inputs["prompt"], inputs["decode"], inputs["ctx"]
    batch = {"tokens": jnp.asarray(prompt)}
    if ctx is not None:
        batch["ctx"] = jnp.asarray(ctx)
    logits, caches = jax.jit(lambda p, b: jmodel.prefill(
        p, b, SINGLE_DEVICE))(jparams, batch)
    prefill_caches = _layer_caches(cfg, caches)
    padded = jengine._pad_caches(jmodel, caches, BATCH, PROMPT,
                                 PROMPT + NEW)
    jdecode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(
        p, t, c, pos, SINGLE_DEVICE))
    caches, steps = padded, []
    for i in range(STEPS):
        step, caches = jdecode(jparams, jnp.asarray(decode[:, i:i + 1]),
                               caches, jnp.int32(PROMPT + i))
        steps.append(np.asarray(step))
    # Greedy: the reference's generate at temperature 0, driven here since
    # its generate takes no context.
    tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
    tokens, greedy = [tok], padded
    for i in range(NEW - 1):
        step, greedy = jdecode(jparams, tok, greedy, jnp.int32(PROMPT + i))
        tok = jnp.argmax(step, axis=-1).astype(jnp.int32)[:, None]
        tokens.append(tok)
    return dict(logits=np.asarray(logits), prefill_caches=prefill_caches,
                caches=_layer_caches(cfg, caches), steps=np.stack(steps),
                tokens=np.asarray(jnp.concatenate(tokens, axis=1)), cfg=cfg)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{arch: (reference run, [rank 0's outputs, rank 1's])}: the ranks
    serve while the reference runs."""
    from repro_torch.distributed import multihost as mh

    tmp = tmp_path_factory.mktemp("tp_families")
    inputs = {arch: _reference_inputs(arch, tmp) for arch in ARCHS}
    env = dict(dir=str(tmp), ranks=RANKS, batch=BATCH, prompt=PROMPT,
               new=NEW, steps=STEPS, s_max=PROMPT + NEW, archs=ARCHS,
               f32=F32)
    failed = []

    def cohort():
        try:
            mh.launch_workers(_WORKER, num_processes=RANKS, backend="gloo",
                              timeout=300,
                              extra_env={"TP_ENV": json.dumps(env),
                                         "OMP_NUM_THREADS": "1"})
        except BaseException as e:  # re-raised below, in the test's thread
            failed.append(e)

    ranks = threading.Thread(target=cohort)
    ranks.start()
    try:
        refs = {arch: _reference_run(*inputs[arch]) for arch in ARCHS}
    finally:
        ranks.join()
    if failed:
        raise failed[0]
    return {arch: (refs[arch], [torch.load(tmp / f"{arch}-{r}.pt")
                                for r in range(RANKS)])
            for arch in ARCHS}


def _close(got, want):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


#: The cache leaves that run along the sequence (the prompt fills their
#: first positions), by cache kind.
_SEQUENCE_LEAVES = {"attn": 2, "mla": 2, "self_cross": 2, "cross": 0,
                    "ssm": 0}


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_prefill_logits_match_reference(arch, served):
    ref, outs = served[arch]
    for out in outs:
        assert out["logits"].shape == ref["logits"].shape
        _close(out["logits"], ref["logits"])
        assert out["info"] == {"decode": "eager",
                               "why": "not a CUDA device"}
    assert torch.equal(outs[0]["logits"], outs[1]["logits"])


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_caches_match_reference(arch, served):
    """Each rank's cache is its part of the reference's: after the
    prefill (a sequence cache's first PROMPT positions) and after 4
    decode steps (every position)."""
    ref, outs = served[arch]
    cfg = ref["cfg"]
    kinds = _cache_kinds(cfg)
    for rank, out in enumerate(outs):
        for key in ("prefill_caches", "caches"):
            for kind, got, want in zip(kinds, out[key], ref[key],
                                       strict=True):
                want = _rank_part(cfg, kind, want, rank)
                for j, (g, w) in enumerate(zip(got, want, strict=True)):
                    if key == "prefill_caches" \
                            and j < _SEQUENCE_LEAVES[kind]:
                        g = g[:, :PROMPT]
                    _close(g, w)


def test_mla_latent_caches_are_equal_on_the_ranks(served):
    """Every rank computes the latent whole and keeps the whole latent
    cache: both ranks' caches are the same bits."""
    _, outs = served["deepseek-v2-236b"]
    for key in ("prefill_caches", "caches"):
        for a, b in zip(outs[0][key], outs[1][key], strict=True):
            assert all(torch.equal(x, y) for x, y in zip(a, b, strict=True))


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_decode_logits_match_reference(arch, served):
    ref, outs = served[arch]
    for out in outs:
        _close(out["steps"], ref["steps"])


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_greedy_tokens_match_reference(arch, served):
    ref, outs = served[arch]
    for out in outs:
        assert out["tokens"].dtype == torch.int32
        assert np.array_equal(out["tokens"].numpy(), ref["tokens"])


def _all_reduces(cfg, prefill: bool) -> int:
    """The all-reduces of one forward: the embedding's, one for each
    split mixer (two for SSD: its norm and ``out_proj``), cross-attention
    and FFN, and in a whisper prefill the encoder's two a layer."""
    per = {"ssm": 2, "attn": 1, "mla": 1, "cross": 1}
    calls = 1
    for mixer, ffn in get_model(cfg).layer_plan():
        calls += per[mixer] + (ffn != "none") + (cfg.family == "encdec")
    if prefill and cfg.family == "encdec":
        calls += 2 * cfg.encdec.n_encoder_layers
    return calls


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_collectives_are_counted(arch, served):
    """A prefill and a decode step make the all-reduces their layers need
    and one all-gather of the logits, through MeshComm's counters."""
    ref, outs = served[arch]
    cfg = ref["cfg"]
    for out in outs:
        assert out["wire"]["all_reduce_calls"] == _all_reduces(cfg, True)
        assert out["step_wire"]["all_reduce_calls"] == \
            STEPS * _all_reduces(cfg, False)
        assert out["wire"]["all_gather_calls"] == 1
        assert out["step_wire"]["all_gather_calls"] == STEPS
