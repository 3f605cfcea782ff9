"""Dense-LM serving over a model axis (tensor parallelism) against the JAX
reference on the CPU.

Pure tests: for every config of the reference's registry the port's spec
tree carries the reference's logical axes, leaf by leaf, and at t = 2 and
4 model ranks each rank's slice has the shape that the reference's
``spec_tree(..., SINGLE_POD.resolve)`` and divisibility guard
(``repro/models/params.py:81-107``) give on a (1, t) mesh.  A rank's
drawn weights are the slices of one rank's.  What the port does not serve
over a model axis (a split that cuts a head or an SSD rank's B/C groups,
a cache only a sequence split could place, any train step) raises
``NotImplementedError`` naming ROADMAP.md when it is built.

Ranks: one cohort of 2 gloo CPU processes (``multihost.launch_workers``)
serves two small fp32 dense configs on a (1, 2) mesh: ``split`` (d 64, 4
heads of 16, 2 KV heads: ``wk``/``wv`` split, a KV head a rank) and
``whole`` (d 64, 8 heads of 8, 1 KV head: kv * hd = 8 is not a multiple
of ``TP_SIZE``, so ``wk``/``wv`` stay whole and both ranks take the one
KV head).  Weights come from the reference through numpy
(``convert.lm_params_from_reference(..., rules=)``).  The prefill's last
logits, the ranks' caches, 4 decode steps' logits and the greedy tokens
are held to the reference's single-device ``lm_prefill`` /
``lm_decode_step`` / ``generate`` within fp32 1e-4 (sums over d 64 in
another order, the partial sums of the split ``wo`` and ``w_down`` added
by an all-reduce), the tokens exactly.
"""
import json
import pickle
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
from repro_torch.models import get_model
from repro_torch.models.params import (
    Params, local_spec, materialize, named_specs, shard_specs,
)
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import make_train_step

TOL = 1e-4
BATCH, PROMPT, NEW, STEPS = 2, 12, 6, 4
RANKS = 2
F32 = dict(param_dtype="float32", compute_dtype="float32",
           flash_attention=True)
#: The two served configs: the llama3-8b smoke config's other fields.
SERVED = {
    "split": dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16),
    "whole": dict(d_model=64, n_heads=8, n_kv_heads=1, head_dim=8),
}


def _mesh(names, shape):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=torch.zeros(shape, dtype=torch.int64))


def _rules(t: int) -> sharding.ShardingRules:
    return sharding.rules_for_mesh(_mesh(("data", "model"), (1, t)))


# ---------------------------------------------------------------------------
# Pure: the spec trees' axes and the per-rank shapes
# ---------------------------------------------------------------------------
def _reference_leaf(tree, name: str, cfg):
    """The reference's ParamSpec that port parameter ``name`` stands for,
    and the count of its stacked leading axes."""
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


def _both_trees(arch: str):
    cfg = configs.get_config(arch)
    jtree = jmodels.get_model(jconfigs.get_config(arch)).specs()
    return cfg, named_specs(get_model(cfg).specs()), jtree


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_spec_axes_are_the_references(arch):
    """Every leaf of the port's spec tree has the reference's logical axes
    (without the reference's stacked layer axes) and its shape."""
    cfg, leaves, jtree = _both_trees(arch)
    for name, spec in leaves:
        ref, lead = _reference_leaf(jtree, name, cfg)
        assert spec.axes is not None, name
        assert spec.axes == tuple(ref.axes[lead:]), name
        assert spec.shape == tuple(ref.shape[lead:]), name


@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_shard_shapes_are_the_references(arch, t):
    """A rank's slice of every leaf on a (1, t) mesh: the reference's
    ``spec_tree`` under ``SINGLE_POD`` and its divisibility guard (a dim
    whose size does not divide by its mesh extent stays whole)."""
    cfg, leaves, jtree = _both_trees(arch)
    sizes = {"data": 1, "model": t}
    pspecs = jpm.spec_tree(jtree, SINGLE_POD.resolve)
    rules = _rules(t)
    for name, spec in leaves:
        ref, lead = _reference_leaf(jtree, name, cfg)
        pspec, _ = _reference_leaf(pspecs, name, cfg)
        want = []
        for size, axes in zip(ref.shape, pspec):
            names = (() if axes is None else (axes,) if isinstance(axes, str)
                     else tuple(axes))
            extent = int(np.prod([sizes[a] for a in names]))
            want.append(size // extent if size % extent == 0 else size)
        got = local_spec(spec, rules, {"data": 0, "model": t - 1})
        assert got.shape == tuple(want[lead:]), name
        assert got.full_shape == spec.shape, name


@pytest.mark.parametrize("t", [2, 4])
def test_rank_slices_are_one_ranks_weights(t):
    """Each of t ranks draws every whole tensor from the generator one rank
    uses and keeps its slice: the slices join into one rank's weights."""
    cfg = configs.get_smoke_config("llama3-8b")
    specs = get_model(cfg).specs()
    whole = dict(materialize(Params(specs, "cpu"),
                             torch.Generator().manual_seed(3))
                 .named_parameters())
    split = 0
    rules = _rules(t)
    for index in range(t):
        local = shard_specs(specs, rules, {"data": 0, "model": index})
        part = materialize(Params(local, "cpu"),
                           torch.Generator().manual_seed(3))
        lspecs = dict(named_specs(local))
        for name, p in part.named_parameters():
            want = whole[name]
            for dim, (n, i) in enumerate(lspecs[name].part or ()):
                size = want.shape[dim] // n
                want = want.narrow(dim, i * size, size)
                split += n > 1
            assert torch.equal(p, want), name
    assert split > 0


# ---------------------------------------------------------------------------
# Refusals at build
# ---------------------------------------------------------------------------
def test_moe_builds_over_the_model_axis(monkeypatch):
    """qwen2-moe's smoke config builds over model = 2 on the meta device
    (one process, no process group): the experts and the shared expert
    split by ff columns, the router whole, the cache a rank's KV heads."""
    from repro_torch.distributed import multihost as mh

    monkeypatch.setattr(mh, "_axes_group", lambda mesh, axes: None)
    mesh = _mesh(("data", "model"), (1, 2))
    mesh.get_coordinate = lambda: [0, 1]
    rules = sharding.rules_for_mesh(mesh)
    cfg = configs.get_smoke_config("qwen2-moe-a2.7b")
    model = get_model(cfg)
    params = model.empty_params("meta", rules=rules)
    ffn = params.layers[0].ffn
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    assert ffn.w_gate.shape == (e, d, ff // 2)
    assert ffn.w_down.shape == (e, ff // 2, d)
    assert ffn.router.shape == (d, e)
    assert ffn.shared.w_up.shape == (d, cfg.moe.d_ff_shared // 2)
    k, _ = model.init_cache(1, 8, "meta", rules=rules)[0]
    assert k.shape == (1, 8, cfg.n_kv_heads // 2, cfg.hd)


def test_a_sequence_split_cache_is_refused_at_build():
    """wk/wv tagged and split over more ranks than KV heads (one KV head of
    16 over 2 ranks): only the reference's sequence split could place the
    cache, so building raises, naming ROADMAP.md."""
    cfg = configs.get_smoke_config("llama3-8b").replace(
        d_model=64, n_heads=4, n_kv_heads=1, head_dim=16)
    with pytest.raises(NotImplementedError, match="sequence split.*ROADMAP"):
        get_model(cfg).empty_params("meta", rules=_rules(2))
    # The VLM's self and cross layers likewise: 2 KV heads over 4 ranks.
    vlm = configs.get_smoke_config("llama-3.2-vision-11b")
    with pytest.raises(NotImplementedError, match="sequence split.*item 14"):
        get_model(vlm).empty_params("meta", rules=_rules(4))


#: A split that cuts a head or an SSD rank's B/C groups: (arch, config
#: overrides, SSD overrides, model ranks).
CUTS = {
    # 4 SSD heads of 64 (d_in 256) over 8 ranks: 32 channels a rank.
    "ssd_head": ("mamba2-780m", {}, {}, 8),
    # 6 SSD heads of 32 in 3 groups of 2 over 2 ranks: 3 heads a rank.
    "ssd_groups": ("mamba2-780m", {"d_model": 96},
                   {"head_dim": 32, "n_groups": 3}, 2),
    # 4 MLA heads over 8 ranks: wq_b's 192 columns split, 24 a rank.
    "mla_head": ("deepseek-v2-236b", {}, {}, 8),
}


@pytest.mark.parametrize("case", list(CUTS))
def test_a_head_or_group_cut_is_refused_at_build(case):
    """A split of the SSD mixer's inner width that cuts a head or puts a
    rank's heads across part of a B/C group, and a split of MLA's heads
    that cuts one, raise NotImplementedError naming ROADMAP.md when the
    parameters are built (the meta device: nothing is allocated)."""
    import dataclasses

    arch, kw, ssm_kw, ranks = CUTS[case]
    cfg = configs.get_smoke_config(arch).replace(**kw)
    if ssm_kw:
        cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, **ssm_kw))
    what = "B/C groups" if case == "ssd_groups" else "cut a head"
    with pytest.raises(NotImplementedError, match=f"{what}.*ROADMAP.md"):
        get_model(cfg).empty_params("meta", rules=_rules(ranks))


def test_expert_and_train_axes_are_refused():
    """``ep`` over model = 2 raises on the serving path for a config whose
    experts do not split by expert (the reference's ``_use_ep`` False:
    llama3-8b has none, qwen2-moe's 60 are not a multiple of TP_SIZE),
    and passes for one whose ``_use_ep`` holds (16 experts, moe_ep);
    a train step over model = 2 raises at build, naming item 11."""
    import dataclasses

    cfg = configs.get_smoke_config("llama3-8b")
    rules = _rules(2)
    rules.check("tp", "sp", serving=cfg)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rules.check("ep", serving=cfg)
    qwen = configs.get_config("qwen2-moe-a2.7b")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        rules.check("ep", serving=qwen.replace(moe_ep=True))
    moe = configs.get_smoke_config("qwen2-moe-a2.7b")
    rules.check("tp", "sp", "ep", serving=moe.replace(
        moe_ep=True, moe=dataclasses.replace(moe.moe, num_experts=16)))
    jamba = configs.get_smoke_config("jamba-1.5-large-398b")
    rules.check("tp", "sp", serving=jamba)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 15"):
        rules.check("ep", serving=jamba)
    with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 11"):
        make_train_step(get_model(cfg), opt.AdamWConfig(), rules)
    # Every family serves over the model axis; none trains over it.
    for arch in ("mamba2-780m", "whisper-small"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md.*item 11"):
            make_train_step(get_model(configs.get_smoke_config(arch)),
                            opt.AdamWConfig(), rules)


# ---------------------------------------------------------------------------
# Two gloo ranks against the reference
# ---------------------------------------------------------------------------
_WORKER = r"""
import json, os, pickle
import numpy as np
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
for name, kw in env["served"].items():
    cfg = configs.get_smoke_config("llama3-8b").replace(**kw)
    model = get_model(cfg)
    with open(os.path.join(env["dir"], f"{name}.pkl"), "rb") as f:
        ref = pickle.load(f)
    params = lm_params_from_reference(ref["params"], cfg, "cpu", rules=rules)
    prompt = torch.from_numpy(ref["prompt"]).long()
    caches = model.init_cache(env["batch"], env["s_max"], "cpu", rules=rules)
    _mh.wire_counts(reset=True)
    logits, caches = model.prefill(params, prompt, caches, rules=rules)
    wire = _mh.wire_counts(reset=True)
    prefill_caches = [(k.clone(), v.clone()) for k, v in caches]
    steps = []
    for i in range(env["steps"]):
        tok = torch.from_numpy(ref["decode"][:, i:i + 1]).long()
        step, _ = model.decode_step(params, tok, caches,
                                    env["prompt"] + i, rules=rules)
        steps.append(step)
    step_wire = _mh.wire_counts(reset=True)
    tokens, info = generate(model, params, prompt,
                            ServeConfig(max_new_tokens=env["new"]),
                            rules=rules, return_info=True)
    torch.save(dict(logits=logits, prefill_caches=prefill_caches,
                    caches=[tuple(c) for c in caches],
                    steps=torch.stack(steps), tokens=tokens, info=info,
                    wire=wire, step_wire=step_wire,
                    shapes={n: tuple(p.shape)
                            for n, p in params.named_parameters()}),
               os.path.join(env["dir"], f"{name}-{rank}.pt"))
"""


def _reference_run(name: str, tmp) -> dict:
    """The reference's single-device run of one served config; its params
    and inputs pickled (numpy) for the ranks."""
    kw = {**SERVED[name], **F32}
    jmodel = jmodels.get_model(jconfigs.get_smoke_config(
        "llama3-8b").replace(**kw))
    jparams = jpm.materialize(jmodel.specs(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    vocab = jmodel.cfg.vocab
    prompt = rng.integers(0, vocab, (BATCH, PROMPT)).astype(np.int32)
    decode = rng.integers(0, vocab, (BATCH, STEPS)).astype(np.int32)
    with open(tmp / f"{name}.pkl", "wb") as f:
        pickle.dump(dict(params=jax.tree.map(np.asarray, jparams),
                         prompt=prompt, decode=decode), f)
    logits, caches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                    SINGLE_DEVICE)
    prefill_kv = [np.asarray(x) for x in caches[0]["mixer"]]
    caches = jengine._pad_caches(jmodel, caches, BATCH, PROMPT,
                                 PROMPT + NEW)
    steps = []
    for i in range(STEPS):
        step, caches = jmodel.decode_step(
            jparams, jnp.asarray(decode[:, i:i + 1]), caches,
            jnp.int32(PROMPT + i), SINGLE_DEVICE)
        steps.append(np.asarray(step))
    tokens = jengine.generate(jmodel, jparams, jnp.asarray(prompt),
                              SINGLE_DEVICE,
                              jengine.ServeConfig(max_new_tokens=NEW))
    return dict(logits=np.asarray(logits), prefill_kv=prefill_kv,
                kv=[np.asarray(x) for x in caches[0]["mixer"]],
                steps=np.stack(steps), tokens=np.asarray(tokens),
                cfg=jmodel.cfg)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{config name: (reference run, [rank 0's outputs, rank 1's])}."""
    from repro_torch.distributed import multihost as mh

    tmp = tmp_path_factory.mktemp("tp")
    refs = {name: _reference_run(name, tmp) for name in SERVED}
    env = dict(dir=str(tmp), ranks=RANKS, batch=BATCH, prompt=PROMPT,
               new=NEW, steps=STEPS, s_max=PROMPT + NEW,
               served={n: {**kw, **F32} for n, kw in SERVED.items()})
    mh.launch_workers(_WORKER, num_processes=RANKS, backend="gloo",
                      timeout=300,
                      extra_env={"TP_ENV": json.dumps(env),
                                 "OMP_NUM_THREADS": "1"})
    return {name: (refs[name], [torch.load(tmp / f"{name}-{r}.pt")
                                for r in range(RANKS)])
            for name in SERVED}


def _close(got, want):
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=TOL)


def _kv_heads(name: str, rank: int) -> slice:
    """The KV heads rank ``rank`` holds: one each where split, the one
    head on both where whole."""
    return slice(rank, rank + 1) if name == "split" else slice(0, 1)


@pytest.mark.parametrize("name", list(SERVED))
def test_ranks_hold_their_slices(name, served):
    """The split config's wk/wv hold one KV head a rank, the whole one's
    stay whole; wq, wo, the MLP and the vocabulary are halved."""
    ref, outs = served[name]
    cfg = ref["cfg"]
    for out in outs:
        shapes = out["shapes"]
        hd = cfg.hd
        assert shapes["layers.0.mixer.wq"] == (64, cfg.n_heads * hd // 2)
        assert shapes["layers.0.mixer.wo"] == (cfg.n_heads * hd // 2, 64)
        kv = cfg.n_kv_heads * hd // (2 if name == "split" else 1)
        assert shapes["layers.1.mixer.wk"] == (64, kv)
        assert shapes["layers.0.ffn.w_down"] == (cfg.d_ff // 2, 64)
        assert shapes["embed.table"][0] == 256
        assert out["info"] == {"decode": "eager", "why": "not a CUDA device"}


@pytest.mark.parametrize("name", list(SERVED))
def test_prefill_logits_match_reference(name, served):
    ref, outs = served[name]
    for out in outs:
        assert out["logits"].shape == ref["logits"].shape
        _close(out["logits"], ref["logits"])
    assert torch.equal(outs[0]["logits"], outs[1]["logits"])


@pytest.mark.parametrize("name", list(SERVED))
def test_caches_match_reference(name, served):
    """Each rank's cache holds its KV heads of the reference's (the
    prompt's K/V after the prefill, and every position after 4 decode
    steps); gathered over the ranks they are the whole cache."""
    ref, outs = served[name]
    for rank, out in enumerate(outs):
        heads = _kv_heads(name, rank)
        for (k, v), jk, jv in zip(out["prefill_caches"], *ref["prefill_kv"],
                                  strict=True):
            _close(k[:, :PROMPT], jk[:, :, heads])
            _close(v[:, :PROMPT], jv[:, :, heads])
        for (k, v), jk, jv in zip(out["caches"], *ref["kv"], strict=True):
            _close(k[:, :PROMPT + STEPS], jk[:, :PROMPT + STEPS, heads])
            _close(v[:, :PROMPT + STEPS], jv[:, :PROMPT + STEPS, heads])
    if name == "split":
        gathered = torch.cat([o["caches"][0][0] for o in outs], dim=2)
        _close(gathered[:, :PROMPT + STEPS],
               ref["kv"][0][0][:, :PROMPT + STEPS])


@pytest.mark.parametrize("name", list(SERVED))
def test_decode_logits_match_reference(name, served):
    ref, outs = served[name]
    for out in outs:
        _close(out["steps"], ref["steps"])


@pytest.mark.parametrize("name", list(SERVED))
def test_greedy_tokens_match_reference(name, served):
    ref, outs = served[name]
    for out in outs:
        assert out["tokens"].dtype == torch.int32
        assert np.array_equal(out["tokens"].numpy(), ref["tokens"])


@pytest.mark.parametrize("name", list(SERVED))
def test_collectives_are_counted(name, served):
    """The model axis's collectives go through MeshComm: a prefill is one
    all-reduce for the embedding, one after each layer's wo and w_down,
    and one all-gather of the logits; a decode step the same."""
    ref, outs = served[name]
    layers = ref["cfg"].n_layers
    for out in outs:
        for wire, calls in ((out["wire"], 1), (out["step_wire"], STEPS)):
            assert wire["all_reduce_calls"] == calls * (1 + 2 * layers)
            assert wire["all_gather_calls"] == calls
            assert wire["all_reduce_bytes"] > 0


def test_row_parallel_sums_in_fp32_and_rounds_once():
    """The row-parallel product of a bf16 slice: fp32 partial products,
    summed over the model ranks (one here), rounded to bf16 once; fp32
    operands take the plain product."""
    from repro_torch.models.parallel import TensorParallel

    comm = types.SimpleNamespace(model_size=1, model_index=0,
                                 all_reduce=lambda x, over: x.clone())
    tp = TensorParallel(comm)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 64, generator=g).to(torch.bfloat16)
    w = torch.randn(64, 16, generator=g).to(torch.bfloat16)
    got = tp.row_parallel(x, w)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 3, 16)
    assert torch.equal(got, (x.float() @ w.float()).to(torch.bfloat16))
    assert torch.equal(tp.row_parallel(x.float(), w.float()),
                       x.float() @ w.float())
