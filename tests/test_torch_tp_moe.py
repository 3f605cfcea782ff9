"""MoE serving over a model axis against the JAX reference on the CPU.

Pure tests: the experts' rank shapes on a (1, t) mesh at t = 2 and 4, as
the reference's ``spec_tree(..., SINGLE_POD.resolve)`` and divisibility
guard (``repro/models/params.py:81-107``) give them, for the layout every
shipped config takes (the experts' ff columns split over ``tp``) and for
expert parallelism (``moe_ep=True`` with 16 experts: ``_use_ep`` holds in
the reference too); ranks that do not divide the experts are refused at
build; and the MoE layer (``moe.moe_ffn(..., tp=)``) on t simulated ranks
(threads whose all-reduce adds every rank's partial) equals the
single-rank layer, where a weight the ranks do not divide is computed
whole on every rank and not added t times.

Ranks: one cohort of 2 gloo CPU processes (``multihost.launch_workers``)
serves the qwen2-moe smoke config in fp32 twice: ``ff`` (as shipped: the
experts and the shared expert split by ff columns) and ``ep`` (16 experts,
``moe_ep=True``: 8 whole experts a rank, the shared expert split by
columns).  Each prompt is long enough that some (row, expert) overflows
its capacity (40 tokens: cap 8 against 10 assignments an expert on
average at 8 experts; 64 tokens at 16).  Weights come from the reference
through numpy (``convert.lm_params_from_reference(..., rules=)``).  The
prefill's last logits, the ranks' caches, 4 decode steps' logits and the
greedy tokens are held to the reference's single-device ``lm_prefill`` /
``lm_decode_step`` / ``generate`` within fp32 1e-4, the tokens exactly;
the routing ids are equal on both ranks at every layer and step, and each
MoE layer makes one all-reduce.
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
from repro.models import moe as jmoe
from repro.models import params as jpm
from repro.serving import engine as jengine
from repro_torch import configs
from repro_torch.convert import _layer_node
from repro_torch.distributed import sharding
from repro_torch.models import get_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import head_layout
from repro_torch.models.params import (
    Params, local_spec, materialize, named_specs, shard_parts, shard_specs,
)
from repro_torch.models.parallel import TensorParallel

TOL = 1e-4
BATCH, NEW, STEPS = 2, 6, 4
RANKS = 2
ARCH = "qwen2-moe-a2.7b"
F32 = dict(param_dtype="float32", compute_dtype="float32",
           flash_attention=True)
#: The served layouts: (config overrides, MoE overrides, prompt length).
SERVED = {
    "ff": ({}, {}, 40),
    "ep": ({"moe_ep": True}, {"num_experts": 16}, 64),
}


def _mesh(names, shape):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=torch.zeros(shape, dtype=torch.int64))


def _rules(t: int) -> sharding.ShardingRules:
    return sharding.rules_for_mesh(_mesh(("data", "model"), (1, t)))


def _config(pkg, name: str, f32: bool = True):
    """The smoke config of layout ``name`` from ``pkg`` (the port's
    ``configs`` or the reference's)."""
    kw, moe_kw, _ = SERVED[name]
    cfg = pkg.get_smoke_config(ARCH)
    cfg = cfg.replace(**kw, moe=dataclasses.replace(cfg.moe, **moe_kw))
    return cfg.replace(**F32) if f32 else cfg


# ---------------------------------------------------------------------------
# Pure: the experts' rank shapes, the refusal, the layer on simulated ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("t", [2, 4])
@pytest.mark.parametrize("name", list(SERVED))
def test_expert_shard_shapes_are_the_references(name, t):
    """Every MoE leaf of layer 0 on a (1, t) mesh: the reference's
    ``spec_tree`` under ``SINGLE_POD`` and its divisibility guard; the
    experts (E, d, ff/t) and (E, ff/t, d) under the ff split, (E/t, d, ff)
    under ``ep``; the router whole."""
    cfg, jcfg = _config(configs, name, False), _config(jconfigs, name, False)
    assert moe_mod._use_ep(cfg) == jmoe._use_ep(jcfg) == (name == "ep")
    jtree = jmodels.get_model(jcfg).specs()
    pspecs = jpm.spec_tree(jtree, SINGLE_POD.resolve)
    jnode, index = _layer_node(jtree, cfg, 0)
    pnode, _ = _layer_node(pspecs, cfg, 0)
    lead = len(index) if isinstance(index, tuple) else 1
    rules, sizes = _rules(t), {"data": 1, "model": t}
    leaves = named_specs(get_model(cfg).specs()["layers"][0]["ffn"])
    for leaf, spec in leaves:
        ref, pspec = jnode["ffn"], pnode["ffn"]
        for part in leaf.split("."):
            ref, pspec = ref[part], pspec[part]
        want = []
        for size, axes in zip(ref.shape[lead:], tuple(pspec)[lead:]):
            names = (() if axes is None else (axes,) if isinstance(axes, str)
                     else tuple(axes))
            extent = int(np.prod([sizes[a] for a in names]))
            want.append(size // extent if size % extent == 0 else size)
        got = local_spec(spec, rules, {"data": 0, "model": t - 1})
        assert got.shape == tuple(want), leaf
        assert spec.axes == tuple(ref.axes[lead:]), leaf
    e, d, ff = (cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert)
    specs = dict(leaves)
    gate = local_spec(specs["w_gate"], rules, {"data": 0, "model": 0})
    down = local_spec(specs["w_down"], rules, {"data": 0, "model": 0})
    if name == "ep":
        assert gate.shape == (e // t, d, ff) and down.shape == (e // t, ff, d)
    else:
        assert gate.shape == (e, d, ff // t) and down.shape == (e, ff // t, d)
    assert local_spec(specs["router"], rules, {"data": 0, "model": 0}) \
        .shape == (d, e)


def _meta_rules(monkeypatch, t: int, index: int = 0):
    """Rules over a (1, t) mesh whose rank sits at model ``index``, for a
    build on the meta device in one process (no process group: nothing
    runs a collective)."""
    from repro_torch.distributed import multihost as mh

    monkeypatch.setattr(mh, "_axes_group", lambda mesh, axes: None)
    mesh = _mesh(("data", "model"), (1, t))
    mesh.get_coordinate = lambda: [0, index]
    return sharding.rules_for_mesh(mesh)


def test_ranks_that_do_not_divide_the_experts_are_refused(monkeypatch):
    """16 experts under ``ep`` over 3 ranks: the reference's guard would
    leave every expert on every rank, so the port refuses the build,
    naming ROADMAP.md and its item; over 2 ranks it builds (meta), 8
    experts a rank."""
    cfg = _config(configs, "ep")
    spec = get_model(cfg).specs()["layers"][0]["ffn"]["w_gate"]
    assert shard_parts(spec, _rules(3)) == (1, 1, 1)
    model = get_model(cfg)
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md.*item 15"):
        model.empty_params("meta", rules=_rules(3))
    params = model.empty_params("meta", rules=_meta_rules(monkeypatch, 2, 1))
    assert params.layers[0].ffn.w_gate.shape == (8, cfg.d_model,
                                                 cfg.moe.d_ff_expert)
    assert params.layers[0].ffn.specs["w_gate"].part[0] == (2, 1)


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


def _layer_on_ranks(cfg, t: int, x: torch.Tensor, dispatch: str):
    """``moe_ffn`` on t simulated ranks, each with its slices of one
    rank's weights (seed 0): every rank's output and all-reduce count."""
    spec = moe_mod.moe_specs(cfg)
    board = dict(parts={}, barrier=threading.Barrier(t))
    outs, calls = {}, {}

    def rank(i):
        local = shard_specs(spec, _rules(t), {"data": 0, "model": i})
        params = materialize(Params(local, "cpu"),
                             torch.Generator().manual_seed(0))
        comm = _ThreadComm(t, i, board)
        outs[i], _ = moe_mod.moe_ffn(params, x, cfg, dispatch=dispatch,
                                     tp=TensorParallel(comm))
        calls[i] = comm.calls

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(t)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return [outs[i] for i in range(t)], [calls[i] for i in range(t)]


@pytest.mark.parametrize("dispatch", ["grouped", "gather"])
@pytest.mark.parametrize("name,t", [("ff", 2), ("ff", 3), ("ff", 4),
                                    ("ep", 2), ("ep", 4)])
def test_moe_layer_on_simulated_ranks_is_the_single_rank_layer(name, t,
                                                               dispatch):
    """The layer over t ranks equals the layer on one rank within fp32
    1e-4 (the same output on every rank, one all-reduce).  At t = 3 the
    ff columns (64, 128) do not divide: every rank computes the whole
    layer and makes no all-reduce, so nothing is added three times (the
    ``ep`` layout is refused at build there)."""
    cfg = _config(configs, name)
    whole = materialize(Params(moe_mod.moe_specs(cfg), "cpu"),
                        torch.Generator().manual_seed(0))
    seq = SERVED[name][2] if dispatch == "grouped" else 1
    x = torch.randn(BATCH, seq, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    want, _ = moe_mod.moe_ffn(whole, x, cfg, dispatch=dispatch)
    outs, calls = _layer_on_ranks(cfg, t, x, dispatch)
    for out in outs:
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=TOL,
                                   atol=TOL)
        assert torch.equal(out, outs[0])
    assert calls == [0 if t == 3 else 1] * t


def test_bf16_layer_on_ranks_keeps_fp32_partial_sums():
    """bf16 experts over 2 ranks: the routed and shared partials are
    summed in fp32 and rounded once, within bf16's 8e-2 of one rank's
    layer (which rounds each expert's output to bf16)."""
    cfg = _config(configs, "ff", f32=False)
    whole = materialize(Params(moe_mod.moe_specs(cfg), "cpu"),
                        torch.Generator().manual_seed(0))
    x = torch.randn(BATCH, 40, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16)
    want, _ = moe_mod.moe_ffn(whole, x, cfg)
    outs, calls = _layer_on_ranks(cfg, 2, x, "grouped")
    assert outs[0].dtype == torch.bfloat16 and calls == [1, 1]
    np.testing.assert_allclose(outs[0].float().numpy(),
                               want.float().numpy(), rtol=8e-2, atol=8e-2)


def test_one_rank_is_the_single_device_path_bit_for_bit():
    """Rules over a (1, 1) mesh give no tensor-parallel context: prefill
    and a decode step are the single-device path's bits."""
    cfg = _config(configs, "ff")
    model = get_model(cfg)
    rules = _rules(1)
    assert model.tensor_parallel(rules) is None
    params = model.init_params(seed=0, device="cpu", rules=rules)
    prompt = torch.randint(0, cfg.vocab, (BATCH, 40),
                           generator=torch.Generator().manual_seed(2))
    outs = []
    for kw in ({}, {"rules": rules}):
        caches = model.init_cache(BATCH, 41, "cpu", **kw)
        logits, caches = model.prefill(params, prompt, caches, **kw)
        step, _ = model.decode_step(params, prompt[:, :1], caches, 40, **kw)
        outs.append((logits, step))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


# ---------------------------------------------------------------------------
# Two gloo ranks against the reference
# ---------------------------------------------------------------------------
_WORKER = r"""
import dataclasses, hashlib, json, os, pickle
import numpy as np
import torch
from repro_torch import configs
from repro_torch.convert import lm_params_from_reference
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.models import blocks, get_model
from repro_torch.models import moe as moe_mod
from repro_torch.serving.engine import ServeConfig, generate

torch.set_num_threads(1)
env = json.loads(os.environ["TP_ENV"])
mesh = _mh.multihost_mesh(("data", "model"), (1, env["ranks"]), device="cpu")
rules = rules_for_mesh(mesh)
rank = _mh.MeshComm(mesh, ("data",), "model").model_index

routes = []
real_route = moe_mod._route


def route(params, x, cfg):
    w, ids, aux = real_route(params, x, cfg)
    routes.append(ids.clone())
    return w, ids, aux


moe_calls = []
real_ffn = moe_mod.moe_ffn


def moe_ffn(*args, **kw):
    before = _mh.wire_counts()["all_reduce_calls"]
    out = real_ffn(*args, **kw)
    moe_calls.append(_mh.wire_counts()["all_reduce_calls"] - before)
    return out


moe_mod._route, moe_mod.moe_ffn = route, moe_ffn
for name, (kw, moe_kw, prompt_len) in env["served"].items():
    base = configs.get_smoke_config(env["arch"])
    cfg = base.replace(**kw, moe=dataclasses.replace(base.moe, **moe_kw))
    model = get_model(cfg)
    with open(os.path.join(env["dir"], f"{name}.pkl"), "rb") as f:
        ref = pickle.load(f)
    params = lm_params_from_reference(ref["params"], cfg, "cpu", rules=rules)
    prompt = torch.from_numpy(ref["prompt"]).long()
    s_max = prompt_len + env["new"]
    caches = model.init_cache(env["batch"], s_max, "cpu", rules=rules)
    routes.clear()
    moe_calls.clear()
    _mh.wire_counts(reset=True)
    logits, caches = model.prefill(params, prompt, caches, rules=rules)
    wire = _mh.wire_counts(reset=True)
    prefill_routes = [r.clone() for r in routes]
    prefill_caches = [(k.clone(), v.clone()) for k, v in caches]
    steps = []
    for i in range(env["steps"]):
        tok = torch.from_numpy(ref["decode"][:, i:i + 1]).long()
        step, _ = model.decode_step(params, tok, caches, prompt_len + i,
                                    rules=rules)
        steps.append(step)
    step_wire = _mh.wire_counts(reset=True)
    tokens, info = generate(model, params, prompt,
                            ServeConfig(max_new_tokens=env["new"]),
                            rules=rules, return_info=True)
    digest = hashlib.sha256(b"".join(
        r.to(torch.int64).numpy().tobytes() for r in routes)).hexdigest()
    torch.save(dict(logits=logits, prefill_caches=prefill_caches,
                    caches=[tuple(c) for c in caches],
                    steps=torch.stack(steps), tokens=tokens, info=info,
                    wire=wire, step_wire=step_wire, moe_calls=list(moe_calls),
                    routes=[r.clone() for r in routes], routes_hash=digest,
                    prefill_routes=prefill_routes,
                    shapes={n: tuple(p.shape)
                            for n, p in params.named_parameters()}),
               os.path.join(env["dir"], f"{name}-{rank}.pt"))
"""


def _reference_run(name: str, tmp) -> dict:
    """The reference's single-device run of one layout; its params and
    inputs pickled (numpy) for the ranks."""
    jmodel = jmodels.get_model(_config(jconfigs, name))
    prompt_len = SERVED[name][2]
    jparams = jpm.materialize(jmodel.specs(), jax.random.PRNGKey(0))
    rng = np.random.default_rng(5)
    vocab = jmodel.cfg.vocab
    prompt = rng.integers(0, vocab, (BATCH, prompt_len)).astype(np.int32)
    decode = rng.integers(0, vocab, (BATCH, STEPS)).astype(np.int32)
    with open(tmp / f"{name}.pkl", "wb") as f:
        pickle.dump(dict(params=jax.tree.map(np.asarray, jparams),
                         prompt=prompt, decode=decode), f)
    logits, caches = jmodel.prefill(jparams, {"tokens": jnp.asarray(prompt)},
                                    SINGLE_DEVICE)
    prefill_kv = [np.asarray(x) for x in caches[0]["mixer"]]
    caches = jengine._pad_caches(jmodel, caches, BATCH, prompt_len,
                                 prompt_len + NEW)
    steps = []
    for i in range(STEPS):
        step, caches = jmodel.decode_step(
            jparams, jnp.asarray(decode[:, i:i + 1]), caches,
            jnp.int32(prompt_len + i), SINGLE_DEVICE)
        steps.append(np.asarray(step))
    tokens = jengine.generate(jmodel, jparams, jnp.asarray(prompt),
                              SINGLE_DEVICE,
                              jengine.ServeConfig(max_new_tokens=NEW))
    return dict(logits=np.asarray(logits), prefill_kv=prefill_kv,
                kv=[np.asarray(x) for x in caches[0]["mixer"]],
                steps=np.stack(steps), tokens=np.asarray(tokens),
                cfg=_config(configs, name), prompt_len=prompt_len)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{layout: (reference run, [rank 0's outputs, rank 1's])}."""
    from repro_torch.distributed import multihost as mh

    tmp = tmp_path_factory.mktemp("tp_moe")
    refs = {name: _reference_run(name, tmp) for name in SERVED}
    env = dict(dir=str(tmp), ranks=RANKS, batch=BATCH, new=NEW, steps=STEPS,
               arch=ARCH,
               served={n: ({**kw, **F32}, moe_kw, s)
                       for n, (kw, moe_kw, s) in SERVED.items()})
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


@pytest.mark.parametrize("name", list(SERVED))
def test_ranks_hold_their_experts(name, served):
    """Each rank holds half of the experts' ff columns (``ff``) or half of
    the experts (``ep``), half of the shared expert's columns and the
    whole router; the decode ran eagerly (not a CUDA device)."""
    ref, outs = served[name]
    cfg = ref["cfg"]
    e, d, ff = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    want = (e // 2, d, ff) if name == "ep" else (e, d, ff // 2)
    for out in outs:
        shapes = out["shapes"]
        assert shapes["layers.0.ffn.w_gate"] == want
        assert shapes["layers.1.ffn.w_up"] == want
        assert shapes["layers.0.ffn.w_down"] == (want[0], want[2], want[1])
        assert shapes["layers.0.ffn.router"] == (d, e)
        assert shapes["layers.0.ffn.shared.w_down"] == (
            cfg.moe.d_ff_shared // 2, d)
        assert out["info"] == {"decode": "eager", "why": "not a CUDA device"}


@pytest.mark.parametrize("name", list(SERVED))
def test_prompt_overflows_an_experts_capacity(name, served):
    """Some (row, expert) of the prefill takes more assignments than its
    capacity, so dropped assignments are on the compared path."""
    ref, outs = served[name]
    cfg = ref["cfg"]
    cap = moe_mod.capacity(cfg, ref["prompt_len"])
    loads = [torch.stack([(ids.reshape(ids.shape[0], -1) == e).sum(-1)
                          for e in range(cfg.moe.num_experts)])
             for ids in outs[0]["prefill_routes"]]
    assert len(loads) == cfg.n_layers
    assert max(int(x.max()) for x in loads) > cap


@pytest.mark.parametrize("name", list(SERVED))
def test_prefill_logits_match_reference(name, served):
    ref, outs = served[name]
    for out in outs:
        assert out["logits"].shape == ref["logits"].shape
        _close(out["logits"], ref["logits"])
    assert torch.equal(outs[0]["logits"], outs[1]["logits"])


@pytest.mark.parametrize("name", list(SERVED))
def test_caches_match_reference(name, served):
    """Each rank's cache holds its KV heads of the reference's, after the
    prefill and after 4 decode steps."""
    ref, outs = served[name]
    cfg, s = ref["cfg"], ref["prompt_len"]
    for rank, out in enumerate(outs):
        layout = head_layout(cfg, RANKS, rank)
        heads = slice(layout.kv0, layout.kv0 + layout.kv_heads)
        for (k, v), jk, jv in zip(out["prefill_caches"], *ref["prefill_kv"],
                                  strict=True):
            _close(k[:, :s], jk[:, :, heads])
            _close(v[:, :s], jv[:, :, heads])
        for (k, v), jk, jv in zip(out["caches"], *ref["kv"], strict=True):
            _close(k[:, :s + STEPS], jk[:, :s + STEPS, heads])
            _close(v[:, :s + STEPS], jv[:, :s + STEPS, heads])


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
def test_routing_is_identical_on_every_rank(name, served):
    """Every MoE layer of every forward (the prefill, the decode steps and
    the greedy run) routed every token to the same experts on both ranks:
    else the all-reduce would add halves of different experts."""
    ref, outs = served[name]
    a, b = (out["routes"] for out in outs)
    layers = ref["cfg"].n_layers
    assert len(a) == len(b) == layers * (1 + STEPS + NEW)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert outs[0]["routes_hash"] == outs[1]["routes_hash"]


@pytest.mark.parametrize("name", list(SERVED))
def test_one_all_reduce_an_moe_layer(name, served):
    """Each MoE layer sums its routed and shared partials in one
    all-reduce; a forward is one for the embedding and two a layer (wo,
    the MoE) and one all-gather of the logits."""
    ref, outs = served[name]
    layers = ref["cfg"].n_layers
    for out in outs:
        assert out["moe_calls"] == [1] * layers * (1 + STEPS + NEW)
        for wire, calls in ((out["wire"], 1), (out["step_wire"], STEPS)):
            assert wire["all_reduce_calls"] == calls * (1 + 2 * layers)
            assert wire["all_gather_calls"] == calls
