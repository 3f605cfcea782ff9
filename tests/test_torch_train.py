"""The port's LM training (loss, gradients, AdamW, the train step, the
synthetic data, the activation probe, the launcher and the sharding rules)
against the JAX reference on the CPU.

The reference materialises the ``tinyllama-1.1b`` smoke config's weights
(2 layers, d_model 128) from ``PRNGKey(0)`` and draws its batches
(``SyntheticData.batch_at``); the port takes both through numpy
(``convert.lm_params_from_reference``; gradients and optimizer state by
``convert.lm_grads_from_reference`` / ``adamw_state_from_reference``).
Every reference function is compiled once for the module, at 4 x 32
tokens with query chunks of 16 and cross-entropy chunks of 24 (the
sequence pads to 48: both chunk loops and the padding run).

Tolerances (fp32): loss and metrics 1e-5 relative; gradients and
parameters after three steps 1e-5 of the leaf's max |x| (fp32 sums in
another order); AdamW 1e-6 of max |x|; four microbatches against one the
reference's 5e-5 (tests/test_train_loop.py:55); bf16 losses 2e-2; the
probe's statistics 1e-3 absolute (the two packages draw the inner solve's
initial factors from different generators).
"""
import copy
import dataclasses
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import models as jmodels
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.distributed import grad_compress as jgc
from repro.distributed.sharding import SINGLE_DEVICE as JSINGLE
from repro.models import layers as jlayers
from repro.models import params as jpm
from repro.training import data as jdata
from repro.training import optimizer as jopt
from repro.training import probes as jprobes
from repro.training import train_step as jts
from repro_torch import configs, convert
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed import grad_compress as gc
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import get_model, layers
from repro_torch.serving.engine import ServeConfig, generate
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import DataConfig, SyntheticData
from repro_torch.training.probes import activation_probe
from repro_torch.training.train_step import make_train_step

ARCH = "tinyllama-1.1b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
CHUNKS = dict(q_chunk=16, ce_chunk=24)
BATCH, SEQ = 4, 32
TOL, ADAM_TOL, MB_TOL, BF16_LOSS_TOL, PROBE_TOL = 1e-5, 1e-6, 5e-5, 2e-2, 1e-3
#: tests/test_train_loop.py:41's optimizer.  The steps held to the
#: reference's take lr 1e-4 and eps 1e-6 (STEP_OCFG).  Adam divides each
#: gradient entry by its magnitude plus eps, so a gradient's absolute fp32
#: noise (~5e-9 here, 1e-7 of max |g|, in either package) moves an entry's
#: update by lr x noise / (|g| + eps): for the entries near 0 (1e-9 to
#: 1e-7, a few in every 2-D leaf) that is 3.2e-5 of max |p| at lr 1e-3 and
#: eps 1e-8, and 1.3e-5 at eps 1e-6, over the 1e-5 bar; lr 1e-4 with eps
#: 1e-6 leaves it a tenth of the bar, and the bar still sees one step's
#: weight decay (lr x wd = 1e-5 of p).
OCFG = dict(lr=1e-3, warmup_steps=1, total_steps=10)
STEP_OCFG = dict(OCFG, lr=1e-4, eps=1e-6)
STEPS, BF16_STEPS = 3, 5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread beside JAX's (tests/test_torch_convex.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(x):
    return torch.from_numpy(np.array(x))


def _batch(b):
    return {k: _t(v) for k, v in b.items()}


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _reference(kw):
    """The reference's model, params, batches and jitted functions at the
    smoke config with ``kw``."""
    jcfg = jconfigs.get_smoke_config(ARCH).replace(**kw, **CHUNKS)
    jmodel = jmodels.get_model(jcfg)
    jparams = jpm.materialize(jmodel.specs(), jax.random.PRNGKey(0))
    data = jdata.SyntheticData(jcfg, JShapeSpec("t", SEQ, BATCH, "train"))
    batches = [_np(data.batch_at(i)) for i in range(max(STEPS, BF16_STEPS))]
    step = jax.jit(jts.make_train_step(jmodel,
                                       jopt.AdamWConfig(**STEP_OCFG),
                                       JSINGLE))
    cfg = configs.get_smoke_config(ARCH).replace(**kw, **CHUNKS)
    return types.SimpleNamespace(jcfg=jcfg, jmodel=jmodel, jparams=jparams,
                                 batches=batches, step=step, cfg=cfg)


@pytest.fixture(scope="module")
def ref():
    """fp32: the loss, metrics and gradients at batch 0, and three train
    steps (parameters and metrics after each)."""
    r = _reference(F32)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: r.jmodel.loss(p, b, JSINGLE), has_aux=True))
    (loss, mets), grads = grad_fn(r.jparams, r.batches[0])
    r.loss, r.mets, r.grads = float(loss), _np(mets), _np(grads)
    p, state = r.jparams, jopt.init(r.jparams)
    r.trail = []
    for i in range(STEPS):
        p, state, m = r.step(p, state, r.batches[i])
        r.trail.append((_np(p), _np(m)))
    return r


def _port_params(r, device="cpu"):
    return convert.lm_params_from_reference(_np(r.jparams), r.cfg, device)


# ---------------------------------------------------------------------------
# Loss and gradients
# ---------------------------------------------------------------------------
def test_loss_and_metrics_match_reference(ref):
    loss, mets = get_model(ref.cfg).loss(_port_params(ref),
                                         _batch(ref.batches[0]))
    assert abs(loss.item() - ref.loss) <= TOL * abs(ref.loss)
    assert abs(mets["ce"].item() - float(ref.mets["ce"])) <= TOL * ref.loss
    assert mets["aux"].item() == float(ref.mets["aux"]) == 0.0


def _grads(cfg, params, batch):
    for p in params.parameters():
        p.requires_grad_(True)
    loss, _ = get_model(cfg).loss(params, batch)
    names = [n for n, _ in params.named_parameters()]
    return loss, dict(zip(names, torch.autograd.grad(
        loss, list(params.parameters()))))


def test_gradients_match_reference_leaf_by_leaf(ref):
    """Every gradient leaf within 1e-5 of its max |g| against ``jax.grad``
    of the reference's loss, carried by ``convert.lm_grads_from_reference``
    (the layer stack unstacked)."""
    _, got = _grads(ref.cfg, _port_params(ref), _batch(ref.batches[0]))
    want = convert.lm_grads_from_reference(ref.grads, ref.cfg, "cpu")
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        assert g.shape == want[name].shape, name
        assert _rel(g, want[name]) <= TOL, name


def test_remat_policies_are_bit_exact(ref):
    """``remat`` none, full (recompute each layer) and dots (keep the
    ``aten.mm`` outputs) give the same loss and gradients bit for bit."""
    out = {}
    for remat in ("none", "full", "dots"):
        cfg = ref.cfg.replace(remat=remat)
        out[remat] = _grads(cfg, _port_params(ref), _batch(ref.batches[0]))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0])
        for name, g in out["none"][1].items():
            assert torch.equal(out[remat][1][name], g), (remat, name)


def test_chunked_cross_entropy_pads_and_ignores(ref):
    """A length that needs padding (40 tokens in chunks of 24) with -1
    labels: the value and the gradients of x and W against the
    reference's."""
    rng = np.random.default_rng(3)
    b, s, d, v = 2, 40, 16, 64
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) / 4).astype(np.float32)
    labels = rng.integers(0, v, (b, s)).astype(np.int32)
    labels[0, :7] = -1
    labels[1, -5:] = -1
    jcfg = ref.jcfg.replace(ce_chunk=24)
    want, (gx, gw) = jax.value_and_grad(
        lambda x, w: jlayers.chunked_cross_entropy(
            x, w, jnp.asarray(labels), jcfg, JSINGLE), argnums=(0, 1))(x, w)
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    got = layers.chunked_cross_entropy(xt, wt, _t(labels),
                                       ref.cfg.replace(ce_chunk=24))
    got.backward()
    assert abs(got.item() - float(want)) <= TOL * float(want)
    assert _rel(xt.grad, gx) <= TOL and _rel(wt.grad, gw) <= TOL


def test_bf16_grad_rmsnorm_matches_reference_vjp():
    """``rmsnorm(..., bf16_grad=True)``: the value, dx in x's dtype (bf16)
    and dw in fp32, against the reference's custom VJP."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (1 + rng.standard_normal(64) / 4).astype(np.float32)
    dy = rng.standard_normal((2, 5, 64)).astype(np.float32)
    xb, dyb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    y, vjp = jax.vjp(lambda w, x: jlayers.rmsnorm(w, x, 1e-5, True), w, xb)
    dw, dx = vjp(dyb)
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = layers.rmsnorm(wt, xt, 1e-5, bf16_grad=True)
    yt.backward(torch.from_numpy(dy).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.float32
    np.testing.assert_array_equal(yt.detach().float().numpy(),
                                  np.asarray(y, np.float32))
    assert _rel(wt.grad, dw) <= TOL
    # dx rounds to bf16 once on each side: at most a bf16 ulp apart.
    assert _rel(xt.grad.float(), np.asarray(dx, np.float32)) <= 2 ** -7


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def test_lr_schedule():
    """tests/test_train_loop.py:60-69's points."""
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                           min_lr_frac=0.1)
    lrs = [float(opt.lr_at(ocfg, torch.tensor(s))) for s in
           (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0
    assert abs(lrs[1] - 5e-4) < 1e-9
    assert abs(lrs[2] - 1e-3) < 1e-6
    assert lrs[3] < lrs[2]
    assert abs(lrs[4] - 1e-4) < 1e-6
    want = [float(jopt.lr_at(jopt.AdamWConfig(
        lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1),
        jnp.asarray(s))) for s in (0, 5, 10, 50, 100)]
    assert lrs == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("grad_scale", [1.0, 1e-2])
def test_adamw_updates_match_reference(ref, grad_scale):
    """Three ``update``s from carried-over state against the reference's,
    with the loss gradients times (1, -2, 3) and ``grad_scale``: global
    norms 1.7-5.2 (clipped to 1) and 0.017-0.052 (not clipped).  Parameters, m, v
    within 1e-6 of max |x|, step and metrics equal; the state carried by
    ``convert.adamw_state_from_reference`` leaf by leaf."""
    ocfg = dict(OCFG, weight_decay=0.1)
    jparams, jstate = ref.jparams, jopt.init(ref.jparams)
    params = _port_params(ref)
    state = opt.init(params)
    jupdate = jax.jit(lambda g, s, p: jopt.update(jopt.AdamWConfig(**ocfg),
                                                  g, s, p))
    clipped = []
    for k in (1.0, -2.0, 3.0):
        jgrads = jax.tree.map(lambda g: g * (k * grad_scale), ref.grads)
        jparams, jstate, jm = jupdate(jgrads, jstate, jparams)
        grads = convert.lm_grads_from_reference(_np(jgrads), ref.cfg, "cpu")
        params, state, m = opt.update(opt.AdamWConfig(**ocfg), grads, state,
                                      params)
        clipped.append(float(jm["grad_norm"]) > 1.0)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=ADAM_TOL)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=ADAM_TOL)
        assert m["grad_norm"].ndim == 0 and m["lr"].ndim == 0
    assert clipped == [grad_scale == 1.0] * 3
    want_p = convert.lm_grads_from_reference(_np(jparams), ref.cfg, "cpu")
    want_s = convert.adamw_state_from_reference(_np(jstate), ref.cfg, "cpu")
    assert int(state.step) == int(want_s.step) == 3
    for name, p in params.named_parameters():
        assert _rel(p.detach(), want_p[name]) <= ADAM_TOL, name
        assert _rel(state.m[name], want_s.m[name]) <= ADAM_TOL, name
        assert _rel(state.v[name], want_s.v[name]) <= ADAM_TOL, name


def test_weight_decay_only_on_matrices():
    """With zero gradients a step moves only the leaves the reference
    decays (ndim >= 2 in its layout: the matrices and the layers' stacked
    (L, d) norm scales; not ``ln_f``), each by exactly lr * wd * p."""
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    params = get_model(cfg).init_params(0, "cpu")
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    ocfg = opt.AdamWConfig(lr=1e-2, warmup_steps=1, weight_decay=0.5)
    params, _, m = opt.update(ocfg, grads, opt.init(params), params)
    decayed = set()
    for name, p in params.named_parameters():
        if p.ndim >= 2 or name.startswith("layers."):
            decayed.add(name.split(".")[-1])
            want = before[name] - m["lr"] * 0.5 * before[name]
            torch.testing.assert_close(p.detach(), want, rtol=1e-6,
                                       atol=1e-7)
        else:
            assert torch.equal(p.detach(), before[name]), name
    assert {"ln1", "ln2", "table", "wq", "w_down"} <= decayed
    assert "ln_f" not in decayed


def test_gradient_clipping_at_the_global_norm():
    """A gradient of global norm 10 with ``grad_clip`` 1: the first step's
    moments are those of the gradient scaled to norm 1."""
    params = torch.nn.ParameterDict({"w": torch.nn.Parameter(
        torch.zeros(2, 2))})
    grads = {"w": torch.full((2, 2), 5.0)}  # norm 10
    state = opt.AdamWState(step=torch.zeros((), dtype=torch.int32),
                           m={"w": torch.zeros(2, 2)},
                           v={"w": torch.zeros(2, 2)})
    _, state, m = opt.update(opt.AdamWConfig(grad_clip=1.0), grads, state,
                             params)
    assert float(m["grad_norm"]) == pytest.approx(10.0)
    torch.testing.assert_close(state.m["w"], torch.full((2, 2), 0.1 * 0.5))


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------
def test_three_steps_match_reference(ref):
    """Three fp32 steps (lr 1e-4, eps 1e-6: :data:`STEP_OCFG`) from the
    reference's
    parameters and batches: every parameter within 1e-5 of its max |p|,
    loss, ce, aux, grad_norm and lr within 1e-5."""
    params = _port_params(ref)
    state = opt.init(params)
    step = make_train_step(get_model(ref.cfg), opt.AdamWConfig(**STEP_OCFG))
    for i, (jp, jm) in enumerate(ref.trail):
        params, state, m = step(params, state, _batch(ref.batches[i]))
        assert sorted(m) == sorted(jm)
        for k, v in m.items():
            assert v.ndim == 0
            assert float(v) == pytest.approx(float(jm[k]), rel=TOL, abs=1e-7)
        want = convert.lm_grads_from_reference(jp, ref.cfg, "cpu")
        for name, p in params.named_parameters():
            assert _rel(p.detach(), want[name]) <= TOL, (i, name)


def test_microbatches_match_one_batch(ref):
    """``microbatches=4`` against 1 on one fp32 batch of 8: the loss within
    1e-4 and every updated parameter within 5e-5
    (tests/test_train_loop.py:36-57)."""
    cfg = ref.cfg
    data = SyntheticData(cfg, ShapeSpec("t", SEQ, 8, "train"), device="cpu")
    batch = data.batch_at(0)
    base = _port_params(ref)
    out = {}
    for mb in (1, 4):
        params = copy.deepcopy(base)
        step = make_train_step(get_model(cfg), opt.AdamWConfig(**OCFG),
                               microbatches=mb)
        params, _, m = step(params, opt.init(params), batch)
        out[mb] = (params, float(m["loss"]))
    assert abs(out[1][1] - out[4][1]) < 1e-4
    for (name, a), b in zip(out[1][0].named_parameters(),
                            out[4][0].parameters()):
        assert float((a - b).detach().abs().max()) < MB_TOL, name


def test_bf16_losses_track_reference():
    """Five bf16 steps (the smoke config's own dtypes) from the reference's
    parameters and batches: each loss within 2e-2 of the reference's."""
    r = _reference({})
    params = _port_params(r)
    state = opt.init(params)
    step = make_train_step(get_model(r.cfg), opt.AdamWConfig(**STEP_OCFG))
    jp, js = r.jparams, jopt.init(r.jparams)
    for i in range(BF16_STEPS):
        jp, js, jm = r.step(jp, js, r.batches[i])
        params, state, m = step(params, state, _batch(r.batches[i]))
        assert abs(float(m["loss"]) - float(jm["loss"])) < BF16_LOSS_TOL, i


def test_loss_decreases_on_the_ports_data():
    """tests/test_train_loop.py:16-33 on the port's own data: 30 bf16 steps
    at 8 x 64, the last five losses' mean 0.3 under the first five's."""
    cfg = configs.get_smoke_config(ARCH)
    model = get_model(cfg)
    data = SyntheticData(cfg, ShapeSpec("tiny", 64, 8, "train"),
                         device="cpu")
    params = model.init_params(0, "cpu")
    state = opt.init(params)
    step = make_train_step(model, opt.AdamWConfig(
        lr=3e-3, warmup_steps=5, total_steps=60, weight_decay=0.0))
    losses = []
    for i in range(30):
        params, state, m = step(params, state, data.batch_at(i))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3, losses


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------
def test_data_is_stateless_markov_and_int32():
    """``batch_at(17)`` from two instances equal; labels follow
    ``perm[tokens]`` in more than half the positions (signal 0.7); tokens
    are the labels shifted by one; int32; the chain equals a loop over
    positions."""
    cfg = configs.get_smoke_config("yi-6b")
    shape = ShapeSpec("tiny", 16, 4, "train")
    d1, d2 = (SyntheticData(cfg, shape, device="cpu") for _ in range(2))
    b1, b2 = d1.batch_at(17), d2.batch_at(17)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert torch.equal(b1["labels"], b2["labels"])
    assert b1["tokens"].dtype == b1["labels"].dtype == torch.int32
    assert not torch.equal(b1["tokens"], d1.batch_at(18)["tokens"])
    hit = (d1.perm[b1["tokens"].long()] == b1["labels"]).float().mean()
    assert hit > 0.5
    assert torch.equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])
    # Every label is perm[token] or a fresh draw: the chain's definition.
    big = SyntheticData(cfg, ShapeSpec("t", 300, 3, "train"),
                        DataConfig(seed=5, signal=0.9), device="cpu")
    b = big.batch_at(2)
    perm = big.perm
    assert (perm[b["tokens"].long()] == b["labels"]).float().mean() > 0.85
    assert int(b["labels"].max()) < cfg.vocab and int(b["labels"].min()) >= 0


def test_data_matches_a_loop_over_positions():
    """The binary-lifting chain gives the sequential chain's tokens, from
    the same draws."""
    cfg = configs.get_smoke_config(ARCH)
    data = SyntheticData(cfg, ShapeSpec("t", 70, 3, "train"), device="cpu")
    got = data.batch_at(4)
    gen = torch.Generator().manual_seed((0 << 32) | 4)
    first = torch.randint(0, cfg.vocab, (3, 1), generator=gen)
    noise = torch.randint(0, cfg.vocab, (3, 70), generator=gen)
    sig = torch.rand((3, 70), generator=gen) < 0.7
    tok, labels = first[:, 0], []
    for t in range(70):
        tok = torch.where(sig[:, t], data.perm[tok], noise[:, t])
        labels.append(tok)
    assert torch.equal(got["labels"].long(), torch.stack(labels, 1))


@pytest.mark.parametrize("arch", ["whisper-small", "llama-3.2-vision-11b"])
def test_data_refuses_context_families(arch):
    """The context families' batches carry a ``ctx`` (B, n_context_tokens,
    d_model) in the compute type, standard normal (mean within 0.05, std
    within 0.05 of 1 over the smoke sizes' 8192-16384 draws), a pure
    function of the index; the token families' carry none."""
    cfg = configs.get_smoke_config(arch)
    shape = ShapeSpec("t", 8, 2, "train")
    data = SyntheticData(cfg, shape, device="cpu")
    batch = data.batch_at(3)
    t = (cfg.cross or cfg.encdec).n_context_tokens
    ctx = batch["ctx"]
    assert ctx.shape == (2, t, cfg.d_model) and ctx.dtype == cfg.cdtype
    assert abs(ctx.float().mean().item()) < 0.05
    assert abs(ctx.float().std().item() - 1) < 0.05
    assert torch.equal(ctx, SyntheticData(cfg, shape, device="cpu")
                       .batch_at(3)["ctx"])
    assert not torch.equal(ctx, data.batch_at(4)["ctx"])
    assert "ctx" not in SyntheticData(configs.get_smoke_config("yi-6b"),
                                      shape, device="cpu").batch_at(3)


# ---------------------------------------------------------------------------
# The probe
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def planted():
    """tests/test_probes.py's input and the reference's statistics."""
    key = jax.random.PRNGKey(0)
    h = jax.random.normal(key, (4, 64, 32))
    u = jax.random.normal(jax.random.PRNGKey(1), (32, 3))
    outliers = jnp.where(
        jax.random.uniform(jax.random.PRNGKey(2), h.shape) < 0.01, 50.0, 0.0)
    h = (h @ u @ u.T) + outliers
    stats = jprobes.activation_probe(h, rank=4, num_clients=4,
                                     outer_iters=30)
    return np.asarray(h), _np(stats)


def test_probe_recovers_planted_structure(planted):
    """tests/test_probes.py's bars on the port's probe (its own initial
    factors), and the same 8 top outlier channels as the reference's."""
    h, want = planted
    stats = activation_probe(torch.from_numpy(h.copy()), rank=4,
                             num_clients=4, outer_iters=30)
    assert float(stats["energy_low_rank"]) > 0.7
    assert abs(float(stats["outlier_fraction"]) - 0.01) < 0.01
    assert float(stats["residual"]) < 0.1
    assert stats["top_outlier_channels"].shape == (8,)
    assert set(stats["top_outlier_channels"].tolist()) == set(
        want["top_outlier_channels"].tolist())


def test_probe_statistics_match_reference(planted, monkeypatch):
    """From the reference's initial factors (its ``make_problem`` at the
    probe's default ``PRNGKey(0)``, carried by
    ``convert.problem_from_reference`` into the port's solve), the probe's
    statistics within 1e-3 of the reference's and the top outlier channels
    the same set.  (From the port's own draw, 30 rounds leave
    energy_low_rank 1.04e-3 from the reference's.)"""
    from repro.core.factorized import DCFConfig as JDCFConfig
    from repro_torch.training import probes

    jdcf = importlib.import_module("repro.core.dcf_pca")
    port_dcf = importlib.import_module("repro_torch.core.dcf_pca")

    def carried(x, cfg, num_clients, device):
        jcfg = JDCFConfig.tuned(cfg.rank, outer_iters=cfg.outer_iters)
        problem = jax.jit(lambda m: jdcf.make_problem(
            m, jcfg, num_clients, jax.random.PRNGKey(0)))(x.numpy())
        return port_dcf.solve_problem(
            convert.problem_from_reference(problem, device), cfg,
            n=x.shape[1])

    monkeypatch.setattr(probes, "dcf_pca", carried)
    h, want = planted
    stats = probes.activation_probe(torch.from_numpy(h.copy()), rank=4,
                                    num_clients=4, outer_iters=30)
    for k in ("energy_low_rank", "energy_sparse", "outlier_fraction",
              "residual"):
        assert abs(float(stats[k]) - float(want[k])) <= PROBE_TOL, k
    assert set(stats["top_outlier_channels"].tolist()) == set(
        want["top_outlier_channels"].tolist())


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------
LAUNCH = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
          "--seq", "16", "--log-every", "1"]


class _Stop(Exception):
    pass


def test_launcher_runs_and_resumes_bit_exact(tmp_path, monkeypatch, capsys):
    """``launch/train.py --smoke --device cpu``: a run stopped after its
    first checkpoint (step 2) and relaunched ends on the uninterrupted
    run's bits (parameters and optimizer state)."""
    from repro_torch.launch import train

    full = train.main(LAUNCH + ["--ckpt-dir", str(tmp_path / "a"),
                                "--ckpt-every", "2"])
    assert np.isfinite(full["final_loss"]) and len(full["log"]) == 4
    save = ckpt.save

    def save_then_stop(*args, **kw):
        save(*args, **kw)
        raise _Stop

    monkeypatch.setattr(ckpt, "save", save_then_stop)
    with pytest.raises(_Stop):
        train.main(LAUNCH + ["--ckpt-dir", str(tmp_path / "b"),
                             "--ckpt-every", "2"])
    monkeypatch.setattr(ckpt, "save", save)
    assert ckpt.latest_step(str(tmp_path / "b")) == 2
    resumed = train.main(LAUNCH + ["--ckpt-dir", str(tmp_path / "b"),
                                   "--ckpt-every", "2"])
    assert "resumed from step 2" in capsys.readouterr().out
    a = dict(full["params"].named_parameters())
    for name, p in resumed["params"].named_parameters():
        assert torch.equal(p, a[name]), name
    sa, sb = full["opt_state"], resumed["opt_state"]
    assert int(sa.step) == int(sb.step) == 4
    for name in sa.m:
        assert torch.equal(sa.m[name], sb.m[name])
        assert torch.equal(sa.v[name], sb.v[name])


def test_launcher_robust_agg_needs_ranks():
    """``--robust-agg`` on one device raises the reference's text."""
    from repro_torch.launch import train

    with pytest.raises(ValueError,
                       match="robust aggregation needs a DP mesh axis"):
        train.main(LAUNCH + ["--robust-agg"])


# ---------------------------------------------------------------------------
# Sharding rules
# ---------------------------------------------------------------------------
def _mesh(names, shape):
    return types.SimpleNamespace(mesh_dim_names=names,
                                 mesh=torch.zeros(shape, dtype=torch.int64))


def test_sharding_rules_resolve_and_pspec():
    rules = sharding.SINGLE_POD
    assert rules.resolve("dp") == ("data",) and rules.resolve(None) is None
    assert rules.pspec("dp", None, "tp") == (("data",), None, "model")
    assert sharding.MULTI_POD.pspec("fsdp") == (("pod", "data"),)
    with pytest.raises(ValueError, match="unknown logical axis"):
        rules.resolve("bogus")
    fields = {f.name for f in dataclasses.fields(sharding.ShardingRules)}
    assert fields == {"dp", "fsdp", "tp", "sp", "ep", "mesh_sizes"}


@pytest.mark.parametrize("names,shape,want", [
    (("pod", "data", "model"), (2, 2, 1), "MULTI_POD"),
    (("data",), (4,), "SINGLE_POD"),
    (("x",), (2,), "SINGLE_DEVICE"),
])
def test_rules_for_mesh(names, shape, want):
    rules = sharding.rules_for_mesh(_mesh(names, shape))
    base = getattr(sharding, want)
    assert dataclasses.replace(rules, mesh_sizes=()) == base
    assert rules.mesh_sizes == tuple(zip(names, shape))


def test_constrain_is_the_identity_or_refuses():
    """The identity for data axes, None and model axes of size 1 (or absent
    from the mesh); a model-parallel binding over more than one rank
    raises NotImplementedError naming ROADMAP.md."""
    x = torch.ones(4, 3)
    data4 = sharding.rules_for_mesh(_mesh(("data",), (4,)))
    assert sharding.constrain(x, data4, "dp", None, "tp") is x
    ones = sharding.rules_for_mesh(_mesh(("data", "model"), (4, 1)))
    assert sharding.constrain(x, ones, "fsdp", "sp", "ep") is x
    assert sharding.constrain(x, sharding.SINGLE_DEVICE, "tp") is x
    tp2 = sharding.rules_for_mesh(_mesh(("data", "model"), (2, 2)))
    assert sharding.constrain(x, tp2, "dp") is x
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        sharding.constrain(x, tp2, "dp", "tp")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(get_model(configs.get_smoke_config(ARCH)),
                        opt.AdamWConfig(), tp2)


# ---------------------------------------------------------------------------
# Serving after training; the flash refusal; CompressConfig
# ---------------------------------------------------------------------------
def test_decode_after_a_train_step():
    """After a train step (parameters that require grad) ``generate`` gives
    the tokens of fresh parameters holding the same values, and the
    flash path (the plain version on the CPU) serves them too."""
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    model = get_model(cfg)
    params = model.init_params(0, "cpu")
    data = SyntheticData(cfg, ShapeSpec("t", 16, 2, "train"), device="cpu")
    step = make_train_step(model, opt.AdamWConfig(lr=1e-2, warmup_steps=1))
    params, _, _ = step(params, opt.init(params), data.batch_at(0))
    assert all(p.requires_grad for p in params.parameters())
    fresh = model.empty_params("cpu")
    with torch.no_grad():
        for a, b in zip(fresh.parameters(), params.parameters()):
            a.copy_(b)
    prompt = data.batch_at(1)["tokens"]
    scfg = ServeConfig(max_new_tokens=4)
    got = generate(model, params, prompt, scfg)
    assert torch.equal(got, generate(model, fresh, prompt, scfg))
    flash = get_model(cfg.replace(flash_attention=True))
    assert torch.equal(generate(flash, params, prompt, scfg), got)


def test_training_takes_the_chunked_attention():
    """With the config's flash attention on, training still takes the
    chunked attention (the flash wrapper would refuse the grad-requiring
    inputs): the loss and gradients equal the flash-off config's bit for
    bit."""
    cfg = configs.get_smoke_config(ARCH).replace(**F32)
    base = get_model(cfg).init_params(0, "cpu")
    batch = SyntheticData(cfg, ShapeSpec("t", 16, 2, "train"),
                          device="cpu").batch_at(0)
    off = _grads(cfg, copy.deepcopy(base), batch)
    on = _grads(cfg.replace(flash_attention=True), copy.deepcopy(base),
                batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[1][n], g) for n, g in off[1].items())


def test_flash_wrapper_refuses_autograd():
    """The flash wrapper has no backward: with grad mode on and an input
    that requires grad it raises; under no_grad it returns."""
    q = torch.randn(1, 8, 2, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, v)
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).shape == q.shape
    assert fa.flash_attention(q.detach(), k, v).shape == q.shape


def test_compress_config_dcf_differs_only_in_impl():
    """``CompressConfig.dcf()`` equals the reference's field for field but
    ``impl``: "auto" (the card's kernels on CUDA gradients) where the
    reference pins "ref"."""
    for kw in ({}, {"rank": 4, "rounds": 2, "topk_frac": 0.1}):
        got = gc.CompressConfig(**kw).dcf()
        want = jgc.CompressConfig(**kw).dcf()
        diff = {f.name for f in dataclasses.fields(got)
                if getattr(got, f.name) != getattr(want, f.name)}
        assert diff == {"impl"}
        assert (got.impl, want.impl) == ("auto", "ref")
