"""Whether a model served over a model axis of 2 ranks gives one device's
bits: the SSD mixer's ops one by one (an SSM config), then the whole model.

    PYTHONPATH=src python tools/tp_bits.py [--arch mamba2-780m]
        [--cut '{"n_layers": 20}'] [--device cuda] [--batch 4]
        [--prompt 2048] [--steps 8]

``--arch`` at full width (and full depth unless ``--cut`` replaces config
fields), random bf16 weights from seed 0 (``Model.init_params``), cross
gates at 0.5 and a standard normal context for the ``vlm`` and ``encdec``
families, as chip_smoke's serve phases.  The 2 ranks are threads of this
process on one device; their all-reduce adds the ranks' tensors in rank
order and their all-gather stacks them, so only the port's arithmetic
differs from one device's, not a transport.

*Ops* (an SSM config; rank 0's heads against one device's at the
prefill's and a decode step's shapes): the column-split products into
d_in (``w_z``'s columns, as the rank holds them, against one device's
whole product and against its product with a view of those columns), the
chunk step of the SSD scan on the rank's heads, the decode step's
contraction of C with the state, each with all heads against a rank's
half (which is why one device runs them by halves), the mixer's gated
output (its two sums over d_in), and the whole mixer (``ssd_prefill``,
one ``ssd_decode`` step and the state after it).

*Query columns* (a config with attention): the first attention layer's
``wq`` product, its first half of the columns from the whole product
and from a view of those columns, against a rank's own half.

*Flips* (``--flip F``): one device's logits with one bf16 ulp added to a
fraction F of the residual stream after its first, or its last, prefill
layer, against its own, beside its bf16 logits' distance from the fp32
model of its weights.

*Model*: the prefill of ``--prompt`` random tokens and ``--steps`` decode
steps fed random tokens (the same on one device and on the ranks): the
first layer whose prefill output differs from one device's, the logits'
largest |difference| at every step, and the greedy tokens held where one
device's top-2 margin passes 2 x 8e-2 (chip_smoke's ``SERVE_TP_MARGIN``)
that differ.

A bf16 model carries any bit that differs in an early layer to its
logits' whole bf16 noise (for mamba2-780m's 48 layers ~1.2, the distance
of its bf16 logits from its fp32 model's), so 2 ranks pass that token
gate, and a gate on the fp32 model's logits that the one device barely
meets, only where they are one device's bits.  The last line is one JSON
object with every number.  The port's elementwise CPU kernels treat a
tensor's tail apart from its vectorised body and its CPU products do not
always give a column slice's bits, so on the CPU ranks can differ in the
last bit where on the card they do not: judge bits on the card.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
import types

import torch

from repro_torch import configs
from repro_torch.distributed import sharding
from repro_torch.models import CONTEXT_FAMILIES, blocks, get_model, lm, ssm
from repro_torch.models.parallel import TensorParallel
from repro_torch.models.params import (
    Params, module_specs, shard_specs, shard_tensor,
)

MARGIN = 2 * 8e-2
RANKS = 2
GATE = 0.5  # chip_smoke's SERVE_CROSS_GATE


class ThreadComm:
    """A model axis of ``size`` threads of one process."""

    def __init__(self, size: int, index: int, board: dict):
        self.model_size, self.model_index, self.board = size, index, board

    def _exchange(self, x):
        self.board[self.model_index] = x.clone()
        self.board["barrier"].wait()
        parts = [self.board[i] for i in range(self.model_size)]
        self.board["barrier"].wait()
        return parts

    def all_reduce(self, x, over):
        parts = self._exchange(x)
        out = parts[0].clone()
        for p in parts[1:]:
            out = out + p
        return out

    def all_gather(self, x, over):
        return torch.stack(self._exchange(x))


def on_ranks(fn):
    """``fn(index, TensorParallel)`` on RANKS threads; their results."""
    board = dict(barrier=threading.Barrier(RANKS))
    out, errors = {}, []

    def run(i):
        try:
            out[i] = fn(i, TensorParallel(ThreadComm(RANKS, i, board)))
        except BaseException as e:  # re-raised in the caller's thread
            errors.append(e)
            board["barrier"].abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(RANKS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    return [out[i] for i in range(RANKS)]


def rank_params(cfg, whole, specs, index: int):
    """Rank ``index``'s slices of ``whole`` (a Params of ``specs``)."""
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 mesh=torch.zeros((1, RANKS),
                                                  dtype=torch.int64))
    rules = sharding.rules_for_mesh(mesh)
    device = next(whole.parameters()).device
    local = Params(shard_specs(specs, rules, {"data": 0, "model": index}),
                   device)
    named = dict(whole.named_parameters())
    local_specs = module_specs(local)
    with torch.no_grad():
        for name, p in local.named_parameters():
            p.copy_(shard_tensor(named[name], local_specs[name]))
    return local


def _equal(a, b) -> dict:
    return dict(equal=bool(torch.equal(a, b)),
                differing=float((a != b).float().mean()))


@torch.no_grad()
def ops(cfg, params, batch: int, prompt: int) -> dict:
    """Rank 0's SSD ops against one device's, at the model's first layer's
    weights."""
    s = cfg.ssm
    dev = params.embed.table.device
    whole = next(layer.mixer for layer in params.layers
                 if hasattr(layer.mixer, "w_z"))
    local = rank_params(cfg, whole, ssm.ssm_specs(cfg), 0)
    lay = ssm.head_split(cfg, RANKS, 0)
    heads, half = lay.heads, lay.heads * s.head_dim
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for name, rows in (("prefill", prompt), ("decode", 1)):
        h = torch.randn(batch, rows, cfg.d_model, generator=gen,
                        device=dev).to(cfg.cdtype)
        out[f"w_z_columns@{name}"] = _equal(
            h @ local.w_z, (h @ whole.w_z)[..., :half])
        out[f"w_z_column_view@{name}"] = _equal(
            h @ local.w_z, h @ whole.w_z[:, :half])
    cl = s.chunk
    f32 = torch.float32

    def rand(*shape, dtype=f32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    xc = rand(batch, cl, 2 * heads, s.head_dim, dtype=cfg.cdtype)
    bc = rand(batch, cl, s.n_groups, s.d_state, dtype=cfg.cdtype)
    cc = rand(batch, cl, s.n_groups, s.d_state, dtype=cfg.cdtype)
    dtc = torch.rand(batch, cl, 2 * heads, generator=gen, device=dev) * 0.1
    dac = -dtc
    state = rand(batch, 2 * heads, s.d_state, s.head_dim)
    st1, y1 = ssm._chunk_step(state, xc, bc, cc, dac, dtc, cfg)
    mine = slice(0, heads)
    st2, y2 = ssm._chunk_step(state[:, mine].contiguous(),
                              xc[:, :, mine].contiguous(), bc, cc,
                              dac[..., mine].contiguous(),
                              dtc[..., mine].contiguous(), cfg)
    out["chunk_step_y"] = _equal(y2, y1[:, :, mine])
    out["chunk_step_state"] = _equal(st2, st1[:, mine])
    c_t = rand(batch, s.n_groups, s.d_state)
    hg = 2 * heads // s.n_groups
    y1 = torch.einsum("bgn,bghnp->bghp", c_t, state.reshape(
        batch, s.n_groups, hg, s.d_state, s.head_dim))
    y2 = torch.einsum("bgn,bghnp->bghp", c_t,
                      state[:, mine].contiguous().reshape(
                          batch, s.n_groups, hg // 2, s.d_state,
                          s.head_dim))
    out["decode_contraction"] = _equal(y2, y1[:, :, :hg // 2])
    for name, rows in (("prefill", prompt), ("decode", 1)):
        y = rand(batch, rows, 2 * half, dtype=cfg.cdtype)
        z = rand(batch, rows, 2 * half, dtype=cfg.cdtype)
        want = ssm._gated_out(whole, y, z, cfg, ssm.head_split(cfg), None)
        got = on_ranks(lambda i, tp: ssm._gated_out(
            rank_params(cfg, whole, ssm.ssm_specs(cfg), i),
            y[..., i * half:(i + 1) * half].contiguous(),
            z[..., i * half:(i + 1) * half].contiguous(), cfg,
            ssm.head_split(cfg, RANKS, i), tp))
        out[f"gated_out@{name}"] = _equal(got[0], want)
    h = rand(batch, prompt + 1, cfg.d_model, dtype=cfg.cdtype)
    want, state = ssm.ssd_prefill(whole, h[:, :-1], cfg)
    step, state = ssm.ssd_decode(whole, h[:, -1:], state, cfg)

    def mixer(i, tp):
        mine = rank_params(cfg, whole, ssm.ssm_specs(cfg), i)
        got, st = ssm.ssd_prefill(mine, h[:, :-1], cfg, tp)
        return (got, *ssm.ssd_decode(mine, h[:, -1:], st, cfg, tp))

    got, got_step, got_state = on_ranks(mixer)[0]
    out["mixer@prefill"] = _equal(got, want)
    out["mixer@decode"] = _equal(got_step, step)
    out["mixer_state"] = _equal(got_state.ssm, state.ssm[:, :heads])
    return out


@torch.no_grad()
def query_columns(cfg, params, batch: int, prompt: int) -> dict:
    """The first attention layer's ``wq`` product at the prefill's and a
    decode step's rows: its first half of the columns taken from the whole
    product and from the product with a view of those columns, against
    the product with those columns as a rank holds them."""
    layer = next((layer.mixer for layer in params.layers
                  if hasattr(layer.mixer, "wq")), None)
    if layer is None:
        return {}
    dev = params.embed.table.device
    gen = torch.Generator(device=dev).manual_seed(2)
    w = layer.wq
    half = w.shape[1] // 2
    out = {}
    for name, rows in (("prefill", prompt), ("decode", 1)):
        h = torch.randn(batch, rows, cfg.d_model, generator=gen,
                        device=dev).to(cfg.cdtype)
        mine = h @ w[:, :half].contiguous()
        out[f"wq_whole_product@{name}"] = _equal((h @ w)[..., :half], mine)
        out[f"wq_column_view@{name}"] = _equal(h @ w[:, :half], mine)
    return out


class LayerTrace:
    """Each layer's prefill output, by thread."""

    def __init__(self):
        self.outs: dict[int, list] = {}
        self._apply = blocks.layer_apply

    def __enter__(self):
        def apply(*args, **kw):
            x, aux, cache = self._apply(*args, **kw)
            if kw.get("mode") == "prefill":
                self.outs.setdefault(threading.get_ident(), []).append(
                    x.clone())
            return x, aux, cache
        blocks.layer_apply = apply
        return self

    def __exit__(self, *exc):
        blocks.layer_apply = self._apply


@torch.no_grad()
def serve(model, params, tokens, forced, ctx=None, tp=None):
    """The prefill's last logits and each forced step's (steps + 1, B,
    V) in fp32."""
    b, s = tokens.shape
    cfg = model.cfg
    caches = lm.init_caches(model._fns.cache_specs(
        cfg, b, s + forced.shape[1], tp), tokens.device)
    context = (ctx,) if cfg.family in CONTEXT_FAMILIES else ()
    logits, caches = model._fns.prefill(params, tokens, cfg, caches,
                                        *context, tp=tp)
    steps = [logits.float()]
    for i in range(forced.shape[1]):
        pos = torch.full((), s + i, dtype=torch.int32, device=tokens.device)
        logits, caches = model._fns.decode(params, forced[:, i:i + 1],
                                           caches, pos, cfg, tp=tp)
        steps.append(logits.float())
    return torch.stack(steps)


def whole_model(cfg, params, batch: int, prompt: int, steps: int) -> dict:
    model = get_model(cfg)
    dev = params.embed.table.device
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt + steps),
                           device=dev, generator=gen)
    tokens, forced = tokens[:, :prompt], tokens[:, prompt:]
    ctx = None
    if cfg.family in CONTEXT_FAMILIES:
        ctx = torch.randn(batch, lm.ctx_len(cfg), cfg.d_model, device=dev,
                          generator=gen).to(cfg.cdtype)
    locals_ = [rank_params(cfg, params, model.specs(), i)
               for i in range(RANKS)]
    with LayerTrace() as trace:
        want = serve(model, params, tokens, forced, ctx)
        single = trace.outs.pop(threading.get_ident())
        got = on_ranks(lambda i, tp: (serve(model, locals_[i], tokens,
                                            forced, ctx, tp),
                                      trace.outs[threading.get_ident()]))
    layers = [next((n for n, (a, b) in enumerate(zip(rank, single))
                    if not torch.equal(a, b)), None)
              for _, rank in got]
    top2 = want.topk(2, dim=-1).values
    held = (top2[..., 0] - top2[..., 1]) > MARGIN
    rows = []
    for i, (logits, _) in enumerate(got):
        differ = held & (logits.argmax(-1) != want.argmax(-1))
        rows.append(dict(
            rank=i, first_differing_layer=layers[i],
            logits_equal=bool(torch.equal(logits, want)),
            logits_abs_max_by_step=[float(v) for v in
                                    (logits - want).abs().amax((1, 2))],
            held=int(held.sum()), differing_where_held=int(differ.sum())))
    return dict(ranks=rows)


class Flip:
    """One bf16 ulp added to a ``fraction`` of the residual stream's
    entries (chosen from a seeded generator) after prefill layer
    ``layer``."""

    def __init__(self, layer: int, fraction: float):
        self.layer, self.fraction, self.seen = layer, fraction, 0
        self._apply = blocks.layer_apply

    def __enter__(self):
        def apply(*args, **kw):
            x, aux, cache = self._apply(*args, **kw)
            if kw.get("mode") == "prefill":
                if self.seen == self.layer:
                    gen = torch.Generator(device=x.device).manual_seed(9)
                    hit = torch.rand(x.shape, generator=gen,
                                     device=x.device) < self.fraction
                    up = (x.view(torch.int16) + 1).view(x.dtype)
                    x = torch.where(hit, up, x)
                self.seen += 1
            return x, aux, cache
        blocks.layer_apply = apply
        return self

    def __exit__(self, *exc):
        blocks.layer_apply = self._apply


def flips(cfg, params, batch: int, prompt: int, steps: int,
          fraction: float) -> dict:
    """How far one device's logits move when ``fraction`` of the residual
    after the first or the last layer is one bf16 ulp off, beside the
    distance of its bf16 logits from the fp32 model of its weights (the
    same tokens)."""
    model = get_model(cfg)
    dev = params.embed.table.device
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(0, cfg.vocab, (batch, prompt + steps),
                           device=dev, generator=gen)
    tokens, forced = tokens[:, :prompt], tokens[:, prompt:]
    ctx = None
    if cfg.family in CONTEXT_FAMILIES:
        ctx = torch.randn(batch, lm.ctx_len(cfg), cfg.d_model, device=dev,
                          generator=gen).to(cfg.cdtype)
    want = serve(model, params, tokens, forced, ctx)
    out = {}
    for layer in (0, cfg.n_layers - 1):
        with Flip(layer, fraction):
            got = serve(model, params, tokens, forced, ctx)
        diff = (got - want).abs()
        out[f"flip_after_layer_{layer}"] = dict(
            abs_max=float(diff.max()), abs_mean=float(diff.mean()))
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    model32 = get_model(cfg.replace(**f32))
    params32 = model32.empty_params(dev)
    with torch.no_grad():
        for (_, p), (_, q) in zip(params32.named_parameters(),
                                  params.named_parameters(), strict=True):
            p.copy_(q.float())
    ref = serve(model32, params32, tokens, forced,
                None if ctx is None else ctx.float())
    diff = (want - ref).abs()
    out["bf16_vs_fp32_model"] = dict(abs_max=float(diff.max()),
                                     abs_mean=float(diff.mean()))
    return dict(fraction=fraction, **out)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--cut", default="{}",
                    help="config fields to replace, as JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--flip", type=float, default=0.0,
                    help="also move this fraction of the residual by an "
                         "ulp after the first and the last layer")
    args = ap.parse_args()
    cut = json.loads(args.cut)
    cfg = configs.get_config(args.arch).replace(**cut)
    t0 = time.perf_counter()
    params = get_model(cfg).init_params(0, args.device)
    with torch.no_grad():
        for layer in params.layers:
            if hasattr(layer, "gate"):
                layer.gate.fill_(GATE)
    result = dict(arch=cfg.name, cut=cut, layers=cfg.n_layers,
                  batch=args.batch, prompt=args.prompt, steps=args.steps,
                  device=args.device)
    if args.device.startswith("cuda"):
        result["card"] = torch.cuda.get_device_name(0)
    result["ops"] = (ops(cfg, params, args.batch, args.prompt)
                     if cfg.ssm is not None else {})
    result["ops"].update(query_columns(cfg, params, args.batch,
                                       args.prompt))
    for k, v in result["ops"].items():
        print(f"op {k}: {v}", flush=True)
    result["model"] = whole_model(cfg, params, args.batch, args.prompt,
                                  args.steps)
    for row in result["model"]["ranks"]:
        print(f"model {row}", flush=True)
    if args.flip:
        result["flips"] = flips(cfg, params, args.batch, args.prompt,
                                args.steps, args.flip)
        print(f"flips {result['flips']}", flush=True)
    result["seconds"] = time.perf_counter() - t0
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
