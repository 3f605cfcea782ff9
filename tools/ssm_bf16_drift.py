"""How far mamba2-780m's bf16 logits lie from its fp32 model, in the JAX
reference and in the PyTorch port, on the CPU, from one set of weights.

    PYTHONPATH=src python tools/ssm_bf16_drift.py [--layers 4,12]
        [--batch 1] [--prompt 512] [--json out.json]

For each depth in ``--layers``, mamba2-780m at its full width (d_model
1536, 48 SSD heads of 64, d_state 128, chunk 256, vocabulary 50280) cut
to that many layers: the reference materialises bf16 weights from
``PRNGKey(0)`` (the shipped config's dtypes); the fp32 model is the same
weights upcast, with fp32 compute; ``repro_torch.convert`` carries both to
the port.  Each of the four runs (reference bf16 and fp32, port bf16 and
fp32) computes the logits at every position of one random prompt through
its prefill layers (``mode="prefill"``), the final norm and the unembed.

Printed for each pair: the largest and mean |difference|, the excess
past the bf16 bound |a - b| <= 8e-2 + 8e-2 |b| (tests/test_torch_lm.py,
chip_smoke's ``SERVE_TP_BAR``), and greedy-token flips: the positions
where the second run's top-2 margin passes 2 x 8e-2 (chip_smoke's
``SERVE_TP_MARGIN``) and the first run's argmax differs from its.  The
pairs: each bf16 run against the reference's fp32 model (the drift that
chip_smoke's ``serve_ssm`` measures on the card against the port's fp32
model), the port's bf16 against the reference's bf16 (two bf16 runs of
other arithmetic, as ``serve_ssm_tp`` against ``serve_ssm``), and the
port's fp32 against the reference's (the port's fidelity).  The last line
is one JSON object with every number.

It is run by hand (about a minute a depth of 12 on 8 cores, ~3 GB at 12
layers; not a test): it imports both packages, which only tests and tools
outside the port may do.
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.distributed.sharding import SINGLE_DEVICE
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import params as jpm
from repro_torch import configs, convert
from repro_torch.models import blocks, lm
from repro_torch.models.layers import embed, logits, rmsnorm

ARCH = "mamba2-780m"
BAR = 8e-2
MARGIN = 2 * BAR
F32 = dict(param_dtype="float32", compute_dtype="float32")


def reference_logits(cfg, params, tokens: np.ndarray) -> np.ndarray:
    """The reference's logits at every position (B, S, V_pad), fp32."""
    def run(p, t):
        b, s = t.shape
        positions = jnp.broadcast_to(jnp.arange(s, dtype=jnp.int32), (b, s))
        x = jlayers.embed(p["embed"], t, cfg, SINGLE_DEVICE)
        x, _, _ = jlm._run_segments(p, x, cfg, SINGLE_DEVICE, mode="prefill",
                                    positions=positions)
        x = jlayers.rmsnorm(p["ln_f"], x, cfg.norm_eps)
        return x @ jlayers.unembed_matrix(p["embed"]).astype(x.dtype)

    out = jax.jit(run)(params, jnp.asarray(tokens))
    return np.asarray(out.astype(jnp.float32))


@torch.no_grad()
def port_logits(cfg, params, tokens: np.ndarray) -> np.ndarray:
    """The port's logits at every position (B, S, V_pad), fp32."""
    t = torch.from_numpy(tokens).long()
    positions = torch.arange(t.shape[1]).expand(t.shape)
    x = embed(params.embed, t, cfg)
    for layer, (mixer, ffn) in zip(params.layers, lm.layer_plan(cfg),
                                   strict=True):
        x, _, _ = blocks.layer_apply(layer, x, cfg=cfg, mode="prefill",
                                     mixer=mixer, ffn=ffn,
                                     positions=positions)
    x = rmsnorm(params.ln_f, x, cfg.norm_eps)
    return logits(params.embed, x).float().numpy()


def compare(got: np.ndarray, want: np.ndarray) -> dict:
    """``got`` against ``want``: |diff| and the bound's excess, and the
    greedy flips where ``want``'s top-2 margin passes MARGIN."""
    diff = np.abs(got - want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > MARGIN
    flips = sure & (got.argmax(-1) != want.argmax(-1))
    return dict(abs_max=float(diff.max()), abs_mean=float(diff.mean()),
                excess=float((diff - BAR * np.abs(want)).max() - BAR),
                held=int(sure.sum()), flips=int(flips.sum()),
                logits_abs_max=float(np.abs(want).max()))


def depth(layers: int, batch: int, prompt: int) -> dict:
    jcfg = jconfigs.get_config(ARCH).replace(n_layers=layers)
    cfg = configs.get_config(ARCH).replace(n_layers=layers)
    specs = jlm.lm_specs(jcfg)
    jparams = jax.jit(lambda key: jpm.materialize(specs, key))(
        jax.random.PRNGKey(0))
    jparams32 = jax.tree.map(lambda a: a.astype(jnp.float32), jparams)
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)
    t0 = time.perf_counter()
    runs = {"ref_bf16": reference_logits(jcfg, jparams, tokens),
            "ref_fp32": reference_logits(jcfg.replace(**F32), jparams32,
                                         tokens)}
    for name, c, tree in (("port_bf16", cfg, jparams),
                          ("port_fp32", cfg.replace(**F32), jparams32)):
        params = convert.lm_params_from_reference(
            jax.tree.map(np.asarray, tree), c, device="cpu")
        runs[name] = port_logits(c, params, tokens)
        del params
    del jparams, jparams32
    pairs = {
        "ref_bf16_vs_ref_fp32": ("ref_bf16", "ref_fp32"),
        "port_bf16_vs_ref_fp32": ("port_bf16", "ref_fp32"),
        "port_bf16_vs_ref_bf16": ("port_bf16", "ref_bf16"),
        "ref_bf16_vs_port_bf16": ("ref_bf16", "port_bf16"),
        "port_fp32_vs_ref_fp32": ("port_fp32", "ref_fp32"),
    }
    return dict(layers=layers, batch=batch, prompt=prompt,
                seconds=time.perf_counter() - t0,
                **{k: compare(runs[a], runs[b]) for k, (a, b) in pairs.items()})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", default="4,12")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--json", default=None)
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    rows = []
    for n in (int(x) for x in args.layers.split(",")):
        row = depth(n, args.batch, args.prompt)
        rows.append(row)
        for k, v in row.items():
            print(f"{n:3d} layers  {k}: {v}", flush=True)
    out = {"arch": ARCH, "bar": BAR, "margin": MARGIN, "depths": rows}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
