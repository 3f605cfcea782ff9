"""Dry run on the meta device: what each (arch x shape) cell needs of one
80 GB card, without allocating it (counterpart of ``repro/launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A ...]
        [--shape S ...] [--n-layers L] [--attn-period P] [--out FILE]

The reference lowers and compiles every cell on a 512-device TPU mesh and
prices the compiled program (``roofline/analysis.py``).  One card runs
one rank, so the port asks the question that decides its cells instead:
does the model fit?  Each model of ``repro_torch.configs.ARCH_IDS`` is
built on ``torch.device("meta")`` at full size (its parameters as
``Params`` over the model's specs, the models' own constructor: nothing is
drawn, nothing allocated), and each shape of ``configs.SHAPES`` that
``supports_shape`` allows gives one JSON line: the parameters, the weight
bytes (each parameter in its spec's dtype: ``param_dtype`` for the
matrices, fp32 for norms and routers), the decode caches from the model's
own ``init_cache`` on meta (``decode_*`` shapes), the model FLOP
(``roofline.model_flops_global``) and whether weights and caches fit
:data:`CARD_BYTES`.  ``--n-layers`` and ``--attn-period`` replace those
config fields, the cuts that ``chip_smoke.py``'s serve phases take (the
jamba cut at 2 layers of period 2, deepseek-v2 at 4 layers).  Nothing is
written unless ``--out`` names a file for the lines.

Meshes: the reference's ``launch/mesh.py`` builds the production meshes
(16 x 16 and 2 x 16 x 16 TPU chips, ``make_production_mesh``) and
``make_compat_mesh`` for them; one card has no counterpart of either.
Its ``make_host_mesh`` (a small mesh over the local devices) is the port's
``distributed.multihost.multihost_mesh`` over the ranks of a process group.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, supports_shape
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import get_model
from repro_torch.models.params import count_params
from repro_torch.roofline import model_flops_global

#: The card's memory: one NVIDIA H100 of 80 GB.
CARD_BYTES = 80e9
META = torch.device("meta")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def weight_bytes(cfg: ModelConfig) -> int:
    """The bytes of ``cfg``'s parameters, from the model built on meta."""
    return _nbytes(get_model(cfg).empty_params(META).parameters())


def cache_bytes(cfg: ModelConfig, batch: int, s_max: int) -> int:
    """The bytes of the decode caches ``Model.init_cache`` makes for
    ``batch`` rows of ``s_max`` positions, built on meta."""
    caches = get_model(cfg).init_cache(batch, s_max, META)
    leaves = [x for cache in caches for x in cache]
    return _nbytes(leaves)


def cell(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """One (config x shape) cell of the dry run."""
    model = get_model(cfg)
    weights = weight_bytes(cfg)
    cache = (cache_bytes(cfg, shape.global_batch, shape.seq_len)
             if shape.kind == "decode" else 0)
    return dict(arch=cfg.name, shape=shape.name, kind=shape.kind,
                n_layers=cfg.n_layers, attn_period=cfg.attn_period,
                params=count_params(model.specs()),
                param_dtype=cfg.param_dtype,
                weight_bytes=weights, weight_gb=weights / 1e9,
                cache_bytes=cache, cache_gb=cache / 1e9,
                model_flops_global=model_flops_global(cfg, model, shape),
                fits_card=weights + cache <= CARD_BYTES)


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, action="append",
                    help="an architecture (repeat for more; default: all)")
    ap.add_argument("--shape", choices=tuple(SHAPES), action="append",
                    help="a shape (repeat for more; default: all)")
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--attn-period", type=int, default=None)
    ap.add_argument("--out", default=None,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    overrides = {k: v for k, v in (("n_layers", args.n_layers),
                                   ("attn_period", args.attn_period))
                 if v is not None}
    rows = []
    for arch in args.arch or ARCH_IDS:
        cfg = get_config(arch).replace(**overrides)
        for name in args.shape or tuple(SHAPES):
            ok, why = supports_shape(cfg, SHAPES[name])
            if not ok:
                print(json.dumps(dict(arch=arch, shape=name, skipped=why)))
                continue
            rows.append(cell(cfg, SHAPES[name]))
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    return rows


if __name__ == "__main__":
    main()
