"""The paper's technique as a training feature, on the PyTorch/CUDA port:
DCF-PCA consensus gradient aggregation surviving a Byzantine (corrupted)
data-parallel rank (the counterpart of ``examples/robust_aggregation.py``).

    PYTHONPATH=src python examples/torch_robust_aggregation.py [--procs 4]
        [--steps 25] [--device cpu]

Two short training runs of the smoke TinyLlama on ``--procs`` data-parallel
ranks (one process each, ``distributed.multihost.launch_workers``, in place
of the reference's ``shard_map_compat`` over forced host devices), where
the last rank's gradient (rank 3 of 4 or more) suffers gross sparse
corruption every step (5% of entries at +-1e4):

* plain all-reduce: the corrupted mean saturates gradient clipping and
  training stalls near the initial loss;
* DCF-PCA consensus (``distributed.grad_compress.aggregate_leaf``: rank-16
  factors over 3 consensus rounds with error feedback; the sparse S_i
  absorbs the corruption; small leaves by the coordinate-wise median)
  keeps descending.

Rank 0 prints both loss curves.  With ``--check`` the script asserts, as
the reference does, that the robust run ends at least 0.1 below the plain
one (a claim about a full run: a few steps prove nothing).  The ranks run
on the card unless ``--device cpu`` (gloo on the CPU; ranks sharing one
card run gloo on CUDA tensors).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.distributed import multihost as mh

CORRUPT_RANK = 3
CORRUPT_DENSITY = 0.05
CORRUPT_MAG = 1e4
GLOBAL_BATCH, SEQ = 8, 64

_WORKER = """
import json
import os
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.distributed.grad_compress import CompressConfig, aggregate_leaf
from repro_torch.models import get_model
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticData, fold_in

device, steps = {device!r}, {steps}
procs, rank = dist.get_world_size(), dist.get_rank()
if device == "cpu":  # the host's cores shared among the ranks
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))
corrupt_rank = min({corrupt_rank}, procs - 1)
mesh = _mh.multihost_mesh(("data",), device=device)
comm = _mh.MeshComm(mesh, ("data",))
ccfg = CompressConfig(rank=16, rounds=3, min_dim=32)
cfg = get_smoke_config("tinyllama-1.1b")
model = get_model(cfg)
data = SyntheticData(cfg, ShapeSpec("t", {seq}, {batch}, "train"),
                     device=device)
rows = {batch} // procs


def corrupt(name_index, g, step):
    gen = torch.Generator(device=g.device).manual_seed(
        fold_in(7, step * 4096 + name_index))
    mask = torch.rand(g.shape, generator=gen, device=g.device) < {density}
    sign = torch.randint(0, 2, g.shape, generator=gen, device=g.device) * 2 - 1
    return g + (mask * sign * {mag}).to(g.dtype)


def run(mode):
    ocfg = opt.AdamWConfig(lr=2e-3, warmup_steps=2, total_steps=steps,
                           weight_decay=0.0)
    params = model.init_params(seed=0, device=device)
    state = opt.init(params)
    names = [n for n, _ in params.named_parameters()]
    err = {{n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.named_parameters()}}
    losses = []
    for i in range(steps):
        batch = {{k: x[rank * rows:(rank + 1) * rows]
                  for k, x in data.batch_at(i).items()}}
        leaves = [p.requires_grad_(True) for p in params.parameters()]
        loss, _ = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        if rank == corrupt_rank:
            grads = [corrupt(j, g, i) for j, g in enumerate(grads)]
        sketch = torch.Generator(device=loss.device).manual_seed(
            fold_in(9, i))
        agg = {{}}
        for name, g in zip(names, grads):
            if mode == "robust":  # error feedback: the residual re-enters
                ge = g.float() + err[name]
                a = aggregate_leaf(ge, comm, ccfg, sketch)
                err[name] = ge - a
                agg[name] = a.to(g.dtype)
            else:
                agg[name] = comm.all_reduce(g) / procs
        params, state, _ = opt.update(ocfg, agg, state, params)
        losses.append(float(comm.all_reduce(loss.detach()) / procs))
    return losses


out = {{"plain": run("plain"), "robust": run("robust")}}
if rank == 0:
    print("LOSSES " + json.dumps(out))
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=4,
                    help=f"data-parallel ranks (divides {GLOBAL_BATCH})")
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: the card)")
    ap.add_argument("--check", action="store_true",
                    help="assert the robust run ends 0.1 under the plain one")
    ap.add_argument("--timeout", type=int, default=900)
    args = ap.parse_args(argv)
    if GLOBAL_BATCH % args.procs:
        raise ValueError(f"--procs must divide the global batch "
                         f"{GLOBAL_BATCH}, got {args.procs}")
    code = _WORKER.format(device=args.device, steps=args.steps,
                          corrupt_rank=CORRUPT_RANK, seq=SEQ,
                          batch=GLOBAL_BATCH, density=CORRUPT_DENSITY,
                          mag=CORRUPT_MAG)
    outs = mh.launch_workers(code, num_processes=args.procs,
                             timeout=args.timeout,
                             backend="gloo" if args.device == "cpu" else None)
    line = next(ln for ln in outs[0].splitlines() if ln.startswith("LOSSES "))
    losses = json.loads(line.removeprefix("LOSSES "))
    plain, robust = losses["plain"], losses["robust"]
    print(f"ranks: {args.procs} (rank {min(CORRUPT_RANK, args.procs - 1)} "
          f"corrupted)")
    print(f"{'step':>5s} {'plain-allreduce':>16s} {'dcf-consensus':>14s}")
    for i in range(0, len(plain), 5):
        print(f"{i:5d} {plain[i]:16.3f} {robust[i]:14.3f}")
    print(f"final {plain[-1]:16.3f} {robust[-1]:14.3f}")
    if args.check:
        assert robust[-1] < plain[-1] - 0.1, (
            "robust aggregation should keep learning under corruption")
        print("OK: consensus aggregation survives the Byzantine rank")
    return losses


if __name__ == "__main__":
    main()
