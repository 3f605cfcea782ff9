"""Distributed RPCA over ``torch.distributed`` ranks (the sharded engine;
counterpart of ``examples/distributed_rpca.py``).

    PYTHONPATH=src python -m repro_torch.launch.distributed --procs 4 \
        --device cpu [--backend gloo] [--m 256 --n 320 --rank 8]

Spawns ``--procs`` worker processes on this host
(``distributed.multihost.launch_workers``), one rank each.  Each rank
along ``data`` is one of the paper's clients: it holds its column block,
the consensus average of U is one all-reduce a round, and V_i and S_i
never leave their rank.  The workers run the example's three solves:

1. the (procs,) data mesh on a 256 x 320, rank-8 problem (``--m``,
   ``--n``, ``--rank``);
2. data x model, (procs / 2, 2), rows split over "model" (an even count
   of at least 4 ranks);
3. the elastic topology: 256 x 301, n - 19 columns (a ragged split
   behind a mask plane) with Bernoulli(0.6) participation and the
   weighted consensus.

Rank 0 prints each solve's relative error.  The ranks run on the CUDA card
unless ``--device cpu``; ``--backend`` defaults to gloo on the CPU and to
NCCL where each rank has a card of its own (ranks that share one card run
gloo on CUDA tensors).
"""
from __future__ import annotations

import argparse

from repro_torch.distributed import multihost as mh

_WORKER = """
import os
import torch
import torch.distributed as dist
from repro_torch import rpca
from repro_torch.core import DCFConfig, relative_error
from repro_torch.core import problems as prob

device = {device!r}
procs = dist.get_world_size()
if device == "cpu":  # the host's cores shared among the ranks
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // procs))
say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
m, n, rank = {m}, {n}, {rank}
problem = prob.generate_problem(1, m, n, rank, 0.05, device=device)
cfg = DCFConfig.tuned(rank=rank)

mesh = _mh.multihost_mesh(("data",), device=device)
r = rpca.solve(rpca.RPCASpec(problem.m_obs, mesh=mesh),
               method="dcf_sharded", cfg=cfg, device=device)
err = relative_error(r.l, r.s, problem.l0, problem.s0)
say(f"1-D column-sharded ({{procs}} clients): err={{float(err):.2e}}")

if procs >= 4 and procs % 2 == 0:
    mesh2 = _mh.multihost_mesh(("data", "model"), (procs // 2, 2),
                               device=device)
    r2 = rpca.solve(rpca.RPCASpec(problem.m_obs, mesh=mesh2,
                                  model_axis="model"),
                    method="dcf_sharded", cfg=cfg, device=device)
    err2 = relative_error(r2.l, r2.s, problem.l0, problem.s0)
    say(f"2-D (rows x cols) sharded: err={{float(err2):.2e}}")

ragged = prob.generate_problem(2, m, n - 19, rank, 0.05, device=device)
cfg_e = DCFConfig.elastic(rank=rank, participation=0.6)
r3 = rpca.solve(rpca.RPCASpec(ragged.m_obs, mesh=mesh, participation=0.6),
                method="dcf_sharded", cfg=cfg_e, device=device)
err3 = relative_error(r3.l, r3.s, ragged.l0, ragged.s0)
say(f"elastic (n={{n - 19}} over {{procs}} clients, 60% participation): "
    f"err={{float(err3):.2e}}")
"""


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=4,
                    help="worker processes (ranks) on this host")
    ap.add_argument("--device", default=None,
                    help="torch device of the ranks (default: the card)")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="process-group backend (default: gloo on the CPU, "
                         "NCCL with a card a rank)")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--n", type=int, default=320)
    ap.add_argument("--rank", type=int, default=8)
    args = ap.parse_args(argv)
    backend = args.backend
    if backend is None and args.device == "cpu":
        backend = "gloo"
    code = _WORKER.format(device=args.device, m=args.m, n=args.n,
                          rank=args.rank)
    outs = mh.launch_workers(code,
                             num_processes=args.procs, timeout=args.timeout,
                             backend=backend)
    print(f"ranks: {args.procs}")
    print("\n".join(ln for ln in outs[0].splitlines()
                    if ln.startswith(("1-D", "2-D", "elastic"))))
    return outs


if __name__ == "__main__":
    main()
