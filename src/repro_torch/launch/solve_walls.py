"""Synchronised solve walls on the card, one JSON line.

    PYTHONPATH=<tree>/src python src/repro_torch/launch/solve_walls.py

Runs the ``repro_torch`` found on ``PYTHONPATH`` through ``rpca.solve`` at
three of ``chip_smoke.py``'s solve phases: ``cf`` and ``dcf`` (E=10) on
the Fig. 1 problem (3000 x 3000, rank 150, 5% corruption,
``DCFConfig.tuned(150)``) and ``dual`` on the compact-plane problem (2048
x 2048, rank 64, 10% corruption, 70% observed, E=4,
``DCFConfig.masked(64, observed_frac=0.7, fused="dual")``).  Each phase
runs one warm solve, then ``REPS`` timed ones (host clock around the
solve and a synchronise).  Walls spread with the host, so compare two
checkouts by running this script for each in turns, many times, on one
card.  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import json
import sys
import time

import torch

REPS = 3


def main() -> int:
    if not torch.cuda.is_available():
        print("solve_walls: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import rpca
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    p = prob.generate_problem(0, 3000, 3000, 150, 0.05, device=dev)
    d = prob.generate_problem(0, 2048, 2048, 64, 0.10, observed_frac=0.7,
                              device=dev)
    phases = {
        "cf": (p, {}, "cf", DCFConfig.tuned(150)),
        "dcf": (p, {"num_clients": 10}, "dcf", DCFConfig.tuned(150)),
        "dual": (d, {"num_clients": 4, "mask": d.mask}, "dcf",
                 DCFConfig.masked(64, observed_frac=0.7, fused="dual")),
    }
    out = {"tree": repro_torch.__file__}
    for name, (problem, kw, method, cfg) in phases.items():
        def solve():
            return rpca.solve(rpca.RPCASpec(problem.m_obs, **kw),
                              method=method, cfg=cfg, device=dev)

        solve()
        torch.cuda.synchronize()
        walls = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = walls
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
