"""Quickstart on the PyTorch/CUDA port: recover a low-rank + sparse
decomposition through the ``repro_torch.rpca`` front door (the
counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
        [--n 300] [--rank 15]

On the card by default (the hand-written kernels); ``--device cpu`` runs
the plain PyTorch versions.  Without a card and without ``--device cpu``
it raises, as every entry point of the port does.  One ``solve`` call
covers every solver: ``method="auto"`` picks by problem size, explicit
methods are drop-in swaps, and every call returns the same
``RPCAResult``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import rpca
from repro_torch.core import (
    DCFConfig, RunConfig, generate_problem, low_rank_relative_error,
    relative_error,
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--n", type=int, default=300,
                    help="the matrix is n x n")
    ap.add_argument("--rank", type=int, default=15)
    ap.add_argument("--clients", type=int, default=10)
    args = ap.parse_args(argv)
    device = args.device

    # An n x n matrix of rank r with 5% gross corruptions (paper Sec 4.1).
    problem = generate_problem(0, args.n, args.n, args.rank, 0.05,
                               device=device)

    # E simulated clients, each holding n / E columns; consensus on U only.
    cfg = DCFConfig.tuned(rank=args.rank)
    result = rpca.solve(problem.m_obs, method="dcf", cfg=cfg,
                        num_clients=args.clients, device=device)
    err = relative_error(result.l, result.s, problem.l0, problem.s0)
    lerr = low_rank_relative_error(result.l, problem.l0)
    print(f"method {result.method}: relative error (Eq. 30) "
          f"{float(err):.2e}, low-rank {float(lerr):.2e}")
    u, v = result.factors
    print(f"consensus factor U: {tuple(u.shape)}, per-client V: "
          f"{tuple(v.shape)}")
    assert err < 1e-4

    # The convex SVD baseline is a drop-in method swap: same call, same
    # result type (no factors: the convex solvers estimate the rank).
    convex = rpca.solve(problem.m_obs, method="ialm", device=device)
    c_err = relative_error(convex.l, convex.s, problem.l0, problem.s0)
    print(f"method {convex.method}: err {float(c_err):.2e}, "
          f"factors: {convex.factors}")

    # method="auto": below the SVD-cost threshold the exact convex solver
    # wins; a spec with a mesh or num_clients routes to the DCF engines.
    auto = rpca.solve(problem.m_obs, device=device)
    print(f"auto picked {auto.method!r} ({int(auto.stats.rounds)} rounds)")

    # Early stopping: run="chunk"/"early" are named presets; a RunConfig
    # sets its own tolerance.
    early = rpca.solve(problem.m_obs, method="dcf", cfg=cfg,
                       num_clients=args.clients, device=device,
                       run=RunConfig(mode="chunk", tol=5e-4, chunk_size=10))
    e_err = relative_error(early.l, early.s, problem.l0, problem.s0)
    print(f"early stop: {int(early.stats.rounds)}/{cfg.outer_iters} rounds, "
          f"err {float(e_err):.2e}")

    # Warm-started refresh: new data and the prior factors take a handful
    # of rounds; result.factors feeds straight back as warm=.
    gen = torch.Generator(device=problem.m_obs.device).manual_seed(1)
    refreshed = problem.m_obs + 0.01 * torch.randn(
        problem.m_obs.shape, generator=gen, device=problem.m_obs.device)
    warm = rpca.solve(refreshed, method="dcf", cfg=cfg,
                      num_clients=args.clients, device=device,
                      run=RunConfig(mode="while", tol=5e-4),
                      warm=early.factors)
    print(f"warm refresh: {int(warm.stats.rounds)} rounds")
    return {"error": float(err), "convex_error": float(c_err),
            "auto_method": auto.method, "early_rounds": int(
                early.stats.rounds), "warm_rounds": int(warm.stats.rounds)}


if __name__ == "__main__":
    main()
