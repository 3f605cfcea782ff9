"""The ``wide`` solve (n = 4000, true rank 300, p = 600, E = 10) on the CPU,
through the JAX reference and through the PyTorch port, from one problem.

    PYTHONPATH=src python tools/torch_wide_reference.py [--rounds 100]
        [--n 4000] [--json out.json]

Both packages solve the same problem: the reference builds it
(``generate_problem(PRNGKey(0), n, n, r, 0.05)``, ``DCFConfig.tuned(p)``,
``dcf_pca.make_problem`` with E = 10 clients and ``PRNGKey(0)``, so the
initial factors are the reference's), runs ``dcf_pca``'s solver on its
plain (non-Pallas) path, and ``repro_torch.convert.problem_from_reference``
carries the problem across to the port's plain route (``impl="ref"``,
``device="cpu"``).  The script prints each package's per-round residual
trace, its singular-value error (Table 1's metric) and rank gap, the wall
of each solve, and the largest relative difference of the two traces over
the first 10 rounds, held to rtol 1e-3 (fp32 arithmetic in another order).
The last line is one JSON object with every number.

It is run by hand (minutes on 8 cores; not a test): it imports both
packages, which only tests and tools outside the port may do.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import time

import jax
import numpy as np
import torch

from repro.core import generate_problem, rank_gap, singular_value_error
from repro.core import runtime as jrt
from repro.core.factorized import DCFConfig as JConfig
from repro_torch import convert
from repro_torch.core import metrics

jdcf = importlib.import_module("repro.core.dcf_pca")
dcf = importlib.import_module("repro_torch.core.dcf_pca")

#: ``chip_smoke.py``'s wide phase: Table 1's generator at n = 4000 with
#: true rank 300, solved at the upper-bound rank p = 600 over E = 10.
N, TRUE_RANK, RANK, CLIENTS, SPARSITY = 4000, 300, 600, 10, 0.05
#: The traces must agree over this many first rounds within TRACE_RTOL.
COMPARED_ROUNDS, TRACE_RTOL = 10, 1e-3


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--true-rank", type=int, default=TRUE_RANK)
    ap.add_argument("--rank", type=int, default=RANK)
    ap.add_argument("--clients", type=int, default=CLIENTS)
    ap.add_argument("--rounds", type=int, default=None,
                    help="outer rounds (default: tuned's 100)")
    ap.add_argument("--json", default=None, help="also write the result here")
    args = ap.parse_args(argv)

    p = generate_problem(jax.random.PRNGKey(0), args.n, args.n,
                         args.true_rank, SPARSITY)
    jcfg = JConfig.tuned(args.rank, impl="ref")
    if args.rounds is not None:
        jcfg = dataclasses.replace(jcfg, outer_iters=args.rounds)
    problem = jdcf.make_problem(p.m_obs, jcfg, args.clients,
                                jax.random.PRNGKey(0))
    rounds = jcfg.outer_iters

    solver = jdcf.make_solver(jcfg)
    t0 = time.perf_counter()
    carry, jstats = jrt.run(solver, problem, rounds, jrt.FIXED)
    jl = solver.finalize(problem, carry)[0][:, :args.n]
    jl.block_until_ready()
    ref_wall = time.perf_counter() - t0
    ref = dict(
        wall_s=ref_wall,
        residual=np.asarray(jstats.residual, np.float64).tolist(),
        sv_err=float(singular_value_error(jl, p.l0, args.true_rank)),
        rank_gap=float(rank_gap(jl, args.true_rank)))
    print(f"reference: {rounds} rounds in {ref_wall:.1f} s, sv_err "
          f"{ref['sv_err']:.6g}, rank_gap {ref['rank_gap']:.6g}", flush=True)
    del carry, solver

    port_problem = convert.problem_from_reference(problem, "cpu")
    cfg = convert.config_from_reference(jcfg)
    t0 = time.perf_counter()
    res = dcf.solve_problem(port_problem, cfg, n=args.n)
    port_wall = time.perf_counter() - t0
    l0 = torch.from_numpy(np.array(p.l0))
    port = dict(
        wall_s=port_wall,
        residual=res.stats.residual.double().tolist(),
        sv_err=float(metrics.singular_value_error(res.l, l0,
                                                  args.true_rank)),
        rank_gap=float(metrics.rank_gap(res.l, args.true_rank)))
    print(f"port: {rounds} rounds in {port_wall:.1f} s, sv_err "
          f"{port['sv_err']:.6g}, rank_gap {port['rank_gap']:.6g}",
          flush=True)

    a = np.asarray(ref["residual"])
    b = np.asarray(port["residual"])
    k = min(COMPARED_ROUNDS, rounds)
    head = float(np.max(np.abs(a[:k] - b[:k]) / np.abs(a[:k])))
    whole = float(np.max(np.abs(a - b) / np.abs(a)))
    for t in range(rounds):
        print(f"round {t + 1:4d}  reference {a[t]:.9e}  port {b[t]:.9e}")
    out = dict(
        n=args.n, true_rank=args.true_rank, rank=args.rank,
        clients=args.clients, rounds=rounds, reference=ref, port=port,
        compared_rounds=k, trace_rtol=TRACE_RTOL,
        max_rel_trace_diff_first=head, max_rel_trace_diff_all=whole,
        sv_err_rel_diff=abs(port["sv_err"] - ref["sv_err"]) / ref["sv_err"],
        agree=head <= TRACE_RTOL)
    print(f"first {k} rounds: max relative trace difference {head:.3e} "
          f"(rtol {TRACE_RTOL}); all rounds {whole:.3e}; "
          f"{'AGREE' if out['agree'] else 'DIFFER'}", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
