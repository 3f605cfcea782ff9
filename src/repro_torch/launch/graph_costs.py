"""What the round graphs cost on the card, one JSON line a measurement.

    PYTHONPATH=<tree>/src python src/repro_torch/launch/graph_costs.py \
        [captures|trace]...

``captures``  the ``cf``, ``dcf`` and ``dual`` solves of ``solve_walls.py``
              through ``rpca.solve``, :data:`REPS` times each after a warm
              one, in turns with every capture in the device's shared pool
              (as ``core.runtime`` captures) and in a pool of its own (as
              it captured before).  For every capture: ``capture_begin``
              (``begin_ms``), recording the round (``record_ms``),
              instantiation (``instantiate_ms``), the Python collector's
              time inside the three (``gc_ms``) and the allocator's
              ``cudaMalloc`` calls (``mallocs``) and retries; beside them
              each solve's wall and the device memory reserved after it.
``trace``     the ``dual`` solve (429 rounds) replayed under torch.profiler,
              :data:`TRACE_REPS` times stopped right after the synchronise
              and as often kept on :data:`TAIL_S` seconds longer, then cut
              to 12 rounds as often: each trace's kernels by family against
              the launch counters, and the last kernel recorded.

Needs a CUDA card; exits 2 without one.  Builds the kernels first.
"""
from __future__ import annotations

import gc
import importlib
import json
import sys
import time

import torch

REPS = 5
TRACE_REPS = 6
TAIL_S = 0.05
#: Counter names and device-kernel name parts of the port's kernels, by
#: family (as ``chip_smoke.py`` counts them).
FAMILIES = {
    "contract_v": (("huber_contract_v",), "contract_v_"),
    "stripe": (("huber_contract_u", "huber_contract_u_diag",
                "huber_dual_contract"), "stripe_"),
    "shrink": (("residual_shrink", "residual_shrink_psi"), "shrink_"),
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


class _Collector:
    """Seconds the Python collector ran, from ``gc.callbacks``."""

    def __init__(self):
        self.seconds, self._start = 0.0, None
        gc.callbacks.append(self._on)

    def _on(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        elif self._start is not None:
            self.seconds += time.perf_counter() - self._start
            self._start = None


def instrument(shared: dict, records: list) -> None:
    """``torch.cuda.CUDAGraph`` replaced by a subclass that times each
    capture's parts into ``records``; ``shared["pool"]`` False drops the
    pool argument (every capture in a pool of its own)."""
    base = torch.cuda.CUDAGraph
    collector = _Collector()

    def mallocs(stats):
        return stats.get("num_device_alloc", 0)

    class Timed(base):
        def capture_begin(self, pool=None, **kw):
            self._stats = torch.cuda.memory_stats()
            self._gc = collector.seconds
            self._t0 = time.perf_counter()
            super().capture_begin(pool=pool if shared["pool"] else None,
                                  **kw)
            self._t1 = time.perf_counter()

        def capture_end(self):
            t2 = time.perf_counter()
            recorded = torch.cuda.memory_stats()
            super().capture_end()
            t3 = time.perf_counter()
            end = torch.cuda.memory_stats()
            records.append(dict(
                begin_ms=(self._t1 - self._t0) * 1e3,
                record_ms=(t2 - self._t1) * 1e3,
                instantiate_ms=(t3 - t2) * 1e3,
                gc_ms=(collector.seconds - self._gc) * 1e3,
                mallocs=mallocs(recorded) - mallocs(self._stats),
                retries=(end.get("num_alloc_retries", 0)
                         - self._stats.get("num_alloc_retries", 0))))

    torch.cuda.CUDAGraph = Timed


def solves(dev) -> dict:
    """``solve_walls.py``'s three solves, as ``name -> solve()``."""
    from repro_torch import rpca
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    p = prob.generate_problem(0, 3000, 3000, 150, 0.05, device=dev)
    d = prob.generate_problem(0, 2048, 2048, 64, 0.10, observed_frac=0.7,
                              device=dev)
    phases = {
        "cf": (p, {}, "cf", DCFConfig.tuned(150)),
        "dcf": (p, {"num_clients": 10}, "dcf", DCFConfig.tuned(150)),
        "dual": (d, {"num_clients": 4, "mask": d.mask}, "dcf",
                 DCFConfig.masked(64, observed_frac=0.7, fused="dual")),
    }
    return {name: (lambda q=q, kw=kw, m=m, c=c: rpca.solve(
        rpca.RPCASpec(q.m_obs, **kw), method=m, cfg=c, device=dev))
        for name, (q, kw, m, c) in phases.items()}


def captures(dev) -> None:
    shared, records = {"pool": True}, []
    instrument(shared, records)
    runs = solves(dev)
    for solve in runs.values():
        solve()
    for rep in range(2 * REPS):
        shared["pool"] = rep % 2 == 0
        for name, solve in runs.items():
            del records[:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            emit(part="captures", rep=rep // 2, solve=name,
                 shared_pool=shared["pool"],
                 wall_s=time.perf_counter() - t0, captures=list(records),
                 reserved_gb=torch.cuda.memory_reserved() / 1e9)


def trace(dev) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.kernels import ops

    dcf = importlib.import_module("repro_torch.core.dcf_pca")
    d = prob.generate_problem(0, 2048, 2048, 64, 0.10, observed_frac=0.7,
                              device=dev)

    def dual(rounds):
        cfg = DCFConfig.masked(64, observed_frac=0.7, fused="dual",
                               outer_iters=rounds)
        problem = dcf.make_problem(d.m_obs, cfg, 4, 0, mask=d.mask,
                                   device=dev)
        solver = dcf.make_solver(cfg)

        def run():
            carry, _ = rt.run(solver, problem, rounds)
            return solver.finalize(problem, carry)

        return run

    for rounds, tails in ((429, (0.0, TAIL_S)), (12, (0.0,))):
        run = dual(rounds)
        run()
        ops.reset_launch_counts()
        run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        want = {fam: sum(c for k, c in counts.items()
                         if k.removesuffix("_masked").removesuffix("_packed")
                         in names)
                for fam, (names, _) in FAMILIES.items()}
        for tail in tails:
            for i in range(TRACE_REPS):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    run()
                    torch.cuda.synchronize()
                    time.sleep(tail)
                kernels = sorted(
                    (ev.start_ns(), ev.name())
                    for ev in prof.profiler.kineto_results.events()
                    if ev.device_type() == DeviceType.CUDA)
                seen = {fam: sum(part in name for _, name in kernels)
                        for fam, (_, part) in FAMILIES.items()}
                emit(part="trace", rounds=rounds, tail_s=tail, i=i,
                     kernels=len(kernels), counters=want, traced=seen,
                     missing={f: want[f] - seen[f] for f in want},
                     last_kernel=kernels[-1][1][:60] if kernels else None)


def main() -> int:
    if not torch.cuda.is_available():
        print("graph_costs: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    parts = sys.argv[1:] or ["captures", "trace"]
    for part in parts:
        {"captures": captures, "trace": trace}[part](dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
