"""Multi-tenant RPCA serving on the PyTorch/CUDA port: the async
continuous-batching gateway (the counterpart of ``examples/rpca_serving.py``).

    PYTHONPATH=src python examples/torch_rpca_serving.py [--device cpu]
        [--size 200] [--rank 10]

Mixed-width tenants stream decomposition jobs into an ``RPCAGateway``:
an asyncio request loop accepts ``submit()`` while solves are in flight,
stages queued planes in a paged column pool (page-span width classes
instead of worst-case padding), schedules admissions across per-method
lanes with priority and weighted fairness, and sheds load with the typed
``QueueFull`` backpressure signal.  A snapshot hook prints live metrics
while the batch runs.  Most tenants take the factorized ``cf`` lane (on
the card a tick replays one captured slot-table round), one asks for the
convex ``ialm`` baseline, a priority-1 tenant jumps the queue, and one
tenant streams an updated matrix warm-started from its prior factors.
The slot-table ``RPCAService`` underneath is driven directly at the end.

On the card by default; ``--device cpu`` runs the plain PyTorch versions;
without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import asyncio
import time

import torch

from repro_torch.core import DCFConfig, QueueFull, generate_problem, relative_error
from repro_torch.serving.gateway import GatewayConfig, RPCAGateway
from repro_torch.serving.rpca_service import RPCAService, RPCAServiceConfig


def snapshot(mets):
    occ = {k: v["occupied"] for k, v in mets["lanes"].items()}
    lat = mets["latency"]
    print(f"  [tick {mets['ticks']:3d}] queue={mets['queue_depth']} "
          f"in_flight={mets['in_flight']} lanes={occ} "
          f"waste={mets['padding']['waste_ratio']:.2f}x "
          f"homog-vs-paged={mets['padding']['homogeneous_ratio']:.2f}x "
          f"p50={lat['p50_ms']:.0f}ms p99={lat['p99_ms']:.0f}ms")


async def serve(size: int, rank: int, device) -> list:
    m = n = size
    # Mixed-width tenants: narrow ones pay their page span (n / 4 columns
    # a page), not the full-width worst case.
    quarter = n // 4
    widths = [quarter, quarter, 2 * quarter, 2 * quarter, 3 * quarter] \
        + [n] * 5
    tenants = [generate_problem(i, m, w, rank, 0.05, device=device)
               for i, w in enumerate(widths)]
    gcfg = GatewayConfig(
        page_cols=quarter, pool_pages=64, max_queue=8, slots=4,
        rounds_per_tick=10, max_rounds=150, tol=5e-4,
        lane_weights=(("cf", 2.0), ("ialm", 1.0)),  # cf admits 2:1
        snapshot_every=5,
    )
    async with RPCAGateway(m, n, DCFConfig.tuned(rank), gcfg,
                           snapshot_hook=snapshot, device=device) as gw:
        t0 = time.perf_counter()
        tickets = []
        for i, ten in enumerate(tenants):
            while True:
                try:
                    tickets.append(await gw.submit(
                        ten.m_obs,
                        method="ialm" if i == 7 else None,
                        priority=1 if i == 9 else 0,  # tenant 9 jumps
                    ))
                    break
                except QueueFull:
                    # Typed backpressure: the queue is full while solves
                    # are in flight; yield and retry.
                    await asyncio.sleep(0.01)
        resps = [await t for t in tickets]
        dt = time.perf_counter() - t0
        errors = []
        for i, (ten, r) in enumerate(zip(tenants, resps)):
            err = float(relative_error(r.l, r.s, ten.l0, ten.s0))
            errors.append(err)
            pri = " (priority)" if i == 9 else ""
            print(f"tenant {i}: {r.method:4s} {r.rounds:3d} rounds, "
                  f"{r.l.shape[1]:3d} cols, err {err:.2e}{pri}")
        print(f"{len(tenants)} tenants through {gcfg.slots} slots in "
              f"{dt:.2f}s ({len(tenants) / dt:.1f} problems/s, incl. "
              f"the lanes' builds)")
        mets = gw.metrics()
        print(f"admitted={mets['admitted']} completed={mets['completed']} "
              f"shed={mets['shed']} "
              f"p50={mets['latency']['p50_ms']:.0f}ms "
              f"p99={mets['latency']['p99_ms']:.0f}ms")
        order = gw.admissions
        print(f"admission order: {order} "
              f"(tenant 9 admitted #{order.index(tickets[9].id) + 1})")

        # Streaming refresh: tenant 0's data drifts; warm-start from its
        # prior factors through the same gateway.
        m0 = tenants[0].m_obs
        gen = torch.Generator(device=m0.device).manual_seed(99)
        drifted = m0 + 0.01 * torch.randn(m0.shape, generator=gen,
                                          device=m0.device)
        refresh = await (await gw.submit(drifted,
                                         warm=(resps[0].u, resps[0].v)))
        print(f"tenant 0 warm refresh: {refresh.rounds} rounds "
              f"(cold took {resps[0].rounds})")
    return errors


def direct_service(device) -> float:
    """The synchronous slot table underneath, driven directly: for callers
    that own their loop and want submit / tick / poll control."""
    m = n = 120
    rank = 6
    p = generate_problem(5, m, n, rank, 0.05, device=device)
    svc = RPCAService(m, n, DCFConfig.tuned(rank),
                      RPCAServiceConfig(slots=2, rounds_per_tick=10),
                      device=device)
    slot = svc.try_submit(p.m_obs)
    while svc.pending():
        svc.tick()
    resp = svc.poll(slot)
    svc.release(slot)
    err = float(relative_error(resp.l, resp.s, p.l0, p.s0))
    print(f"direct RPCAService: {resp.rounds} rounds, err {err:.2e}")
    return err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    ap.add_argument("--size", type=int, default=200,
                    help="m = n of the gateway (a multiple of 4)")
    ap.add_argument("--rank", type=int, default=10)
    args = ap.parse_args(argv)
    errors = asyncio.run(serve(args.size, args.rank, args.device))
    return {"errors": errors, "direct_error": direct_service(args.device)}


if __name__ == "__main__":
    main()
