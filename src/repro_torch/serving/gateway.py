"""Async continuous-batching RPCA gateway (counterpart of
``repro.serving.gateway``).

``RPCAService`` is a slot table the caller must tick; this module is the
always-on front end: an asyncio request loop that accepts ``submit()``
while solves are in flight, schedules admissions across per-method lanes
with priority and weighted fairness, sheds load with a typed backpressure
signal (:class:`~repro_torch.core.validate.QueueFull`), and exports an
observability surface (:meth:`RPCAGateway.metrics`).

* **Request loop.**  One background task pumps ``complete -> admit ->
  tick``; submitters and result-awaiters interleave on the same event
  loop.  A tick is synchronous device work on the event loop's thread (a
  ``cf`` lane's is ``rounds_per_tick`` replays of one captured round), so
  the loop alternates between compute and request handling: asyncio buys
  concurrency of *requests*, not parallel device work.  Ticks are never
  moved to other threads or streams: every round graph of a device
  shares one memory pool and replays one at a time on the current stream.

* **Paged staging, width-bucketed lanes.**  Queued request planes live in
  a host :class:`~repro_torch.serving.pages.PagePool` (fixed-size column
  pages, CSR page tables), and admission gathers them into a service whose
  width is the request's page span, so a 64-column tenant in a 512-column
  gateway occupies one page while queued and an ``(m, 64)`` slot plane
  while solving.  Gather and scatter happen only at these boundaries; the
  services' ticks stay page-oblivious.  With ``page_cols = n`` every
  request spans one page and lands in one full-width lane: bit for bit
  the same as driving ``RPCAService`` directly (test-enforced).  Planes
  whose dtype the pool does not hold (bf16, float64) stage dense.

* **Scheduling.**  Admission order: strictly by ``priority`` (higher
  first), then stride scheduling across ``(method, width)`` lanes: each
  admission advances the lane's virtual time by ``1 / weight`` and the
  lane with the smallest virtual time goes next (ties break on the lane
  key).  A lane whose width class is full is skipped, not blocked on.

* **Admission control.**  ``submit()`` raises ``QueueFull`` when the queue
  depth or the staging pool is exhausted; never-valid requests (wrong
  rows, oversize width, mis-shaped mask or warm pair, a method without
  service support) raise ``ValueError`` at ``submit()``, before queueing.

Usage::

    async with RPCAGateway(m, n, DCFConfig.tuned(rank)) as gw:
        t = await gw.submit(m_obs, method="cf", priority=1)
        resp = await t                      # RPCAResponse
        print(gw.metrics()["latency"])      # p50/p99, occupancy, waste
"""
from __future__ import annotations

import asyncio
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import validate
from repro_torch.device import resolve_device
from repro_torch.serving.metrics import (
    LatencyWindow, OutcomeCounter, RateMeter,
)
from repro_torch.serving.pages import PagePool
from repro_torch.serving.rpca_service import (
    RPCAResponse,
    RPCAService,
    RPCAServiceConfig,
    host_array,
)

__all__ = ["GatewayConfig", "RPCAGateway", "Ticket"]


@dataclass(frozen=True)
class GatewayConfig:
    """Gateway knobs.

    ``page_cols``    columns per pool page and the width quantum of the
                     solver lanes (``None`` -> the gateway's full width
                     ``n``: every request spans one page and the single
                     lane class is bit-exact with ``RPCAService``).
    ``pool_pages``   staging-pool capacity; with ``max_queue`` this is
                     the admission-control surface (both raise
                     ``QueueFull``).
    ``max_queue``    queued-request limit (excludes in-flight solves).
    ``slots`` / ``rounds_per_tick`` / ``max_rounds`` / ``tol`` /
    ``min_rounds``   forwarded to each width-class ``RPCAServiceConfig``.
    ``lane_weights`` ``(method, weight)`` pairs for the stride scheduler
                     (missing methods weigh 1.0).
    ``snapshot_every``  call the snapshot hook every N pump ticks
                     (0 = off).
    ``idle_sleep_s`` loop parking interval when there is no work.
    """

    page_cols: int | None = None
    pool_pages: int = 64
    max_queue: int = 64
    slots: int = 8
    rounds_per_tick: int = 8
    max_rounds: int = 200
    tol: float = 5e-4
    min_rounds: int = 2
    lane_weights: tuple[tuple[str, float], ...] = ()
    latency_window: int = 1024
    rate_window_s: float = 30.0
    snapshot_every: int = 0
    idle_sleep_s: float = 0.002


@dataclass
class _Request:
    """One queued submission: staged planes + the caller's future."""

    ticket: int
    method: str
    priority: int
    n_req: int
    width: int
    data: Any  # PagePool handle (int) or a dense host plane
    mask: Any  # PagePool handle (int), dense plane, or None
    data_paged: bool
    mask_paged: bool
    warm: tuple | None
    future: asyncio.Future
    t_submit: float
    dtype: Any = None  # original data dtype (restored at admission)


class Ticket:
    """Awaitable handle for one gateway submission.

    ``await ticket`` (or ``await ticket.result()``) resolves to the
    :class:`~repro_torch.serving.rpca_service.RPCAResponse`; ``done()`` polls.
    """

    __slots__ = ("id", "method", "n_req", "_future")

    def __init__(self, req: _Request):
        self.id = req.ticket
        self.method = req.method
        self.n_req = req.n_req
        self._future = req.future

    def done(self) -> bool:
        return self._future.done()

    def __await__(self):
        return self._future.__await__()

    async def result(self) -> RPCAResponse:
        return await self._future

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "done" if self.done() else "pending"
        return (f"Ticket(id={self.id}, method={self.method!r}, "
                f"n_req={self.n_req}, {state})")


_LaneKey = tuple[str, int]  # (method, lane width)


class RPCAGateway:
    """Asyncio continuous-batching gateway over width-bucketed
    ``RPCAService`` lanes (module docstring has the architecture).

    ``m`` / ``n`` bound admissible problems (rows exact, columns
    ``1..n``); ``cfg`` configures the default ``method`` lane and
    ``cfgs`` the per-request ones, exactly as for ``RPCAService``.
    ``snapshot_hook`` (with ``gcfg.snapshot_every``) receives periodic
    :meth:`metrics` dicts -- the export point for dashboards/logs.
    ``key`` and ``device`` go to every width class's ``RPCAService``
    (the card unless ``device="cpu"``): a seed gives each class its own
    sequence (seed + i for the class's i-th admission), while one
    ``torch.Generator`` is shared by every class, so its draws follow the
    admission order across classes.
    """

    def __init__(
        self,
        m: int,
        n: int,
        cfg: Any,
        gcfg: GatewayConfig = GatewayConfig(),
        *,
        key: Any = None,
        method: str = "cf",
        cfgs: dict[str, Any] | None = None,
        snapshot_hook: Callable[[dict], None] | None = None,
        clock: Callable[[], float] = time.perf_counter,
        device: torch.device | str | None = None,
    ):
        page_cols = gcfg.page_cols if gcfg.page_cols is not None else n
        if not 1 <= page_cols <= n:
            raise ValueError(
                f"page_cols must be in 1..n={n}, got {page_cols}"
            )
        if gcfg.max_queue < 1:
            raise ValueError(
                f"max_queue must be >= 1, got {gcfg.max_queue}"
            )
        self.m, self.n = int(m), int(n)
        self.cfg = cfg
        self.gcfg = gcfg
        self.page_cols = int(page_cols)
        self._key = key
        self._device = resolve_device(device)
        self._default_method = method
        self._cfgs = dict(cfgs or {})
        self._snapshot_hook = snapshot_hook
        self._clock = clock
        self._scfg = RPCAServiceConfig(
            slots=gcfg.slots,
            rounds_per_tick=gcfg.rounds_per_tick,
            max_rounds=gcfg.max_rounds,
            tol=gcfg.tol,
            min_rounds=gcfg.min_rounds,
        )
        self._weights = dict(gcfg.lane_weights)
        self._pool = PagePool(self.m, self.page_cols, gcfg.pool_pages)
        self._services: dict[int, RPCAService] = {}
        # (priority, lane) -> FIFO of staged requests; vtime per lane.
        self._queues: dict[tuple[int, _LaneKey], deque[_Request]] = {}
        self._vtime: dict[_LaneKey, float] = {}
        self._queued = 0
        self._in_flight: dict[tuple[int, int], _Request] = {}
        self._next_ticket = 0
        #: Ticket ids in admission order -- the scheduler's observable
        #: decision log (tests pin fairness against it; metrics counts it).
        self.admissions: list[int] = []
        self._latency = LatencyWindow(gcfg.latency_window)
        self._round_rate = RateMeter(gcfg.rate_window_s, clock=clock)
        self._submitted = 0
        self._outcomes = OutcomeCounter()
        self._ticks = 0
        self._running = False
        self._task: asyncio.Task | None = None
        self._wake: asyncio.Event | None = None

    # -- lifecycle -----------------------------------------------------------
    async def __aenter__(self) -> "RPCAGateway":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def start(self) -> None:
        """Start the background request loop on the running event loop
        (idempotent; a closed gateway restarts with its state intact)."""
        if self._running:
            return
        self._running = True
        self._wake = asyncio.Event()
        self._task = asyncio.create_task(self._run(), name="rpca-gateway")

    async def aclose(self) -> None:
        """Stop the loop; queued and in-flight requests are cancelled
        (their futures too) and staged pages freed."""
        if not self._running:
            return
        self._running = False
        assert self._wake is not None
        self._wake.set()
        assert self._task is not None
        await self._task
        self._task = None
        for q in self._queues.values():
            for req in q:
                self._free_request(req)
                req.future.cancel()
        self._queues.clear()
        self._queued = 0
        for (width, slot), req in list(self._in_flight.items()):
            self._services[width].release(slot)
            req.future.cancel()
        self._in_flight.clear()

    # -- submission ----------------------------------------------------------
    async def submit(
        self,
        m_obs: Any,
        *,
        method: str | None = None,
        mask: Any = None,
        warm: tuple | None = None,
        priority: int = 0,
    ) -> Ticket:
        """Queue one problem; returns an awaitable :class:`Ticket`.

        Raises ``ValueError`` for never-valid requests (eagerly, before
        queueing) and :class:`~repro_torch.core.validate.QueueFull` when the
        queue depth or staging pool is at its limit -- the typed
        backpressure signal; catch it to shed or back off.  ``priority``
        orders admission (higher first); within a priority, lanes share
        admissions by ``lane_weights``.
        """
        if not self._running:
            raise RuntimeError(
                "gateway is not running: use 'async with RPCAGateway(...)'"
                " or await start() first"
            )
        method = method or self._default_method
        n_req_arr = host_array(m_obs, bf16="tensor")
        width = self._width_for(n_req_arr.shape[-1] if n_req_arr.ndim == 2
                                else 0)
        svc = self._service(width)
        # Never-valid checks against the gateway bound (rows, width,
        # mask/warm shapes, method service support) -- ValueError here,
        # not a failed future later.
        method, n_req = svc.validate_submission(m_obs, warm, mask, method)
        if self._queued >= self.gcfg.max_queue:
            self._outcomes.add("shed")
            raise validate.gateway_queue_full(
                self._queued, self.gcfg.max_queue
            )
        try:
            data, data_paged = self._stage(n_req_arr)
        except validate.CapacityError:
            self._outcomes.add("shed")
            raise
        mask_h, mask_paged = (None, False)
        if mask is not None:
            try:
                mask_h, mask_paged = self._stage(
                    host_array(mask, bf16="tensor"))
            except validate.CapacityError:
                if data_paged:
                    self._pool.free(data)
                self._outcomes.add("shed")
                raise
        req = _Request(
            ticket=self._next_ticket,
            method=method,
            priority=int(priority),
            n_req=n_req,
            width=width,
            data=data,
            mask=mask_h,
            data_paged=data_paged,
            mask_paged=mask_paged,
            warm=warm,
            future=asyncio.get_running_loop().create_future(),
            t_submit=self._clock(),
            dtype=n_req_arr.dtype,
        )
        self._next_ticket += 1
        self._submitted += 1
        lane: _LaneKey = (method, width)
        self._queues.setdefault((req.priority, lane), deque()).append(req)
        self._queued += 1
        assert self._wake is not None
        self._wake.set()
        return Ticket(req)

    async def drain(self) -> None:
        """Wait until the queue and every in-flight solve are empty."""
        while self._queued or self._in_flight:
            await asyncio.sleep(0)

    def solve_all(
        self,
        matrices: list,
        *,
        methods: dict[int, str] | None = None,
        masks: dict[int, Any] | None = None,
        warm: dict[int, tuple] | None = None,
        priorities: dict[int, int] | None = None,
    ) -> list[RPCAResponse]:
        """Synchronous convenience driver: run an event loop, submit the
        queue (backing off on ``QueueFull`` -- live backpressure), await
        all results in order.  For async callers, use :meth:`submit`."""
        methods = methods or {}
        masks = masks or {}
        warm = warm or {}
        priorities = priorities or {}

        async def go() -> list[RPCAResponse]:
            async with self:
                tickets = []
                for qi, mat in enumerate(matrices):
                    while True:
                        try:
                            t = await self.submit(
                                mat,
                                method=methods.get(qi),
                                mask=masks.get(qi),
                                warm=warm.get(qi),
                                priority=priorities.get(qi, 0),
                            )
                            break
                        except validate.QueueFull:
                            await asyncio.sleep(0)  # admissions drain it
                    tickets.append(t)
                return [await t for t in tickets]

        return asyncio.run(go())

    # -- the request loop ----------------------------------------------------
    async def _run(self) -> None:
        assert self._wake is not None
        while self._running:
            progressed = self._pump()
            if progressed:
                # Yield so submitters / result-awaiters interleave with
                # compute; the loop resumes immediately after.
                await asyncio.sleep(0)
            else:
                self._wake.clear()
                try:
                    await asyncio.wait_for(
                        self._wake.wait(), self.gcfg.idle_sleep_s
                    )
                except (asyncio.TimeoutError, TimeoutError):
                    pass

    def _pump(self) -> bool:
        """One scheduler cycle: complete finished slots, admit queued
        requests, advance every lane by one tick.  Returns whether any
        work happened (the idle-parking signal)."""
        completed = self._complete()
        admitted = self._admit()
        advanced = 0
        if any(svc.pending() for svc in self._services.values()):
            advanced = self._tick_services()
            self._ticks += 1
            self._round_rate.add(advanced)
            self._maybe_snapshot()
        return bool(completed or admitted or advanced)

    def _complete(self) -> int:
        done = 0
        for (width, slot), req in list(self._in_flight.items()):
            svc = self._services[width]
            resp = svc.poll(slot)
            if resp is None:
                continue
            svc.release(slot)
            del self._in_flight[(width, slot)]
            self._latency.record(self._clock() - req.t_submit)
            if not req.future.cancelled() and resp.diverged:
                # Quarantined slot: the tenant gets a *typed* failure
                # (awaiting the ticket raises SolverDiverged) while
                # the freed slot goes back into rotation -- one
                # poisoned plane never fails the lane.
                self._outcomes.add("diverged")
                req.future.set_exception(validate.solver_diverged(
                    f"gateway ticket {req.ticket} "
                    f"({req.method}@{width})",
                    rounds=resp.rounds,
                ))
            else:
                self._outcomes.add("ok")
                if not req.future.cancelled():
                    req.future.set_result(resp)
            done += 1
        return done

    def _admit(self) -> int:
        """Admit queued requests: priority strictly first, stride-fair
        across lanes within a priority, work-conserving past full
        width-classes.  Deterministic for a given queue state."""
        admitted = 0
        progress = True
        while progress and self._queued:
            progress = False
            prios = sorted(
                {pr for (pr, _), q in self._queues.items() if q},
                reverse=True,
            )
            for pr in prios:
                lanes = sorted(
                    (lane for (p, lane), q in self._queues.items()
                     if p == pr and q),
                    key=lambda lk: (self._vtime.get(lk, 0.0), lk),
                )
                for lane in lanes:
                    req = self._queues[(pr, lane)][0]
                    svc = self._service(req.width)
                    if svc.free_slots() == 0:
                        continue  # width-class full: try the next lane
                    self._admit_one(pr, lane, req, svc)
                    admitted += 1
                    progress = True
                    break  # re-rank priorities + vtimes after each admit
                if progress:
                    break
        return admitted

    def _admit_one(self, pr: int, lane: _LaneKey, req: _Request,
                   svc: RPCAService) -> None:
        data = self._unstage(req.data, req.data_paged, req.dtype)
        mask = (self._unstage(req.mask, req.mask_paged, None)
                if req.mask is not None else None)
        slot = svc.try_submit(data, warm=req.warm, mask=mask,
                              method=req.method)
        q = self._queues[(pr, lane)]
        q.popleft()
        if not q:
            del self._queues[(pr, lane)]
        self._queued -= 1
        self._free_request(req)
        self._in_flight[(req.width, slot)] = req
        self.admissions.append(req.ticket)
        w = self._weights.get(req.method, 1.0)
        self._vtime[lane] = self._vtime.get(lane, 0.0) + 1.0 / float(w)

    def _tick_services(self) -> int:
        """Tick every lane with pending work; returns solver rounds
        actually advanced (frozen/converged slots don't count)."""
        advanced = 0
        for svc in self._services.values():
            if svc.pending() == 0:
                continue
            r0 = int(svc._rounds.sum())
            svc.tick()
            advanced += int(svc._rounds.sum()) - r0
        return advanced

    # -- staging -------------------------------------------------------------
    def _stage(self, plane: Any) -> tuple[Any, bool]:
        """Park one host plane: in the page pool when its dtype matches
        (bit-exact round trip), dense otherwise (bf16 tenants keep their
        storage dtype; the pool must not quantize)."""
        if isinstance(plane, np.ndarray) and plane.dtype == self._pool.dtype:
            return self._pool.put(plane), True
        return plane, False

    def _unstage(self, staged: Any, paged: bool, dtype: Any) -> Any:
        plane = self._pool.get(staged) if paged else staged
        if dtype is not None and plane.dtype != dtype:
            plane = plane.astype(dtype)
        return plane

    def _free_request(self, req: _Request) -> None:
        if req.data_paged:
            self._pool.free(req.data)
            req.data_paged = False
        if req.mask_paged:
            self._pool.free(req.mask)
            req.mask_paged = False

    # -- lanes ---------------------------------------------------------------
    def _width_for(self, n_req: int) -> int:
        """Lane width for a request: its page span, capped at ``n``."""
        if n_req <= 0:
            return self.n  # never-valid; the service raises with the
            # uniform message
        pages = -(-n_req // self.page_cols)
        return min(self.n, pages * self.page_cols)

    def _service(self, width: int) -> RPCAService:
        svc = self._services.get(width)
        if svc is None:
            # The first request at this width pays the lane build (the
            # tick's capture on the card, shared through the compile cache
            # with every same-geometry lane).
            svc = RPCAService(
                self.m, width, self.cfg, self._scfg, key=self._key,
                method=self._default_method, cfgs=dict(self._cfgs),
                device=self._device,
            )
            self._services[width] = svc
        return svc

    # -- observability -------------------------------------------------------
    def metrics(self) -> dict:
        """The gateway's observability surface.

        ``queue_depth``     staged requests awaiting admission;
        ``lanes``           per ``(method, width)`` occupancy over each
                            width-class slot table;
        ``padding``         slot-plane bytes allocated vs live, the
                            waste ratio, and the bytes a homogeneous
                            ``(slots, m, n)`` table would spend on the
                            same tenants (the paged pool's win);
        ``pool``            staging-pool page accounting;
        ``rounds_per_s``    solver rounds/sec over the rate window;
        ``latency``         submit->result p50/p99/max over the window;
        plus lifetime counters (``submitted`` / ``admitted`` /
        ``completed`` / ``shed`` / ``ticks``).
        """
        lanes: dict[str, dict] = {}
        alloc = live = homog = 0
        plane = 4 * self.m  # f32 data-plane bytes per column
        for width in sorted(self._services):
            svc = self._services[width]
            occ = svc.metrics()["lanes"]
            for meth, count in occ.items():
                lanes[f"{meth}@{width}"] = {
                    "method": meth,
                    "width": width,
                    "slots": self._scfg.slots,
                    "occupied": count,
                }
            act = svc._active
            alloc += int(act.sum()) * width * plane
            live += int(svc._slot_n[act].sum()) * plane
            homog += int(act.sum()) * self.n * plane
        return {
            "queue_depth": self._queued,
            "in_flight": len(self._in_flight),
            "lanes": lanes,
            "padding": {
                "allocated_bytes": alloc,
                "live_bytes": live,
                "waste_ratio": (alloc / live) if live else 1.0,
                "homogeneous_bytes": homog,
                "homogeneous_ratio": (homog / alloc) if alloc else 1.0,
            },
            "pool": self._pool.stats(),
            "rounds_per_s": self._round_rate.rate(),
            "rounds_total": int(self._round_rate.total),
            "latency": self._latency.summary(),
            "submitted": self._submitted,
            "admitted": len(self.admissions),
            **self._outcomes.summary(),
            "ticks": self._ticks,
        }

    def _maybe_snapshot(self) -> None:
        every = self.gcfg.snapshot_every
        if (self._snapshot_hook is not None and every > 0
                and self._ticks % every == 0):
            self._snapshot_hook(self.metrics())
