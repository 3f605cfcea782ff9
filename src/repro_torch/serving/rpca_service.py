"""Slot-based batched RPCA serving (counterpart of
``repro.serving.rpca_service``).

A fixed table of request *slots* advances in lock-step: each tick runs
``rounds_per_tick`` rounds for every in-flight problem, per-slot masks
freeze finished problems (their carry stops updating), and the caller
refills freed slots between ticks.  Every registered method whose
capabilities include ``supports_service`` can back a slot (``cf``,
``apgm``, ``ialm``); ``try_submit(m_obs, method=...)`` picks the solver
per request.  Each method in use gets a *lane*: its own homogeneous
batched problem (a leading slot axis on every field) and carry over the
service's slot table.  Slots stay one namespace, so ``try_submit / tick /
poll / release`` is method-oblivious.

Warm starts continue the schedule (``(U, V)`` for ``cf``, which then
starts at ``t0 = outer_iters``; ``(L, S)`` for the convex lanes); masks are
per slot (a maskless submission gets the all-ones plane, bit for bit the
unmasked ``cf`` solve); a ragged ``(m, n_req)`` problem is zero-padded
behind mask-zero columns and trimmed back at :meth:`RPCAService.poll`; the
``robust_lam`` calibration is cached by content fingerprints of the
submitted planes; a slot whose residual goes non-finite is quarantined.

    svc = RPCAService(m, n, DCFConfig.tuned(rank=8))   # on the card
    slot = svc.try_submit(m_obs, mask=omega)
    while svc.pending():
        svc.tick()
    resp = svc.poll(slot)            # RPCAResponse(l, s, u, v, rounds, ...)
    svc.release(slot)

**On the card.**  The round (``core.runtime.slot_body``) reads nothing on
the host, so a ``cf`` lane's tick is ``rounds_per_tick`` replays of one
captured round over the slot table, the freeze inside the graph.  The
convex lanes tick eagerly: their SVD reads cuSOLVER's status on the host
(``Solver.capturable`` is False).  An admission writes the slot's rows of
the lane's problem and carry in place (``copy_``), the host refreshes the
graph's ``active`` buffer before each tick, and :meth:`RPCAService.poll`
returns fresh tensors that no later tick or admission overwrites.  Every
round graph of a device replays on the current stream, one at a time (they
share one memory pool, ``core.runtime``).  ``eager=True`` ticks eagerly on
the card (the tests hold the replays to it).

**The compile cache.**  A lane takes its tick, finalize and slot-write
programs from ``core.compile_cache.default_cache()`` under the reference's
keys (``("service_tick", method, cfg, scfg, m, n)``, ``("service_finalize",
method, cfg, m, n)``, ``("service_write_slot", structure, signature)``,
each with the device appended and the tick's with whether it replays a
graph), so the cache counts what the reference's counts under the same
sequence.  A tick entry (:class:`_TickProgram`) on the card holds the
captured round and its static buffers: the slot table's problem, carry and
counters.  A graph is bound to its buffers, so two lanes of one geometry
(two services) share the entry by ownership: the lane that ticks it owns
the static buffers (its ``problems`` and ``carry`` *are* them, and its
admissions write there).  When another lane ticks the entry, the owner's
problem and carry are first copied out into tensors of its own, then the
new lane's are copied in; the counters move in and out at every tick (a
few (slots,) vectors, as every lane of a service shares them).  A second
service of the same geometry therefore captures nothing, and the
gateway's width classes, whose keys differ, never swap.  A lane keeps its
entry alive, so an LRU eviction frees no live lane's buffers.

Host reads: a fingerprint needs the plane's bytes on the host (a submitted
CUDA tensor pays a device-to-host copy), a calibrating admission reads
``lam0`` back (one sync), and :meth:`RPCAService.pending` and
:meth:`RPCAService.poll` read the slot counters once a call.
"""
from __future__ import annotations

import dataclasses
import hashlib
import warnings
import weakref
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import rpca as _rpca
from repro_torch.core import compile_cache as cc
from repro_torch.core import runtime as rt
from repro_torch.core import validate
from repro_torch.core.factorized import DCFConfig
from repro_torch.device import resolve_device

Tensor = torch.Tensor

#: Entries kept in each service's robust_lam calibration cache (a 16-byte
#: fingerprint pair -> one float per distinct tenant plane).
_LAM_CACHE_CAP = 128


def host_array(x: Any, bf16: str = "bits") -> Any:
    """``x``'s values on the host: numpy arrays, lists and tensors as numpy
    (a CUDA tensor pays a device-to-host copy).  numpy has no bf16, so the
    caller picks what a bf16 tensor becomes: ``"bits"``, its 16-bit
    patterns as int16 (the fingerprints); ``"tensor"``, the host tensor
    itself (the gateway stages it dense)."""
    if isinstance(x, Tensor):
        x = x.detach().cpu()
        if x.dtype != torch.bfloat16:
            return x.numpy()
        return x if bf16 == "tensor" else x.view(torch.int16).numpy()
    return np.asarray(x)


def _fingerprint(x: Any) -> bytes | None:
    """Content fingerprint of one data or mask plane (dtype, shape and
    bytes); ``None`` stays ``None`` so (M, mask) pairs key cleanly."""
    if x is None:
        return None
    dtype = str(x.dtype) if isinstance(x, Tensor) else None
    arr = np.ascontiguousarray(host_array(x))
    h = hashlib.blake2b(digest_size=16)
    h.update((dtype or str(arr.dtype)).encode())
    h.update(np.asarray(arr.shape, np.int64).tobytes())
    h.update(arr.tobytes())
    return h.digest()


@dataclass(frozen=True)
class RPCAServiceConfig:
    """Service knobs (static: they key the lanes' tick programs)."""

    slots: int = 8  # concurrent in-flight problems
    rounds_per_tick: int = 8  # solver rounds per tick
    max_rounds: int = 200  # per-problem round budget
    tol: float = 5e-4  # rel-residual convergence tolerance
    min_rounds: int = 2  # suppress spurious first-round exits


class RPCAResponse(NamedTuple):
    l: Tensor  # recovered low-rank matrix (m, n)
    s: Tensor  # recovered sparse matrix (m, n)
    u: Tensor | None  # left factor (m, r) -- reuse as warm start (cf lane)
    v: Tensor | None  # right factor (n, r); None for the convex lanes
    rounds: int  # solver rounds actually spent
    converged: bool  # met the tolerance (False => ran out of max_rounds)
    method: str = "cf"  # which registered solver ran this slot
    #: The slot's residual went non-finite mid-solve: the slot was
    #: quarantined (frozen and marked done) at that round, so its NaNs never
    #: reached the other tenants.  ``l``/``s`` are whatever the iterate held;
    #: the gateway maps this to :class:`~repro_torch.core.validate.
    #: SolverDiverged`.
    diverged: bool = False


def _structure(tree: Any) -> Any:
    """A hashable description of a tree's structure (the reference's
    ``jax.tree.structure`` in the slot writers' cache key)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree).__qualname__, tuple(_structure(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(x) for x in tree))
    return "*"


def _write_rows(batched: Any, single: Any, slot: int) -> None:
    """``batched[slot] = single`` leaf by leaf, in place (a lane's static
    buffers stay the graph's)."""
    for b, x in zip(rt.leaves(batched), rt.leaves(single), strict=True):
        b[slot].copy_(x)


class _TickProgram:
    """A lane's tick, the compile-cache entry of ``("service_tick", ...)``:
    ``rounds_per_tick`` slot rounds through :class:`runtime.Rounds`.

    Eagerly (the CPU, the convex lanes, ``eager=True``) the rounds run over
    the ticking lane's own tensors.  With ``graph`` (a capturable solver on
    the card) the entry holds static buffers (the slot table's problem,
    carry, counters and ``active``) and one captured round over them, built
    here: the warm-up round runs with no slot active (it moves nothing) and
    the capture follows.  A tick is then ``rounds_per_tick`` replays; the
    ticking lane owns the static buffers (:meth:`adopt`)."""

    def __init__(self, solver: rt.Solver, scfg: RPCAServiceConfig,
                 problems: Any, carry: Any, device: torch.device,
                 graph: bool):
        self.scfg, self.graph, self.device = scfg, graph, device
        self._solver = solver
        self._owner: weakref.ref | None = None
        if not graph:
            self.nbytes = 0
            return
        cuda = device.type == "cuda"
        before = torch.cuda.memory_allocated(device) if cuda else 0
        self.problems = rt.tree_map(torch.clone, problems)
        state = {"carry": carry, **rt.slot_counters(scfg.slots, device),
                 "active": torch.zeros(scfg.slots, dtype=torch.bool,
                                       device=device)}
        self.rounds = rt.Rounds(self._body(self.problems), state, device,
                                graph=True)
        self.rounds.advance(1)
        #: Device memory the build left allocated (static buffers and what
        #: the graph keeps).
        self.nbytes = (torch.cuda.memory_allocated(device) - before
                       if cuda else 0)

    def _body(self, problems: Any):
        s = self.scfg
        return rt.slot_body(self._solver, problems, s.tol, s.min_rounds,
                            s.max_rounds)

    def adopt(self, lane: "_Lane") -> None:
        """Make ``lane`` the owner of the static buffers: the previous
        owner's problem and carry are copied out to tensors of its own,
        ``lane``'s copied in, and ``lane`` then holds the static ones."""
        owner = None if self._owner is None else self._owner()
        if owner is lane:
            return
        carry = self.rounds.state["carry"]
        if owner is not None:
            owner.problems = rt.tree_map(torch.clone, self.problems)
            owner.carry = rt.tree_map(torch.clone, carry)
        rt.copy_into(self.problems, lane.problems)
        rt.copy_into(carry, lane.carry)
        lane.problems, lane.carry = self.problems, carry
        self._owner = weakref.ref(lane)

    def tick(self, lane: "_Lane", counters: dict, active: Tensor) -> dict:
        """``rounds_per_tick`` rounds of ``lane``'s ``active`` slots from the
        service's ``counters``; returns the new counters (fresh tensors)
        and leaves the new carry in ``lane.carry``."""
        if self.graph:
            self.adopt(lane)
            rounds, fresh = self.rounds, {**counters, "active": active}
            rt.copy_into({k: rounds.state[k] for k in fresh}, fresh)
        else:
            rounds = rt.Rounds(self._body(lane.problems),
                               {"carry": lane.carry, **counters,
                                "active": active}, self.device, graph=False)
        rounds.advance(self.scfg.rounds_per_tick)
        lane.carry = rounds.state["carry"]
        return {k: rounds.state[k].clone() for k in rt.SLOT_COUNTERS}


class _Lane:
    """One registered method's slot-table state: a homogeneous batched
    problem, its carry, and the tick / finalize programs from the compile
    cache."""

    def __init__(self, method: str, hooks: _rpca.ServiceHooks, cfg: Any,
                 scfg: RPCAServiceConfig, m: int, n: int,
                 device: torch.device, eager: bool):
        self.method = method
        self.hooks = hooks
        self.cfg = cfg
        self.solver = hooks.make_solver(cfg)
        self.problems = hooks.empty_problems(cfg, scfg.slots, m, n, device)
        self.carry = self.solver.init(self.problems)
        # A slot's budget is max_rounds, as a solve's is its round count.
        graph = rt.use_graph(self.solver, device, eager, scfg.max_rounds)
        cache = cc.default_cache()
        where = str(device)
        self._tick = cache.get(
            ("service_tick", method, cfg, scfg, m, n, where, graph),
            lambda: _TickProgram(self.solver, scfg, self.problems,
                                 self.carry, device, graph),
            cc.AOT,
        )
        self._finalize_one = cache.get(
            ("service_finalize", method, cfg, m, n, where),
            lambda: self.solver.finalize, cc.AOT,
        )

    def write_slot(self, batched: Any, single: Any, slot: int) -> None:
        """``batched[slot] = single`` over a tree, in place, through the
        shared compile cache (keyed on the tree's structure and leaf
        signature, so the problem- and carry-shaped writers of every
        same-geometry lane each count one build process-wide)."""
        key = (
            "service_write_slot",
            _structure((batched, single)),
            cc.arg_signature((batched, single)),
        )
        write = cc.default_cache().get(key, lambda: _write_rows, cc.AOT)
        write(batched, single, slot)


def _pad_cols(x: Tensor, pad: int, axis: int = 1) -> Tensor:
    """``x`` zero-padded by ``pad`` entries at the end of ``axis``."""
    spec = [0, 0] * x.ndim
    spec[2 * (x.ndim - 1 - axis) + 1] = pad
    return F.pad(x, spec)


class RPCAService:
    """Batched multi-tenant RPCA solves over ``scfg.slots`` request slots
    on ``device`` (the card unless ``"cpu"``).

    ``method`` is the default lane for submissions and ``cfg`` its solver
    config; other service-capable methods are available per request
    (``try_submit(..., method=...)``), their configs from ``cfgs`` (else
    the registry's default config for that method).  ``key`` seeds the
    factor init: submission i draws its factors as ``rpca.batch_keys``
    would, from seed ``key + i`` (default 0), or from one
    ``torch.Generator`` in submission order.  ``eager=True`` ticks eagerly
    on the card (the tests and ``chip_smoke.py`` hold the replayed ticks
    to it)."""

    def __init__(
        self,
        m: int,
        n: int,
        cfg: Any,
        scfg: RPCAServiceConfig = RPCAServiceConfig(),
        key: int | torch.Generator | None = None,
        method: str = "cf",
        cfgs: dict[str, Any] | None = None,
        *,
        device: torch.device | str | None = None,
        eager: bool = False,
    ):
        self.cfg = cfg
        self.scfg = scfg
        self.m = m
        self.n = n
        self.device = resolve_device(device)
        self.eager = eager
        self._key = key
        self._n_submitted = 0
        self._default_method = method
        self._cfgs = dict(cfgs or {})
        self._cfgs.setdefault(method, cfg)

        b = scfg.slots
        # Per-slot counters on the device: schedule position, rounds spent,
        # done, met the tolerance (vs budget-out), quarantined.
        counters = rt.slot_counters(b, self.device)
        self._t, self._done, self._rounds, self._hit, self._dived = (
            counters[k] for k in rt.SLOT_COUNTERS)
        self._active = np.zeros((b,), bool)  # host-side slot occupancy
        self._slot_n = np.full((b,), n, np.int64)  # true width per slot
        self._slot_method = [method] * b  # lane owning each slot
        # lam-cache fingerprint held by each slot (None = the slot's cfg
        # does not calibrate); release() evicts the entry when the last
        # slot holding a fingerprint departs.
        self._slot_lam_fp: list[tuple | None] = [None] * b

        # robust_lam calibration cache: (M fingerprint, mask fingerprint)
        # -> calibrated lam.  Warm refreshes of unchanged tenant data skip
        # the full-matrix sorts.
        self._lam_cache: "OrderedDict[tuple, float]" = OrderedDict()
        self._lam_hits = 0
        self._lam_misses = 0

        self._lanes: dict[str, _Lane] = {}
        self._lane(method)  # build the default lane eagerly

    # -- lanes ---------------------------------------------------------------
    def _lane(self, method: str) -> _Lane:
        lane = self._lanes.get(method)
        if lane is not None:
            return lane
        entry = _rpca.get_solver(method)
        if entry.service is None or not entry.caps.supports_service:
            raise ValueError(
                f"method {method!r} does not support the slot service; "
                f"service methods: "
                f"{', '.join(_rpca.methods_with('supports_service'))}"
            )
        cfg = self._cfgs.get(method)
        if cfg is None:
            if entry.service.default_cfg is None:
                raise ValueError(
                    f"service lane {method!r} needs a config: pass "
                    f"cfgs={{{method!r}: ...}} to RPCAService"
                )
            cfg = entry.service.default_cfg()
            self._cfgs[method] = cfg
        if entry.service.cfg_type is not None:
            _rpca.require_cfg_type(method, cfg, entry.service.cfg_type)
        lane = _Lane(method, entry.service, cfg, self.scfg, self.m, self.n,
                     self.device, self.eager)
        self._lanes[method] = lane
        return lane

    def _counters(self) -> dict:
        return dict(zip(rt.SLOT_COUNTERS, (self._t, self._done, self._rounds,
                                           self._hit, self._dived)))

    def _next_key(self) -> int | torch.Generator:
        """The factor seed (or generator) of the next submission."""
        i = self._n_submitted
        self._n_submitted += 1
        if isinstance(self._key, torch.Generator):
            return self._key
        return (0 if self._key is None else int(self._key)) + i

    # -- request lifecycle ---------------------------------------------------
    def validate_submission(self, m_obs: Any, warm: tuple | None = None,
                            mask: Any = None, method: str | None = None
                            ) -> tuple[str, int]:
        """Run the *never-valid* admission checks without consuming a
        slot: method service support, row count / width fit, mask shape,
        warm-factor shapes.  Returns the resolved ``(method, n_req)``.  The
        gateway calls this at submission, so a doomed request raises
        ``ValueError`` at the caller instead of queueing."""
        method = method or self._default_method
        lane = self._lane(method)  # validates the method before the shapes
        n_req = validate.check_service_problem(m_obs, self.m, self.n)
        validate.check_mask(mask, tuple(m_obs.shape))
        if warm is not None:
            warm = validate.check_warm_pair(warm)
            layout = lane.hooks.warm_layout(lane.cfg, self.m, n_req)
            for w, (name, shape, desc, _) in zip(warm, layout):
                validate.check_factor(w, shape, name, desc)
        return method, n_req

    def free_slots(self) -> int:
        """Host-side free-slot count (no device sync)."""
        return int((~self._active).sum())

    def try_submit(self, m_obs: Any, warm: tuple | None = None,
                   mask: Any = None, method: str | None = None) -> int:
        """Place a problem into a free slot; returns the slot id.

        A problem that can never fit (wrong row count, too many columns, a
        mis-shaped mask or warm pair, a method without service support)
        raises ``ValueError``; a *full* slot table raises
        :class:`~repro_torch.core.validate.CapacityError` (transient: retry
        after a tick, poll and release).  ``warm`` is lane-shaped: ``(U,
        V)`` for ``cf``, ``(L, S)`` for the convex lanes.  ``mask`` is this
        request's 0/1 observation mask.  An ``(m, n_req)`` problem with
        ``n_req < n`` is zero-padded behind mask-zero columns and
        :meth:`poll` trims the response back."""
        method, n_req = self.validate_submission(m_obs, warm, mask, method)
        lane = self._lanes[method]
        layout = lane.hooks.warm_layout(lane.cfg, self.m, n_req)
        if warm is not None:
            warm = validate.check_warm_pair(warm)
        free = np.flatnonzero(~self._active)
        if free.size == 0:
            raise validate.service_at_capacity(self.scfg.slots)
        slot = int(free[0])
        key = self._next_key()
        # The lam calibration cache: fingerprints of the *submitted*
        # (unpadded) planes, only for configs that sort the data for lam
        # (the factorized family with lam=None).  ``fp_key`` is kept per
        # slot, hit or miss, so release() can evict by refcount.
        cfg_sub, fp_key, lam_fp = lane.cfg, None, None
        if isinstance(lane.cfg, DCFConfig) and lane.cfg.lam is None:
            fp_key = (_fingerprint(m_obs), _fingerprint(mask))
            lam_hit = self._lam_cache.get(fp_key)
            if lam_hit is not None:
                self._lam_cache.move_to_end(fp_key)
                self._lam_hits += 1
                cfg_sub = dataclasses.replace(lane.cfg, lam=lam_hit)
            else:
                self._lam_misses += 1
                lam_fp = fp_key
        if n_req < self.n:
            # Ragged width: pad the data and the mask's base plane with
            # mask-zero columns, so the padded tail never reaches the solve;
            # lam still calibrates on the real columns (the masked medians
            # ignore mask-zero entries).
            pad = self.n - n_req
            m_obs = torch.as_tensor(m_obs).to(self.device)
            base = (torch.ones(tuple(m_obs.shape), device=self.device)
                    if mask is None else
                    torch.as_tensor(mask).to(self.device, torch.float32))
            mask = _pad_cols(base, pad)
            m_obs = _pad_cols(m_obs, pad)
            if warm is not None:
                warm = tuple(
                    w if ax is None else _pad_cols(
                        torch.as_tensor(w).to(self.device, torch.float32),
                        pad, ax)
                    for w, (_, _, _, ax) in zip(warm, layout))
        problem = lane.hooks.make_problem(m_obs, cfg_sub, key, warm, mask,
                                          self.device)
        if lam_fp is not None:
            # Freshly calibrated: remember it for the next refresh of the
            # same (M, mask) pair (one device sync).
            self._lam_cache[lam_fp] = float(problem.lam0)
            while len(self._lam_cache) > _LAM_CACHE_CAP:
                self._lam_cache.popitem(last=False)
        self._slot_n[slot] = n_req
        self._slot_method[slot] = method
        self._slot_lam_fp[slot] = fp_key
        lane.write_slot(lane.problems, problem, slot)
        lane.write_slot(lane.carry, lane.solver.init(problem), slot)
        for counter in (self._t, self._rounds, self._done, self._hit,
                        self._dived):
            counter[slot] = 0
        self._active[slot] = True
        return slot

    def submit(self, m_obs: Any, warm: tuple | None = None, mask: Any = None,
               method: str | None = None) -> int | None:
        """Legacy admission shim: like :meth:`try_submit`, but returns
        ``None`` when the table is full instead of raising.

        .. deprecated::
            The ``None``-on-capacity return conflates "no result" with a
            typed, retryable condition; kept for existing callers (with a
            ``DeprecationWarning`` on the capacity path only).  New code
            calls :meth:`try_submit` and handles ``CapacityError``.
        """
        try:
            return self.try_submit(m_obs, warm, mask=mask, method=method)
        except validate.CapacityError:
            warnings.warn(
                "RPCAService.submit() returning None at capacity is "
                "deprecated; call try_submit() and handle CapacityError",
                DeprecationWarning,
                stacklevel=2,
            )
            return None

    def tick(self) -> None:
        """Advance every in-flight problem by ``rounds_per_tick`` rounds.

        Lanes tick one after the other, each advancing only its own
        occupied slots (disjoint sets), so the shared per-slot counters
        compose."""
        methods = np.asarray(self._slot_method)
        for name, lane in self._lanes.items():
            lane_active = self._active & (methods == name)
            if not lane_active.any():  # host-side skip: no device sync
                continue
            out = lane._tick.tick(
                lane, self._counters(),
                torch.from_numpy(lane_active).to(self.device))
            self._t, self._done, self._rounds, self._hit, self._dived = (
                out[k] for k in rt.SLOT_COUNTERS)

    def poll(self, slot: int) -> RPCAResponse | None:
        """Result for ``slot`` if it finished, else ``None``.  The slot stays
        occupied until :meth:`release`.  The tensors are fresh: no later
        tick or admission writes into them."""
        if not (0 <= slot < self.scfg.slots) or not self._active[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        rounds, done, hit, dived = torch.stack([
            self._rounds[slot], self._done[slot].to(torch.int32),
            self._hit[slot].to(torch.int32),
            self._dived[slot].to(torch.int32)]).tolist()
        if not done:
            return None
        lane = self._lanes[self._slot_method[slot]]

        def take(tree):
            return rt.tree_map(lambda a: a[slot], tree)

        fin = lane._finalize_one(take(lane.problems), take(lane.carry))
        l, s, u, v = lane.hooks.unpack(fin)
        n_req = int(self._slot_n[slot])
        l, s = l[:, :n_req].clone(), s[:, :n_req].clone()
        u = None if u is None else u.clone()
        v = None if v is None else v[:n_req].clone()
        if dived:
            # A quarantined tenant's calibration entry is suspect (the same
            # plane would diverge again): evict it now.
            fp = self._slot_lam_fp[slot]
            self._slot_lam_fp[slot] = None
            if fp is not None:
                self._lam_cache.pop(fp, None)
        return RPCAResponse(l=l, s=s, u=u, v=v, rounds=int(rounds),
                            converged=bool(hit), method=lane.method,
                            diverged=bool(dived))

    def release(self, slot: int) -> None:
        """Free ``slot`` for reuse and drop its bookkeeping.  Also evicts
        the slot's ``robust_lam`` cache entry unless another occupied slot
        shares the (M, mask) fingerprint: the cache serves in-tenancy warm
        refreshes, not departed tenants."""
        if not (0 <= slot < self.scfg.slots) or not self._active[slot]:
            raise ValueError(f"slot {slot} is not occupied")
        self._active[slot] = False
        fp = self._slot_lam_fp[slot]
        self._slot_lam_fp[slot] = None
        if fp is not None and not any(
            self._slot_lam_fp[i] == fp
            for i in np.flatnonzero(self._active)
        ):
            self._lam_cache.pop(fp, None)

    def pending(self) -> int:
        """Number of occupied slots still iterating (one device read)."""
        return int((self._active & ~self._done.cpu().numpy()).sum())

    def metrics(self) -> dict[str, Any]:
        """Slot occupancy, the shared compile cache's counters (process
        wide), this service's lam-calibration cache counters and the
        process-wide consensus traffic counters
        (``distributed.multihost.consensus_traffic``)."""
        from repro_torch.distributed import multihost as mh

        cache = cc.default_cache()
        methods = np.asarray(self._slot_method)
        return {
            "slots": int(self.scfg.slots),
            "active": int(self._active.sum()),
            "pending": self.pending(),
            "diverged": int((self._active
                             & self._dived.cpu().numpy()).sum()),
            "lanes": {
                name: int((self._active & (methods == name)).sum())
                for name in self._lanes
            },
            "compile_cache": {
                **cache.stats.as_dict(),
                "entries": len(cache),
                "bytes": cache.nbytes,
            },
            "lam_cache": {
                "hits": self._lam_hits,
                "misses": self._lam_misses,
                "entries": len(self._lam_cache),
            },
            "consensus": mh.consensus_traffic(),
        }

    # -- convenience ---------------------------------------------------------
    def solve_all(self, matrices: list, warm: dict | None = None,
                  masks: dict | None = None, methods: dict | None = None
                  ) -> list[RPCAResponse]:
        """Drain a queue of problems through the slots (continuous refill).
        ``warm``, ``masks`` and ``methods`` map queue indices to warm
        pairs, masks and solver names.  Responses come in queue order."""
        warm = warm or {}
        masks = masks or {}
        methods = methods or {}
        results: list[RPCAResponse | None] = [None] * len(matrices)
        queue = list(enumerate(matrices))
        in_flight: dict[int, int] = {}  # slot -> queue index
        while queue or in_flight:
            while queue:
                qi, mat = queue[0]
                try:
                    slot = self.try_submit(mat, warm.get(qi),
                                           mask=masks.get(qi),
                                           method=methods.get(qi))
                except validate.CapacityError:
                    break
                queue.pop(0)
                in_flight[slot] = qi
            self.tick()
            for slot in list(in_flight):
                resp = self.poll(slot)
                if resp is not None:
                    results[in_flight.pop(slot)] = resp
                    self.release(slot)
        return results
