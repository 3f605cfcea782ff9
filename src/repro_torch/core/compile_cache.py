"""Shape-bucketed compile cache (counterpart of
``repro.core.compile_cache``).

The reference pays seconds of XLA tracing and compilation at every fresh
tenant shape and caches one ahead-of-time executable per shape bucket.
The port's counterpart of that cost is the set-up of a solve on the card:
static buffers for the problem, the carry and the traces, and the captured
CUDA graph of one round (``core.runtime``).  This module keeps one such
*bucket program* per bucket and admits every same-bucket problem into it:

* **Buckets.**  ``m`` and ``n`` round *up* to the reference's geometric
  grid (``bucket_min * bucket_ratio^k``); rank, method, data type and run
  mode stay exact (they key the entry through the solver config, the run
  config and the operand signature).

* **Padding rides the mask.**  An admitted problem is zero-padded into its
  bucket behind the observation mask (mask-zero rows and columns), which
  no solver here lets reach the true block, and the results are trimmed
  back to the true shape.  The reference pads and trims on the host
  because a device pad or slice would compile once per true shape; a
  PyTorch pad or slice compiles nothing, so here both run on the device.

* **One capture a bucket.**  Building an entry runs one round eagerly and
  captures it; a later admission at any same-bucket shape copies its
  problem into the entry's static buffers and replays the graph from the
  first round (``runtime.graph_counts`` proves it captures nothing).  A
  solver that cannot be captured (IALM and APGM: their SVD reads
  cuSOLVER's status on the host every iteration), and every solver on the
  CPU, keeps the bucket and the padding and runs its rounds eagerly.

* **LRU budget.**  Entries are evicted least recently used past
  ``CompilePolicy.max_entries`` / ``max_bytes`` (an entry's bytes: the
  device memory its build left allocated, or an eager entry's working
  set); the newest entry always stays.

Solvers opt in by registering ``rpca.AOTHooks``.  Specs the hooks cannot
express (batched, meshed, simulated-client or participation specs) take
the regular path: :func:`solve_cached` returns ``None`` for them.
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Callable

import torch

from repro_torch.core import runtime as rt
from repro_torch.core import validate

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Policy: bucket geometry + cache budget
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class CompilePolicy:
    """Bucketing and budget knobs for the cache (the reference's fields
    and defaults).

    ``bucket_min``    smallest bucket edge; every dimension rounds up to
                      at least this.
    ``bucket_ratio``  geometric growth factor between bucket edges (> 1).
    ``max_entries``   LRU entry budget for the cache this policy admits
                      into.
    ``max_bytes``     optional byte budget over the entries (device memory
                      each build left allocated, or an eager entry's
                      working set); ``None`` = unbounded.
                      The most recent entry is always kept.
    """

    bucket_min: int = 64
    bucket_ratio: float = 2.0
    max_entries: int = 32
    max_bytes: int | None = None

    def __post_init__(self) -> None:
        validate.check_compile_policy(
            self.bucket_min, self.bucket_ratio, self.max_entries,
            self.max_bytes,
        )


#: The policy behind ``compile_policy="aot"``.
AOT = CompilePolicy()


def resolve_policy(policy: "CompilePolicy | str | None"
                   ) -> CompilePolicy | None:
    """``None`` / ``"off"`` -> no caching, ``"aot"`` -> :data:`AOT`, a
    :class:`CompilePolicy` passes through; anything else raises the
    reference's error."""
    if policy is None:
        return None
    if isinstance(policy, CompilePolicy):
        return policy
    if isinstance(policy, str):
        if policy == "aot":
            return AOT
        if policy == "off":
            return None
    raise validate.unknown_compile_policy(policy)


def bucket_dim(x: int, policy: CompilePolicy) -> int:
    """Round one dimension up to the policy's geometric bucket grid."""
    if x < 1:
        raise ValueError(f"dimension must be >= 1 to bucket, got {x}")
    b = policy.bucket_min
    while b < x:
        # ceil keeps integer buckets; ratio > 1 guarantees progress.
        b = int(math.ceil(b * policy.bucket_ratio))
    return b


def bucket_shape(m: int, n: int, policy: CompilePolicy) -> tuple[int, int]:
    """The ``(m, n)`` bucket an admission pads into."""
    return bucket_dim(m, policy), bucket_dim(n, policy)


# ---------------------------------------------------------------------------
# Stats + the LRU cache
# ---------------------------------------------------------------------------
@dataclass
class CacheStats:
    """Cumulative cache counters (monotonic over the cache's lifetime;
    ``clear()`` drops entries but keeps counting).  ``compiles`` counts
    entry builds, one a bucket."""

    hits: int = 0
    misses: int = 0
    compiles: int = 0
    evictions: int = 0

    def snapshot(self) -> "CacheStats":
        return replace(self)

    def as_dict(self) -> dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "compiles": self.compiles, "evictions": self.evictions}


@dataclass
class _Entry:
    program: Any
    nbytes: int


class CompileCache:
    """LRU store of bucket programs keyed by (method, config, run mode,
    operand signature).  The module default is shared process-wide; tests
    build fresh instances."""

    def __init__(self) -> None:
        self._entries: "OrderedDict[Any, _Entry]" = OrderedDict()
        self.stats = CacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Any) -> bool:
        return key in self._entries

    @property
    def nbytes(self) -> int:
        """Total bytes of the cached entries."""
        return sum(e.nbytes for e in self._entries.values())

    def get(self, key: Any, build: Callable[[], Any],
            policy: CompilePolicy) -> Any:
        """The cached program for ``key``, building (and admitting under
        ``policy``'s budget) on a miss; a program's ``nbytes`` sizes it."""
        ent = self._entries.get(key)
        if ent is not None:
            self._entries.move_to_end(key)
            self.stats.hits += 1
            return ent.program
        self.stats.misses += 1
        program = build()
        self.stats.compiles += 1
        self._entries[key] = _Entry(program, int(getattr(program, "nbytes",
                                                         0)))
        self._evict(policy)
        return program

    def _evict(self, policy: CompilePolicy) -> None:
        while len(self._entries) > policy.max_entries or (
            policy.max_bytes is not None
            and self.nbytes > policy.max_bytes
            and len(self._entries) > 1  # the newest entry always stays
        ):
            self._entries.popitem(last=False)
            self.stats.evictions += 1

    def clear(self) -> None:
        """Drop every entry (cold behaviour restored); counters persist."""
        self._entries.clear()


_DEFAULT_CACHE = CompileCache()


def default_cache() -> CompileCache:
    """The process-wide cache behind ``solve(..., compile_policy=...)``."""
    return _DEFAULT_CACHE


# ---------------------------------------------------------------------------
# The bucket program
# ---------------------------------------------------------------------------
def arg_signature(tree: Any) -> tuple:
    """Hashable (shape, dtype) signature of a tree's tensor leaves: the
    operand part of a cache key (bucket shape, data type and warm layout;
    ``None`` leaves and seeds are not operands)."""
    return tuple((tuple(x.shape), str(x.dtype)) for x in rt.leaves(tree)
                 if isinstance(x, Tensor))


def _bytes(tree: Any) -> int:
    return sum(x.numel() * x.element_size() for x in rt.leaves(tree)
               if isinstance(x, Tensor))


class BucketProgram:
    """One cache entry: on the card, for a capturable solver, the bucket's
    static problem, carry and traces and its captured round; otherwise
    nothing but the solver, and every admission runs :func:`runtime.run`
    on its padded problem.

    The graph entry is built from the first admission's problem: its
    leaves are cloned into the static problem, and one round runs eagerly
    and is captured.  :meth:`__call__` copies an admission's problem into
    the static one, resets the carry, the round index and the traces, and
    replays every round, then finalizes and returns ``(finalize output,
    stats)`` on fresh tensors."""

    def __init__(self, solver: rt.Solver, iters: int, run_cfg: rt.RunConfig,
                 problem: Any):
        self.solver, self.iters, self.run_cfg = solver, iters, run_cfg
        device = rt.device_of(problem)
        self.graph = rt.use_graph(solver, device, False, iters)
        if not self.graph:
            #: The bucket's working set (problem, carry and traces), the
            #: counterpart of the reference's temp size.
            self.nbytes = _bytes(problem) + _bytes(
                rt.single_state(solver, problem, iters))
            return
        before = torch.cuda.memory_allocated(device)
        self.problem = rt.tree_map(torch.clone, problem)
        self.rounds = rt.Rounds(
            rt.single_body(solver, self.problem),
            rt.single_state(solver, self.problem, iters), device, graph=True)
        self.rounds.advance(1)  # the warm-up round and the capture
        #: Device memory the build left allocated (static buffers and what
        #: the graph keeps).
        self.nbytes = torch.cuda.memory_allocated(device) - before

    def __call__(self, problem: Any) -> tuple[Any, rt.SolveStats]:
        if not self.graph:
            carry, stats = rt.run(self.solver, problem, self.iters,
                                  self.run_cfg)
            return self.solver.finalize(problem, carry), stats
        rt.copy_into(self.problem, problem)
        rt.copy_into(self.rounds.state, rt.single_state(
            self.solver, self.problem, self.iters))
        carry, stats = rt.drive(self.rounds, self.run_cfg, self.iters)
        out = self.solver.finalize(self.problem, carry)
        # The static buffers belong to the next admission.
        return rt.tree_map(torch.clone, (out, stats))


def _pad2(x: Tensor, mb: int, nb: int, dtype=None) -> Tensor:
    """``x`` zero-padded into a fresh (mb, nb) plane on its device (a
    device pad: no per-shape compile to avoid here, unlike the
    reference's host pad)."""
    out = torch.zeros(mb, nb, dtype=dtype or x.dtype, device=x.device)
    out[: x.shape[0], : x.shape[1]] = x
    return out


def _admit(aot: Any, spec: Any, cfg: Any, m: int, n: int, mb: int, nb: int,
           device: torch.device) -> tuple:
    """The padded operands ``(m_obs, key, mask, warm, lam0)`` on
    ``device``.  The mask plane is always there: an unmasked admission gets
    the all-ones plane (numerically the unmasked path) and the bucket tail
    is mask-zero either way.  ``lam0`` is the true-shape convex threshold
    ``1/sqrt(max(m, n))``, computed as the convex solvers' default (solvers
    that calibrate on the device ignore it).  The caller's tensors are
    read, never written."""
    x = torch.as_tensor(spec.m_obs).to(device)
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    xp = _pad2(x, mb, nb)
    w = torch.zeros(mb, nb, device=device)
    if spec.mask is not None:
        w[:m, :n] = torch.as_tensor(spec.mask).to(device, torch.float32)
    else:
        w[:m, :n] = 1.0
    warm = None
    if spec.warm is not None:
        padded = []
        for wf, (name, shape, desc), (_, target, _) in zip(
                spec.warm, aot.warm_shapes(cfg, m, n),
                aot.warm_shapes(cfg, mb, nb)):
            validate.check_factor(wf, shape, name, desc)
            arr = torch.as_tensor(wf).to(device, torch.float32)
            out = torch.zeros(target, device=device)
            out[tuple(slice(0, d) for d in shape)] = arr
            padded.append(out)
        warm = tuple(padded)
    lam0 = 1.0 / torch.sqrt(torch.full((), float(max(m, n)), device=device))
    key = 0 if spec.key is None else spec.key
    return xp, key, w, warm, lam0


def _trim(x: Tensor | None, *shape: int) -> Tensor | None:
    """The true-shape corner of a padded result (a device slice)."""
    if x is None:
        return None
    return x[tuple(slice(0, d) for d in shape)].clone()


def solve_cached(entry: Any, spec: Any, cfg: Any, run_cfg: rt.RunConfig,
                 policy: CompilePolicy, cache: CompileCache | None = None,
                 device: torch.device | None = None) -> tuple | None:
    """One solve through the cache on ``device``: ``(l, s, u, v, stats,
    CacheStats snapshot)`` trimmed to the spec's true shape, or ``None``
    when the spec is out of the cache's scope (no AOT hooks for the method;
    batched, meshed, simulated-client or participation specs) and the
    caller takes the regular path."""
    aot = getattr(entry, "aot", None)
    if aot is None:
        return None
    if (spec.batched or spec.mesh is not None
            or spec.num_clients is not None
            or spec.participation is not None):
        return None
    cache = cache if cache is not None else default_cache()
    device = device if device is not None else torch.device("cuda")
    cfg = aot.resolve_cfg(cfg, spec)
    m, n = spec.shape
    mb, nb = bucket_shape(m, n, policy)
    args = _admit(aot, spec, cfg, m, n, mb, nb, device)
    key = (entry.name, cfg, run_cfg, str(device), arg_signature(args))
    solver, iters, make_problem = aot.program(cfg, run_cfg)
    problem = make_problem(*args)
    program = cache.get(
        key, lambda: BucketProgram(solver, iters, run_cfg, problem), policy)
    out, stats = program(problem)
    l, s, u, v = (*out, None, None)[:4]
    return (_trim(l, m, n), _trim(s, m, n), _trim(u, m), _trim(v, n), stats,
            cache.stats.snapshot())
