"""Host-side counters that a replayed CUDA graph advances by hand.

A wrapper counts when it runs on the host: a kernel launch
(``kernels.ops.launch_counts``), a collective's calls and bytes
(``distributed.multihost.wire_counts``).  A replayed round runs no wrapper,
so ``core.runtime.CapturedRound`` takes back what its capture counted and
adds it again at every replay.  A module whose wrappers count registers its
counters here, by name: a snapshot (counter -> number) and an ``add`` of a
delta.
"""
from __future__ import annotations

from typing import Callable

_REGISTRY: dict[str, tuple[Callable[[], dict], Callable[[dict], None]]] = {}


def register(name: str, snapshot: Callable[[], dict],
             add: Callable[[dict], None]) -> None:
    _REGISTRY[name] = (snapshot, add)


def snapshot() -> dict[str, dict]:
    """Every registered counter, by registry name."""
    return {name: snap() for name, (snap, _) in _REGISTRY.items()}


def since(before: dict[str, dict]) -> dict[str, dict]:
    """What each counter moved since ``before`` (a :func:`snapshot`); the
    counters that did not move are left out."""
    moved = {}
    for name, now in snapshot().items():
        old = before.get(name, {})
        delta = {k: n - old.get(k, 0) for k, n in now.items()
                 if n != old.get(k, 0)}
        if delta:
            moved[name] = delta
    return moved


def add(delta: dict[str, dict], sign: int = 1) -> None:
    """Add ``sign`` times ``delta`` (a :func:`since`) to the counters."""
    for name, counts in delta.items():
        _REGISTRY[name][1]({k: sign * n for k, n in counts.items()})
