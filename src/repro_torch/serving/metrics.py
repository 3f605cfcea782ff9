"""Serving observability primitives (counterpart of
``repro.serving.metrics``, the same collectors and numbers).

Small, dependency-free collectors the gateway composes into its
``metrics()`` surface:

``LatencyWindow``  bounded reservoir of submit->result latencies with
                   p50/p99 summaries (numpy percentile over the window;
                   a deque cap keeps long-lived gateways O(1) memory);
``RateMeter``      windowed event rate (rounds/sec, completions/sec) --
                   timestamped increments, rate over a sliding horizon
                   so idle gaps decay instead of averaging over the
                   process lifetime.
``OutcomeCounter`` typed terminal-outcome tally (ok / diverged / shed)
                   -- a closed vocabulary so a typo'd outcome is a
                   crash at the increment site, not a silently separate
                   time series on the dashboard.

The time-based collectors take an injectable ``clock`` so tests pin
time deterministically.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable

import numpy as np

__all__ = ["LatencyWindow", "OutcomeCounter", "RateMeter"]


class LatencyWindow:
    """Rolling submit->result latency sample with percentile summaries."""

    def __init__(self, cap: int = 1024):
        if cap < 1:
            raise ValueError(f"latency window cap must be >= 1, got {cap}")
        self._samples: deque[float] = deque(maxlen=cap)
        self._count = 0  # lifetime completions (window-independent)

    def record(self, seconds: float) -> None:
        self._samples.append(float(seconds))
        self._count += 1

    def summary(self) -> dict:
        """``{"count", "p50_ms", "p99_ms", "max_ms"}`` over the window
        (zeros when nothing completed yet -- a metrics poll on a fresh
        gateway must not throw)."""
        if not self._samples:
            return {"count": self._count, "p50_ms": 0.0, "p99_ms": 0.0,
                    "max_ms": 0.0}
        arr = np.asarray(self._samples, np.float64) * 1e3
        return {
            "count": self._count,
            "p50_ms": float(np.percentile(arr, 50)),
            "p99_ms": float(np.percentile(arr, 99)),
            "max_ms": float(arr.max()),
        }


class OutcomeCounter:
    """Tally of terminal ticket outcomes over a fixed vocabulary.

    ``completed`` counts every ticket that reached a terminal state
    through the solver (``ok`` + ``diverged``); ``shed`` tickets never
    ran, so they are tallied but excluded from ``completed``.
    """

    KINDS = ("ok", "diverged", "shed")

    def __init__(self):
        self._counts = {k: 0 for k in self.KINDS}

    def add(self, kind: str) -> None:
        if kind not in self._counts:
            raise ValueError(
                f"unknown outcome {kind!r}; expected one of {self.KINDS}")
        self._counts[kind] += 1

    def __getitem__(self, kind: str) -> int:
        return self._counts[kind]

    @property
    def completed(self) -> int:
        return self._counts["ok"] + self._counts["diverged"]

    def summary(self) -> dict:
        """``{"completed", "diverged", "shed"}`` -- the gateway splices
        this straight into its ``metrics()`` surface."""
        return {
            "completed": self.completed,
            "diverged": self._counts["diverged"],
            "shed": self._counts["shed"],
        }


class RateMeter:
    """Events/sec over a sliding window of timestamped increments."""

    def __init__(self, window_s: float = 30.0,
                 clock: Callable[[], float] = time.perf_counter):
        if window_s <= 0:
            raise ValueError(f"rate window must be > 0s, got {window_s}")
        self.window_s = float(window_s)
        self._clock = clock
        self._events: deque[tuple[float, float]] = deque()
        self._total = 0.0

    def add(self, count: float) -> None:
        now = self._clock()
        self._events.append((now, float(count)))
        self._total += float(count)
        self._trim(now)

    def _trim(self, now: float) -> None:
        horizon = now - self.window_s
        while self._events and self._events[0][0] < horizon:
            self._events.popleft()

    def rate(self) -> float:
        """Events/sec over the (elapsed part of the) window."""
        now = self._clock()
        self._trim(now)
        if not self._events:
            return 0.0
        span = max(now - self._events[0][0], 1e-9)
        return sum(c for _, c in self._events) / span

    @property
    def total(self) -> float:
        """Lifetime event count (not windowed)."""
        return self._total
