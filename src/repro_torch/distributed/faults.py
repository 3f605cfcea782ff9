"""Deterministic fault injection at the consensus boundary (counterpart of
``repro.distributed.faults``).

A :class:`FaultPlan` is a seed-keyed ``(T, E)`` table of per-round,
per-client fault codes, drawn once on the host with numpy's RNG (so a seed
gives the reference's table bit for bit, on every machine) and injected at
the consensus boundary of the simulated DCF engine.  The same seed gives
the same faults and the same bits: a chaos scenario is an ordinary test.

=========  ==============================================================
``OK``     no fault.
``CRASH``  the client dies mid-round: no payload reaches the consensus
           and its ``V_i`` freezes (a participation dropout, scheduled).
``NAN``    Byzantine payload: the client ships a NaN-filled factor.
``CORRUPT``  Byzantine payload: the factor arrives scaled by
           ``CORRUPT_SCALE`` (gross but finite).
``STALE``  straggler: the client re-ships the previous consensus ``U``
           (a zero delta) while its ``V_i`` keeps advancing.
``FLAKY``  the local round ran (``V_i`` advances) but the message is lost:
           dropped from the consensus like a crash.
=========  ==============================================================
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np
import torch

Tensor = torch.Tensor

OK = 0
CRASH = 1
NAN = 2
CORRUPT = 3
STALE = 4
FLAKY = 5

#: Every fault code.
ALL_CODES = (OK, CRASH, NAN, CORRUPT, STALE, FLAKY)

#: Scale of a ``CORRUPT`` payload: enough that one corrupt client wrecks a
#: plain mean, finite so that the trimmed mean meets it apart from NaN.
CORRUPT_SCALE = 64.0

_NAMES = {OK: "ok", CRASH: "crash", NAN: "nan", CORRUPT: "corrupt",
          STALE: "stale", FLAKY: "flaky"}
_BY_NAME = {v: k for k, v in _NAMES.items()}


@dataclass(frozen=True, eq=False)
class FaultPlan:
    """A deterministic per-round, per-client fault schedule: ``codes`` is
    the host's ``(rounds, num_clients)`` int32 table, and round ``t`` of a
    solve uses row ``t % rounds`` (a warm resume wraps, as a participation
    schedule does).  Build one with the class methods."""

    codes: np.ndarray
    seed: int = 0
    meta: str = field(default="", compare=False)

    def __post_init__(self):
        arr = np.asarray(self.codes, np.int32)
        if arr.ndim != 2:
            raise ValueError(
                f"fault plan codes must be (rounds, num_clients), got "
                f"shape {arr.shape}"
            )
        bad = set(np.unique(arr)) - set(ALL_CODES)
        if bad:
            raise ValueError(f"unknown fault codes in plan: {sorted(bad)}")
        object.__setattr__(self, "codes", arr)

    @classmethod
    def none(cls, rounds: int, num_clients: int) -> "FaultPlan":
        """The explicit no-fault plan (a control arm)."""
        return cls(np.zeros((rounds, num_clients), np.int32), meta="none")

    @classmethod
    def byzantine(cls, rounds: int, num_clients: int,
                  clients: Sequence[int], kind: str = "nan",
                  start: int = 0) -> "FaultPlan":
        """``clients`` faulted with ``kind`` (``"nan"``, ``"corrupt"``,
        ``"stale"``, ``"crash"`` or ``"flaky"``) in every round from
        ``start`` on."""
        code = _BY_NAME.get(kind)
        if code is None or code == OK:
            raise ValueError(
                f"kind must be one of {sorted(_BY_NAME)} (not 'ok'), "
                f"got {kind!r}"
            )
        table = np.zeros((rounds, num_clients), np.int32)
        for i in clients:
            if not 0 <= int(i) < num_clients:
                raise ValueError(
                    f"client index {i} out of range for "
                    f"num_clients={num_clients}"
                )
            table[start:, int(i)] = code
        return cls(table, meta=f"byzantine:{kind}x{len(list(clients))}")

    @classmethod
    def random(cls, seed: int, rounds: int, num_clients: int,
               rates: Mapping[str, float]) -> "FaultPlan":
        """Seed-keyed i.i.d. faults: each (round, client) cell draws one
        fault from ``rates`` (name -> probability, the rest OK), the
        reference's draw from the same seed.  At most ``num_clients - 1``
        clients are faulted in a round."""
        kinds = sorted(rates)
        p = [float(rates[k]) for k in kinds]
        if any(not 0.0 <= x <= 1.0 for x in p) or sum(p) > 1.0:
            raise ValueError(
                f"fault rates must be probabilities summing to <= 1, "
                f"got {rates!r}"
            )
        rng = np.random.default_rng(seed)
        draw = rng.choice(len(kinds) + 1, size=(rounds, num_clients),
                          p=p + [1.0 - sum(p)])
        table = np.zeros((rounds, num_clients), np.int32)
        for j, k in enumerate(kinds):
            table[draw == j] = _BY_NAME[k]
        for t in range(rounds):  # keep one live vote a round
            if np.flatnonzero(table[t]).size >= num_clients:
                table[t, rng.integers(num_clients)] = OK
        return cls(table, seed=seed, meta=f"random:{dict(rates)}")

    @property
    def rounds(self) -> int:
        return self.codes.shape[0]

    @property
    def num_clients(self) -> int:
        return self.codes.shape[1]

    def table(self, device: torch.device | str = "cpu") -> Tensor:
        """The int32 code table on ``device``: what the problem carries."""
        return torch.as_tensor(self.codes, dtype=torch.int32).to(device)

    def describe(self) -> str:
        counts = {name: int((self.codes == code).sum())
                  for code, name in _NAMES.items() if code != OK}
        busy = {k: v for k, v in counts.items() if v}
        return (f"FaultPlan(seed={self.seed}, rounds={self.rounds}, "
                f"clients={self.num_clients}, faults={busy or 'none'})")


def resolve_faults(faults, device: torch.device | str = "cpu"
                   ) -> Tensor | None:
    """A ``faults=`` argument (plan, table or ``None``) as the int32 code
    table on ``device``."""
    if faults is None:
        return None
    if isinstance(faults, FaultPlan):
        return faults.table(device)
    return torch.as_tensor(np.asarray(faults), dtype=torch.int32).to(device)


def round_codes(table: Tensor, t: Tensor) -> Tensor:
    """The (E,) row of round ``t`` (a 0-d device tensor) of a per-round
    table, fault codes or a participation schedule (the table wraps),
    picked on the device without a host sync.  A batch's (B, T, E) table
    with ``t`` (B,) gives each problem its own row, (B, E)."""
    if table.ndim == 3:
        idx = torch.remainder(t, table.shape[1]).to(torch.int64)
        idx = idx[:, None, None].expand(-1, 1, table.shape[2])
        return table.gather(1, idx).squeeze(1)
    idx = torch.remainder(t, table.shape[0]).to(torch.int64).reshape(1)
    return table.index_select(0, idx).squeeze(0)


def corrupt_payload(code: Tensor, u_i: Tensor, u_prev: Tensor) -> Tensor:
    """The payload faults applied to what each client ships: NaN, scaled
    by :data:`CORRUPT_SCALE`, or the previous consensus.  ``code`` is the
    (E,) row against the stacked (E, m, r) factors; ``CRASH`` and
    ``FLAKY`` leave the payload as it is (their vote is dropped:
    :func:`live_mask`)."""
    c = code.reshape(code.shape + (1,) * (u_i.ndim - code.ndim))
    u = torch.where(c == NAN, torch.full((), float("nan"), device=u_i.device),
                    u_i)
    u = torch.where(c == CORRUPT, CORRUPT_SCALE * u_i, u)
    return torch.where(c == STALE, u_prev.expand_as(u_i), u)


def live_mask(code: Tensor) -> Tensor:
    """1.0 where the client's payload reaches this round's consensus."""
    return ((code != CRASH) & (code != FLAKY)).to(torch.float32)


def v_advance_mask(code: Tensor) -> Tensor:
    """1.0 where the client's ``V_i`` advances this round (every fault but
    a crash ran the local round)."""
    return (code != CRASH).to(torch.float32)
