"""Consensus wire accounting (counterpart of the wire model of
``repro.distributed.multihost`` :300-375): the modelled bytes a consensus
round moves per client, dense or top-k compressed, and the process-wide
traffic counters the ``"dcf"`` registry adapter feeds after every solve.

The reference's multi-process bootstrap and its worker launcher are not
ported here (ROADMAP.md)."""
from __future__ import annotations

import threading


def topk_k(d: int, frac: float) -> int:
    """Static kept-entry count for a ``d``-entry factor at ``frac``."""
    return max(1, min(d, int(round(frac * d))))


def consensus_wire_model(m: int, rank: int, num_clients: int,
                         compress=None) -> dict[str, float]:
    """Modelled consensus bytes one client moves per round.

    Dense: ship the local (m, r) f32 factor up and receive the consensus
    factor down, ``2 m r * 4`` bytes (the paper's ``2 E m r`` bound over
    ``E`` clients).  Compressed: the consensus runs as an all-gather of
    each client's top-k (value f32, index int32) payload, so a client
    sends ``k * 8`` and receives ``(E-1) * k * 8``, ``E k * 8`` in all.
    Index bytes are counted."""
    d = m * rank
    dense = 2 * d * 4
    frac = getattr(compress, "topk_frac", None) if compress is not None \
        else None
    if frac is None:
        shipped = dense
        k = d
    else:
        k = topk_k(d, float(frac))
        shipped = 8 * k * num_clients
    return {
        "dense_bytes": float(dense),
        "shipped_bytes": float(shipped),
        "ratio": dense / shipped,
        "k": float(k),
    }


_traffic_lock = threading.Lock()
_TRAFFIC = {
    "solves": 0,
    "rounds": 0,
    "shipped_bytes": 0.0,
    "dense_bytes": 0.0,
}


def record_consensus(m: int, rank: int, num_clients: int, rounds: int,
                     compress=None) -> None:
    """Fold one solve's modelled consensus traffic into the counters."""
    model = consensus_wire_model(m, rank, num_clients, compress)
    with _traffic_lock:
        _TRAFFIC["solves"] += 1
        _TRAFFIC["rounds"] += int(rounds)
        _TRAFFIC["shipped_bytes"] += model["shipped_bytes"] * rounds
        _TRAFFIC["dense_bytes"] += model["dense_bytes"] * rounds


def consensus_traffic(reset: bool = False) -> dict[str, float]:
    """Snapshot of the process-wide consensus traffic counters.

    ``bytes_per_round`` is the modelled per-client shipped bytes averaged
    over recorded rounds; ``achieved_ratio`` the realized dense/shipped
    compression (1.0 when every solve ran dense)."""
    with _traffic_lock:
        snap = dict(_TRAFFIC)
        if reset:
            for key in _TRAFFIC:
                _TRAFFIC[key] = type(_TRAFFIC[key])(0)
    rounds = max(snap["rounds"], 1)
    shipped = snap["shipped_bytes"]
    return {
        "solves": snap["solves"],
        "rounds": snap["rounds"],
        "shipped_bytes": shipped,
        "bytes_per_round": shipped / rounds,
        "achieved_ratio": (snap["dense_bytes"] / shipped) if shipped else 1.0,
    }
