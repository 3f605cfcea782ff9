"""Eager validation for the solver entry points and the serving error
types (a copy of ``repro.core.validate``; the messages are the same word for
word)."""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.distributed import faults as flt


class CapacityError(RuntimeError):
    """Transient admission failure: a bounded serving resource (slot
    table, page pool, submission queue) is full right now.  Not a
    ``ValueError``: "at capacity" is retryable once in-flight work drains,
    while a ``ValueError`` marks a request that can never be valid."""


class QueueFull(CapacityError):
    """Gateway backpressure: the submission queue (or its paged staging
    pool) is at its admission limit."""


class SolverDiverged(RuntimeError):
    """A solve produced non-finite iterates (NaN/inf factors or residual):
    the serving stack's quarantine outcome.  Neither a ``ValueError`` (the
    request was well-formed) nor a ``CapacityError`` (retrying the same
    payload diverges again)."""


def solver_diverged(what: str, rounds: int | None = None) -> SolverDiverged:
    """Uniform divergence signal for the serving stack."""
    at = f" after {rounds} rounds" if rounds is not None else ""
    return SolverDiverged(
        f"solver diverged on {what}{at}: iterates went non-finite; the "
        f"slot was quarantined and freed (the input data defeats this "
        f"solver configuration -- retrying unchanged will diverge again)"
    )


def service_at_capacity(slots: int) -> CapacityError:
    """Uniform at-capacity signal for the slot-table service."""
    return CapacityError(
        f"service at capacity: all {slots} slots are occupied; retry "
        f"after a tick/poll/release cycle frees one"
    )


def gateway_queue_full(depth: int, limit: int,
                       what: str = "submission queue") -> QueueFull:
    """Uniform backpressure signal for the async gateway's admission
    control (queue depth or staging-pool exhaustion)."""
    return QueueFull(
        f"gateway {what} is full ({depth}/{limit}); shed load or retry "
        f"after in-flight solves complete"
    )


def check_mask(mask: Any, data_shape: tuple[int, ...]) -> None:
    """Observation mask must match the data shape exactly and be float.

    Integer masks are rejected: the kernel layer reads uint8 planes as
    *bit-packed* masks (8 cols/byte), so a dense uint8 0/1 mask would be
    silently reinterpreted.
    """
    if mask is None:
        return
    dtype = getattr(mask, "dtype", None)
    if isinstance(dtype, torch.dtype) and not (
            dtype.is_floating_point or dtype == torch.bool):
        raise ValueError(
            f"mask dtype {_dtype_name(dtype)} is not float/bool; pass a "
            f"dense 0/1 float mask (bit-packed uint8 planes are internal -- "
            f"use DCFConfig.pack_mask to store masks packed)"
        )
    if tuple(mask.shape) != tuple(data_shape):
        raise ValueError(
            f"mask shape {tuple(mask.shape)} != data shape "
            f"{tuple(data_shape)}"
        )


def _dtype_name(dtype: torch.dtype) -> str:
    """``torch.uint8`` -> ``uint8``, the spelling of the reference's text."""
    return str(dtype).removeprefix("torch.")


def check_warm_pair(warm: Any) -> tuple[Any, Any]:
    """``warm=`` must be a pair of arrays; returns it unpacked."""
    try:
        a, b = warm
    except (TypeError, ValueError):
        raise ValueError(
            "warm must be a pair of arrays (L, S) for the convex solvers "
            "or (U, V) for the factorized ones"
        ) from None
    return a, b


def check_factor(
    arr: Any, expected: tuple[int, ...], name: str, desc: str,
    suffix: str = "",
) -> None:
    """One warm factor: ``warm {name} has shape ..., expected {desc} = ...``."""
    if tuple(arr.shape) != tuple(expected):
        raise ValueError(
            f"warm {name} has shape {tuple(arr.shape)}, expected {desc} = "
            f"{tuple(expected)}{suffix}"
        )


def check_warm_shapes(
    warm: Any,
    names: Sequence[str],
    shapes: Sequence[tuple[int, ...]],
    descs: Sequence[str],
    suffixes: Sequence[str] | None = None,
) -> tuple[Any, Any]:
    """Validate a warm pair against per-factor expected shapes."""
    a, b = check_warm_pair(warm)
    suffixes = suffixes or ("", "")
    check_factor(a, shapes[0], names[0], descs[0], suffixes[0])
    check_factor(b, shapes[1], names[1], descs[1], suffixes[1])
    return a, b


def check_warm_lowrank_sparse(
    warm: Any, data_shape: tuple[int, ...]
) -> tuple[Any, Any]:
    """Convex-solver warm start: ``(L, S)`` iterates, both data-shaped."""
    return check_warm_shapes(
        warm, ("L", "S"), (data_shape, data_shape), ("(m, n)", "(m, n)")
    )


def check_compile_policy(
    bucket_min: int, bucket_ratio: float, max_entries: int,
    max_bytes: int | None,
) -> None:
    """Admission vocabulary for the compile cache's bucket policy."""
    if bucket_min < 1:
        raise ValueError(
            f"compile policy bucket_min must be >= 1, got {bucket_min}"
        )
    if not bucket_ratio > 1.0:
        raise ValueError(
            f"compile policy bucket_ratio must be > 1 (geometric bucket "
            f"growth), got {bucket_ratio}"
        )
    if max_entries < 1:
        raise ValueError(
            f"compile policy max_entries must be >= 1, got {max_entries}"
        )
    if max_bytes is not None and max_bytes < 1:
        raise ValueError(
            f"compile policy max_bytes must be >= 1 or None, got "
            f"{max_bytes}"
        )


def unknown_compile_policy(policy: Any) -> ValueError:
    """Uniform error for an unrecognized ``compile_policy=`` argument."""
    return ValueError(
        f"compile_policy must be None, 'off', 'aot', or a CompilePolicy; "
        f"got {policy!r}"
    )


def check_consensus_cfg(cfg: Any, participation: Any = None) -> None:
    """Consensus wire knobs, checked eagerly at every DCF entry point:
    ``consensus_compress`` needs a ``topk_frac`` in (0, 1];
    ``consensus_delay`` is 0 or 1 and composes with no participation
    schedule; the aggregator and its trim fraction, and the divergence
    screen, take their valid values only."""
    cc = getattr(cfg, "consensus_compress", None)
    if cc is not None:
        frac = getattr(cc, "topk_frac", None)
        if frac is None:
            raise ValueError(
                "cfg.consensus_compress needs CompressConfig.topk_frac set "
                "(the kept fraction of the U delta per consensus round)"
            )
        if not 0.0 < float(frac) <= 1.0:
            raise ValueError(
                f"consensus_compress.topk_frac must be in (0, 1], got "
                f"{frac}"
            )
    delay = getattr(cfg, "consensus_delay", 0)
    if delay not in (0, 1):
        raise ValueError(
            f"consensus_delay must be 0 (synchronous) or 1 (one-round "
            f"stale overlap), got {delay}"
        )
    if delay and participation is not None:
        raise ValueError(
            "consensus_delay=1 does not compose with participation "
            "schedules: a stale delta from a since-dropped client has no "
            "well-defined consensus weight"
        )
    if delay and not getattr(cfg, "stale_guard", 4.0) > 1.0:
        raise ValueError(
            f"stale_guard must be > 1 (a divergence trip threshold on the "
            f"round's guard scalar), got {cfg.stale_guard}"
        )
    agg = getattr(cfg, "aggregator", "weighted_mean")
    if agg not in ("weighted_mean", "trimmed_mean", "coordinate_median"):
        raise ValueError(
            f"cfg.aggregator must be 'weighted_mean', 'trimmed_mean' or "
            f"'coordinate_median', got {agg!r}"
        )
    if agg == "trimmed_mean":
        tf = getattr(cfg, "trim_frac", 0.25)
        if not 0.0 <= float(tf) < 0.5:
            raise ValueError(
                f"trim_frac must be in [0, 0.5) (trimming half or more "
                f"per side leaves no client to average), got {tf}"
            )
    screen = getattr(cfg, "divergence_screen", None)
    if screen is not None and not float(screen) > 1.0:
        raise ValueError(
            f"divergence_screen must be > 1 (a multiple of the median "
            f"client delta norm), got {screen}"
        )
    if screen is not None and cc is not None and agg == "weighted_mean":
        raise ValueError(
            "divergence_screen with consensus_compress requires a robust "
            "(one-vote) aggregator: quarantining a client after the fact "
            "leaves its weighted error-feedback carry inconsistent -- set "
            "aggregator='trimmed_mean'/'coordinate_median' or drop the "
            "compression"
        )


def check_fault_plan(cfg: Any, faults: Any, num_clients: int) -> None:
    """A fault-injection schedule against the consensus wire: the code
    table must be ``(T_f, E)`` for this topology, and ``consensus_delay=1``
    does not compose with drop-style faults (crash, flaky)."""
    if faults is None:
        return
    codes = getattr(faults, "codes", faults)
    shape = tuple(getattr(codes, "shape", ()))
    if len(shape) != 2 or shape[1] != num_clients:
        raise ValueError(
            f"fault plan codes have shape {shape}, expected "
            f"(rounds, num_clients={num_clients})"
        )
    if getattr(cfg, "consensus_delay", 0):
        arr = np.asarray(codes.cpu() if isinstance(codes, torch.Tensor)
                         else codes)
        if bool(((arr == flt.CRASH) | (arr == flt.FLAKY)).any()):
            raise ValueError(
                "consensus_delay=1 does not compose with crash/flaky "
                "fault injection: a stale delta from a since-crashed "
                "client has no well-defined consensus weight"
            )


def check_service_problem(m_obs: Any, m: int, n: int) -> int:
    """Service admission: the row count must match and the width fit a
    slot.  Returns the request's true column count ``n_req``."""
    if m_obs.ndim != 2 or m_obs.shape[0] != m:
        raise ValueError(
            f"problem shape {tuple(m_obs.shape)} incompatible with service "
            f"rows m={m}"
        )
    n_req = m_obs.shape[1]
    if n_req == 0 or n_req > n:
        raise ValueError(
            f"problem has {n_req} columns, service slots hold 1..{n}"
        )
    return n_req
