"""Runtime sanitizer mode, the counterpart of ``repro.debug``.

The reference turns on three JAX tripwires (``repro/debug.py:68-70``).
The port maps them so:

* **the transfer guard** becomes ``torch.cuda.set_sync_debug_mode``:
  ``"warn"`` in log mode, ``"error"`` in strict mode (restored by
  :func:`disable`).  PyTorch's mode flags every operation that makes the
  host wait for the card, explicit ones included (``.item()``,
  ``.tolist()``, ``.cpu()``, ``bool(t)``), where the reference's guard
  lets an explicit ``device_get`` through.  So the solve paths that read a
  predicate on purpose, the ``while`` and ``chunk`` modes of
  ``core.runtime`` (one read a round or a chunk), a problem's set-up and a
  result's read-back trip strict mode.  Hold strict to the ``scan`` rounds
  of ``core.runtime.run``, which read nothing back while they run.
* **``jax_debug_nans``** becomes a NaN check of the carry on the eager
  path: ``core.runtime.Rounds`` raises ``FloatingPointError`` naming the
  round after each eager round whose carry holds a NaN.  A captured round
  cannot raise, so the captured path checks once after its replays.  The
  check is for NaN, as the reference's is: an inf in a carry's
  diagnostics means "not measured", not a fault.  The check reads the
  carry on the host, with the guard suspended around its own read.
* **``jax_check_tracer_leaks``** has no counterpart: PyTorch has no
  tracers to leak.

On a build of PyTorch without CUDA there is no device to guard (its
``set_sync_debug_mode`` raises), so the guard is left alone there and only
the NaN check runs.

Activation::

    RPCA_SANITIZE=1       # log: warn on every host sync, the NaN check
    RPCA_SANITIZE=strict  # strict: a host sync raises, the NaN check
    RPCA_SANITIZE=0       # (or unset) no-op

Unlike the reference's, the port's test suite never turns the sanitizer on
for a whole test run: a caller calls :func:`enable_from_env`, or
:func:`enable` and :func:`disable` around its work.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Iterator

import torch

_ACTIVE: dict | None = None


def _truthy(val: str) -> bool:
    return val.strip().lower() in ("1", "true", "on", "yes", "strict")


def sanitize_mode() -> str | None:
    """``"strict"``, ``"log"`` or ``None`` from ``RPCA_SANITIZE``."""
    raw = os.environ.get("RPCA_SANITIZE", "")
    if not _truthy(raw):
        return None
    return "strict" if raw.strip().lower() == "strict" else "log"


def enable(mode: str = "log") -> dict:
    """Turn the sanitizer on process-wide; returns the saved state
    (``mode`` and the previous sync debug mode, ``None`` where nothing is
    guarded) that :func:`disable` restores.  Idempotent."""
    global _ACTIVE
    if _ACTIVE is not None:
        return _ACTIVE
    if mode not in ("log", "strict"):
        raise ValueError(f"mode must be 'log' or 'strict', got {mode!r}")
    prev = {"mode": mode, "sync_debug_mode": None}
    if torch.cuda.is_available():  # else no device to guard
        prev["sync_debug_mode"] = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error" if mode == "strict"
                                       else "warn")
    _ACTIVE = prev
    return prev


def disable() -> None:
    """Restore the state before :func:`enable` (no-op when inactive)."""
    global _ACTIVE
    if _ACTIVE is None:
        return
    if _ACTIVE["sync_debug_mode"] is not None:
        torch.cuda.set_sync_debug_mode(_ACTIVE["sync_debug_mode"])
    _ACTIVE = None


def active() -> bool:
    return _ACTIVE is not None


def enable_from_env() -> bool:
    """Enable iff ``RPCA_SANITIZE`` asks for it; True when activated."""
    mode = sanitize_mode()
    if mode is None:
        return False
    enable(mode)
    return True


@contextlib.contextmanager
def _unguarded() -> Iterator[None]:
    """The sync guard off for the sanitizer's own read."""
    if _ACTIVE is None or _ACTIVE["sync_debug_mode"] is None:
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def _float_leaves(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree] if tree.is_floating_point() else []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _float_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in _float_leaves(item)]
    return []


def check_nan(tree: Any, where: str) -> None:
    """While the sanitizer is active, raise ``FloatingPointError`` naming
    ``where`` if a floating leaf of ``tree`` (tensors in named tuples,
    tuples, lists and dicts) holds a NaN; nothing otherwise."""
    if _ACTIVE is None:
        return
    leaves = _float_leaves(tree)
    if not leaves:
        return
    with _unguarded():
        bad = bool(torch.stack([x.isnan().any() for x in leaves]).any())
    if bad:
        raise FloatingPointError(f"sanitizer: NaN in the carry {where}")
