"""Eager shape validation for the solver entry points (a copy of the parts
of ``repro.core.validate`` that this package uses; the messages are the
same word for word)."""
from __future__ import annotations

from typing import Any, Sequence

import torch


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
