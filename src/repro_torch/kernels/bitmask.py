"""Bit-packed observation masks: 8 columns per byte.

``packed[..., i, jb]`` holds columns ``8*jb .. 8*jb+7`` of row ``i``, least
significant bit first; the tail byte's high bits are zero when
``n % 8 != 0``.  Byte-identical with ``repro.kernels.bitmask``.  The CUDA
contraction kernels read packed planes as they are (``csrc/tile.cuh``);
these helpers pack them (``DCFConfig.pack_mask``) and unpack them for the
plain versions and the shrink.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device

#: Columns packed per byte.
PACK = 8


def packed_width(n: int) -> int:
    """Bytes per row for an ``n``-column mask."""
    return -(-n // PACK)


def is_packed(w: torch.Tensor) -> bool:
    """True when ``w`` is a bit-packed mask (uint8 plane)."""
    return w.dtype == torch.uint8


def pack_mask(w: torch.Tensor) -> torch.Tensor:
    """Pack a 0/1 mask ``(..., m, n)`` into ``(..., m, ceil(n/8))`` uint8."""
    n = w.shape[-1]
    bits = (w != 0).to(torch.uint8)
    pad = (-n) % PACK
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*w.shape[:-1], -1, PACK)
    shifts = torch.arange(PACK, dtype=torch.uint8, device=w.device)
    return (bits << shifts).sum(dim=-1, dtype=torch.uint8)


def unpack_mask(packed: torch.Tensor, n: int,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`pack_mask`: ``(..., m, ceil(n/8))`` -> ``(..., m, n)``."""
    shifts = torch.arange(PACK, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    full = bits.reshape(*packed.shape[:-1], packed.shape[-1] * PACK)
    return full[..., :n].to(dtype)


def packed_ones(dense_shape: tuple[int, ...],
                device: torch.device | str | None = None) -> torch.Tensor:
    """Packed plane equal to ``pack_mask(torch.ones(dense_shape))``, built
    without the dense plane, on the card unless ``device`` says otherwise."""
    n = dense_shape[-1]
    out = torch.full((*dense_shape[:-1], packed_width(n)), 0xFF,
                     dtype=torch.uint8, device=resolve_device(device))
    rem = n % PACK
    if rem:
        out[..., -1] = (1 << rem) - 1
    return out


def resolve_mask(w: torch.Tensor | None, n: int,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor | None:
    """Dense view of a maybe-packed mask (``None`` passes through)."""
    if w is None or not is_packed(w):
        return w
    return unpack_mask(w, n, dtype)
