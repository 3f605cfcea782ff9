"""Low-rank-residual soft threshold: CUDA kernel and its plain version.

``residual_shrink``  ``S = sign(R) * max(|R| - lam, 0)`` with
                     ``R = M - U V^T``, (E, m, n); masked ``W * S``.
                     Replaces ``repro/kernels/shrinkage.py::residual_shrink``
                     (:97, kernel ``_shrink_kernel`` :41) and
                     ``residual_shrink_masked`` (:167, kernel :57).
``residual_shrink_psi``  ``(S, Psi = R - S)``; masked ``(W * S, W * R - W * S)``,
                     the reference's formulas.  Replaces
                     ``residual_shrink_psi`` (:129, kernel :48) and
                     ``residual_shrink_psi_masked`` (:202, kernel :66).

``M`` is fp32 or bf16 (upcast on load); ``S`` is fp32.  ``w`` is absent, a
dense fp32 0/1 plane or a bit-packed uint8 one (``kernels.bitmask``), which
the kernel reads as it is: a packed plane gives the bits of the dense plane
it packs, and an all-ones plane the bits of no mask.  The kernels
(``csrc/shrink.cu``, Psi a template flag of the same tile; the route from
:func:`shrink_plan`) compute each 64 x 64 tile of S from cp.async-staged
rows of U and V (``csrc/tile64.cuh``) up to r = 256, and above each
128 x 64 tile with the rank axis streaming through a ring of 32-rank slabs;
M, W, S and Psi each cross device memory once: 2r FLOP per entry against
4-16 bytes, so fp32 arithmetic bounds it at r = 150 and above, and the
bytes about as much at r = 64.

On CPU tensors the wrapper returns the plain version; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    MASK_SUFFIX, RANK_CHUNK, STREAM_COLS, STREAM_ROWS, TILE, check_operands,
    launch, on_cpu, signature, sm_count,
)

#: Kernel launches per function (CUDA tensors only).
launches = {base + suffix: 0
            for base in ("residual_shrink", "residual_shrink_psi")
            for suffix in MASK_SUFFIX.values()}

_ENTRY = "repro_residual_shrink"
_PSI_ENTRY = "repro_residual_shrink_psi"
_SIGNATURES = {_ENTRY: signature(1, 1), _PSI_ENTRY: signature(2, 1)}

#: Route codes of the C entries (``ShrinkRoute`` in ``csrc/shrink.cu``).
ROUTES = {"base": 0, "stream": 1}
#: The stream kernel's ranks a staged slab and slabs in its ring
#: (``kSlab``, ``kStages``), threads a block and blocks resident on an SM
#: (its ``__launch_bounds__``; its shared memory lets no third block in).
SLAB, STAGES, STREAM_THREADS, STREAM_RESIDENT = 32, 2, 128, 2
#: Threads of a ``shrink_kernel`` block (``kT64Threads``).
BASE_THREADS = 256
#: Shared memory an H100 SM holds for its blocks, each of which reserves
#: 1 KB of it (``two_blocks_fit`` in ``csrc/tile64.cuh``).
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 233472, 1024


class ShrinkPlan(NamedTuple):
    """One shrink launch: the ``route`` (``"base"``: ``shrink_kernel``, one
    register block of the whole rank; ``"stream"``: ``shrink_stream_kernel``,
    the rank axis in a ring of ``stages`` slabs of ``slab`` ranks), its
    output tile (``rows`` x ``cols``), dynamic shared memory a block
    (``smem``), ``threads`` a block, blocks ``resident`` on an SM, the grid
    (column tiles, row tiles, E) and the ``waves`` of resident blocks it
    takes on a card of the plan's SM count."""

    route: str
    rows: int
    cols: int
    slab: int
    stages: int
    smem: int
    threads: int
    resident: int
    grid: tuple[int, int, int]
    waves: float


def shrink_plan(e: int, m: int, n: int, r: int, sms: int) -> ShrinkPlan:
    """The launch of ``residual_shrink`` and ``residual_shrink_psi`` at
    (E, m, n, r) on a card with ``sms`` SMs: ``shrink_kernel`` up to r =
    256, ``shrink_stream_kernel`` above.  A pure function of the shape and
    the SM count."""
    if r <= RANK_CHUNK:
        rows = cols = TILE
        slab = 32 * -(-r // 32)
        stages = 1
        smem = 4 * 2 * TILE * (slab + 4)
        threads = BASE_THREADS
        resident = (2 if 2 * (smem + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
                    else 1)
        route = "base"
    else:
        rows, cols = STREAM_ROWS, STREAM_COLS
        slab, stages = SLAB, STAGES
        # the ring of unpadded (swizzled) slabs, 1 KB to align it, and a
        # 64-bit mbarrier a stage (``kStreamSmem``)
        smem = 1024 + 4 * stages * (rows + cols) * slab + 8 * stages
        threads, resident, route = STREAM_THREADS, STREAM_RESIDENT, "stream"
    grid = (-(-n // cols), -(-m // rows), e)
    return ShrinkPlan(route, rows, cols, slab, stages, smem, threads,
                      resident, grid,
                      grid[0] * grid[1] * grid[2] / (resident * sms))


def stream_resident_on_device(device: torch.device, dtype: int = 0,
                              mask: int = 0, psi: bool = False) -> int:
    """The card's own count behind :data:`STREAM_RESIDENT`: blocks of
    ``shrink_stream_kernel`` (M type and mask mode by their codes, the psi
    flag) resident at once on one SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); raises where the
    query fails."""
    lib = _build.library("shrink", {
        "repro_shrink_stream_resident": (ctypes.c_int,) * 3})
    with torch.cuda.device(device):
        blocks = lib.repro_shrink_stream_resident(dtype, mask, int(psi))
    if blocks < 0:
        raise RuntimeError(f"occupancy query failed for the stream kernel "
                           f"(dtype {dtype}, mask {mask}, psi {psi})")
    return blocks


def _route(op, device) -> int:
    """The C entries' route code of :func:`shrink_plan` for ``op``."""
    return ROUTES[shrink_plan(op.e, op.m, op.n, op.r,
                              sm_count(device)).route]


def residual_shrink_plain(u, v, m, lam, w=None) -> torch.Tensor:
    if w is None:
        return ref.residual_shrink(u, v, m, lam)
    return ref.residual_shrink_masked(u, v, m, w, lam)


def residual_shrink(u, v, m, lam, w=None) -> torch.Tensor:
    """``S`` (E, m, n); ``W * S`` when ``w`` (dense or packed) is given."""
    if on_cpu(u):
        return residual_shrink_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w)
    s = torch.empty((op.e, op.m, op.n), dtype=torch.float32, device=u.device)
    lib = _build.library("shrink", _SIGNATURES)
    launch(lib, _ENTRY, "residual_shrink" + op.suffix, launches, op,
           u, v, m, w, lam, s, ints=(_route(op, u.device),))
    return s


def residual_shrink_psi_plain(u, v, m, lam, w=None):
    if w is None:
        return ref.residual_shrink_psi(u, v, m, lam)
    return ref.residual_shrink_psi_masked(u, v, m, w, lam)


def residual_shrink_psi(u, v, m, lam, w=None):
    """``(S, Psi)``, each (E, m, n); ``(W * S, W * R - W * S)`` when ``w``
    (dense or packed) is given."""
    if on_cpu(u):
        return residual_shrink_psi_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w)
    s, psi = (torch.empty((op.e, op.m, op.n), dtype=torch.float32,
                          device=u.device) for _ in range(2))
    lib = _build.library("shrink", _SIGNATURES)
    launch(lib, _PSI_ENTRY, "residual_shrink_psi" + op.suffix, launches, op,
           u, v, m, w, lam, s, psi, ints=(_route(op, u.device),))
    return s, psi
