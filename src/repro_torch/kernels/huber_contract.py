"""Huber-residual contractions: CUDA kernels and their plain versions.

Four functions, each batched over a leading client axis E (U is (E, m, r):
after the first U-step every client holds its own copy), with
``R = M - U V^T``:

``huber_contract_v``       ``Psi^T U`` -> (E, n, r), ``Psi = W * clip(R,
                           +-lam)``.  Replaces ``repro/kernels/
                           huber_contract.py::huber_contract_v`` (:159,
                           kernel :82), ``huber_contract_v_masked`` (:239,
                           kernel :97) and ``huber_contract_v_packed`` (:553).
``huber_contract_u``       ``Psi V`` -> (E, m, r).  Replaces
                           ``huber_contract_u`` (:200, kernel :118),
                           ``huber_contract_u_masked`` (:286, kernel :133)
                           and ``huber_contract_u_packed`` (:572).
``huber_contract_u_diag``  ``(Psi V, H_lam(R_W), ||Psi||_F^2)`` ->
                           (E, m, r), (E,), (E,), with ``R_W = W * R`` and
                           ``Psi = clip(R_W, +-lam)``.  Replaces
                           ``huber_contract_u_diag`` (:521) and
                           ``huber_contract_u_diag_masked`` (:537).
``huber_dual_contract``    ``(Psi^T U, Psi V, H_lam(R_W), ||Psi||_F^2)`` from
                           one pass over M.  Replaces ``huber_dual_contract``
                           (:481) and ``huber_dual_contract_masked`` (:502).

(:341, ``_make_dual_kernel``, is the body of every TPU wrapper from :481
on.)  ``M`` is fp32 or bf16 (upcast on load; factors, sums and outputs stay
fp32).  ``w`` is absent, a dense 0/1 fp32 plane, or a bit-packed uint8 plane
(``kernels.bitmask``) that the kernel reads as it is: a packed plane gives
the bits of the dense plane it packs, and an all-ones plane the bits of no
mask.  ``launches`` counts each function per mask mode (``_masked`` dense,
``_packed`` packed).

The kernels (``csrc/contract_v.cu``; ``csrc/stripe.cuh`` through
``contract_u.cu``, ``contract_u_diag.cu`` and ``dual.cu``) are bound by fp32
arithmetic on an H100, not by device memory: each residual entry costs 4r
FLOP (6r in the dual) against at most 8 bytes.  They read M once, keep each
residual tile in shared memory, and spend the rest on register-blocked FMA
loops.  ``lam`` is a device tensor of shape (E,), so the solver loop never
reads a value back to the host.  The launches are deterministic (no
atomics): sums across blocks go through partials added in index order,
and the splits of a reduction across blocks (``v_splits``, ``u_splits``)
are pure functions of the shape and the SM count.
Ranks above 256: ``huber_contract_v`` and the row-stripe kernels split the
rank axis over a thread-block cluster of up to 8 blocks a column tile or a
row stripe (:func:`v_plan`, :func:`u_plan`, their rank slices
:func:`v_slices`, :func:`u_slices`), which forms each tile's U V^T once
and adds the blocks' partials in slice order, up to r = 2048; above,
chunks of 256 staged in turn (``_launch.v_chunked``, ``_launch.u_chunked``),
each block forming the tile's whole Psi.
``huber_contract_u`` is ``huber_contract_u_diag`` with the diagnostics
compiled out (the same ``Psi V`` bits), and ``huber_dual_contract`` always
runs its one fused pass where its out_v scratch fits 4 MiB
(:func:`dual_plan`: row groups of up to 8 stripes that sum their shares in
thread-block clusters, one partial plane a group), and the reference's two
passes past it: the scratch never grows with m.

A wrapper given CPU tensors returns its plain version (``*_plain``, the
``kernels.ref`` oracles); given CUDA tensors it launches its kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    MASK_SUFFIX, RANK_CHUNK, SLICE_MAX, check_operands, launch, on_cpu,
    rank_chunks, signature, sm_count, u_chunked, v_chunked,
)

#: Kernel launches per function and mask mode (CUDA tensors only).
launches = {
    base + suffix: 0
    for base in ("huber_contract_v", "huber_contract_u",
                 "huber_contract_u_diag", "huber_dual_contract")
    for suffix in MASK_SUFFIX.values()
}

# source stem -> (C entry, extra pointers, extra ints): the pointers after
# u, v, m, w, lam are the outputs and scratch; the ints are (splits, rows
# per split, cluster, slice) for contract_v (:class:`VPlan`), and (splits,
# columns per split) for the others, then the dual's row groups (cluster,
# groups), then their rank slices (cluster, slice: :class:`UPlan`).
_ENTRIES = {
    "contract_v": ("repro_huber_contract_v", 2, 4),
    "contract_u": ("repro_huber_contract_u", 2, 4),
    "contract_u_diag": ("repro_huber_contract_u_diag", 5, 4),
    "dual": ("repro_huber_dual_contract", 7, 6),
}


def _call(stem: str, base: str, op, u, v, m, w, lam, *outputs,
          ints: tuple = ()) -> None:
    entry, pointers, extra = _ENTRIES[stem]
    lib = _build.library(stem, {entry: signature(pointers, extra)})
    launch(lib, entry, base + op.suffix, launches, op, u, v, m, w, lam,
           *outputs, ints=ints)


#: Rows and columns of one ``huber_contract_v`` residual tile (``kVRows``
#: and ``kVCols`` in ``csrc/contract_v.cu``).
V_TILE_ROWS = V_TILE_COLS = 64
#: Rows of one stripe and columns of one residual tile of the row-stripe
#: kernels ``huber_contract_u``, ``huber_contract_u_diag`` and
#: ``huber_dual_contract`` (``kT64`` in ``csrc/stripe.cuh``).
U_TILE_ROWS = U_TILE_COLS = 64


def _splits(units: int, tiles: int, slots: int) -> tuple[int, int]:
    """``(splits, tiles_per_split)`` of a reduction over ``tiles`` tiles
    for a grid of ``units`` x splits units of work (blocks, or clusters),
    ``slots`` of them resident on the card at once.  A split count is
    costed as ``ceil(units * splits / slots)`` waves, each as long as a
    unit's tiles plus one (staging, writing the partials); the cheapest
    wins, and among equals the fewest splits (the least partial
    traffic)."""
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        cost = -(-units * splits // slots) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


#: Clusters of a cluster kernel (``contract_v_cluster_kernel``,
#: ``stripe_cluster_kernel``: one block an SM each) resident at once on a
#: 132-SM H100, by cluster size: their ``cudaOccupancyMaxActiveClusters``
#: (:func:`v_cluster_slots_on_device`, :func:`u_cluster_slots_on_device`,
#: the same counts for both).  A cluster stays within one GPC, so clusters
#: of 3 leave 15 SMs idle.
CLUSTER_SLOTS_H100 = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}


def cluster_slots(cluster: int, sms: int) -> int:
    """Clusters of ``cluster`` blocks of a cluster kernel resident at once
    on a card with ``sms`` SMs: the H100's measured counts at 132 SMs,
    ``sms // cluster`` (their upper bound) elsewhere."""
    if sms == 132 and cluster in CLUSTER_SLOTS_H100:
        return CLUSTER_SLOTS_H100[cluster]
    return max(1, sms // cluster)


def v_cluster_slots_on_device(device: torch.device, cluster: int,
                              slice_: int = SLICE_MAX) -> int:
    """The card's own count behind :data:`CLUSTER_SLOTS_H100` for
    ``huber_contract_v`` (``cudaOccupancyMaxActiveClusters`` of its cluster
    kernel with rank
    slices of ``slice_``); raises where the query fails."""
    lib = _build.library("contract_v", {
        "repro_contract_v_cluster_slots": (ctypes.c_int, ctypes.c_int)})
    with torch.cuda.device(device):
        slots = lib.repro_contract_v_cluster_slots(cluster, slice_)
    if slots < 0:
        raise RuntimeError(f"cluster occupancy query failed for {cluster} "
                           f"blocks with rank slices of {slice_}")
    return slots


@functools.lru_cache(maxsize=1024)
def v_splits(e: int, m: int, n: int, sms: int, chunks: int = 1,
             cluster: int = 0) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the m reduction in
    ``huber_contract_v`` on a card with ``sms`` SMs: every range a whole
    number of 64-row tiles, none empty, together exactly the m rows.

    The grid is (column tiles x splits x clients) blocks, two resident on
    an SM (``csrc/contract_v.cu`` at r <= 160), costed by :func:`_splits`;
    with rank ``chunks`` (the chunk kernel, :func:`rank_chunks`) that many
    times the blocks, one resident on an SM; with a ``cluster`` (the
    cluster kernel, r 257-2048) one cluster of that many blocks a column
    tile, :func:`cluster_slots` clusters resident at once (a cluster's
    blocks take one SM each).  A pure function of the shape and the SM
    count, so a launch is the same on every run of one card."""
    tiles = -(-m // V_TILE_ROWS)
    col_tiles = -(-n // V_TILE_COLS)
    if cluster:
        splits, per = _splits(e * col_tiles, tiles,
                              cluster_slots(cluster, sms))
    else:
        splits, per = _splits(e * chunks * col_tiles, tiles,
                              (2 if chunks == 1 else 1) * sms)
    return splits, per * V_TILE_ROWS


def _rank_slices(r: int) -> tuple[int, int]:
    """``(cluster, slice)``: the fewest blocks whose slices of at most
    ``_launch.SLICE_MAX`` ranks cover r, and the slices as even as 4-rank
    groups allow (block c holds ranks [c slice, min((c + 1) slice, r)):
    252 + 248 at r = 500, 3 x 200 at r = 600)."""
    cluster = -(-r // SLICE_MAX)
    return cluster, 4 * -(-(-(-r // 4)) // cluster)


def v_slices(r: int) -> tuple[int, int]:
    """``(cluster, slice)`` of ``huber_contract_v``'s cluster kernel at
    rank ``r`` (257 .. ``_launch.V_CLUSTER_MAX_RANK``): :func:`_rank_slices`."""
    return _rank_slices(r)


def cluster_smem_bytes(slice_: int) -> int:
    """Dynamic shared memory of one block of a cluster kernel with a rank
    slice of ``slice_`` (``cluster_smem_bytes`` in ``csrc/tile64.cuh``):
    one factor's slice resident and two stages of the other's, each 64
    rows of 32 RQ + 4 floats (RQ = ceil(slice / 32)), then the 64 x 64
    partial and Psi (the stripe's Psi^T swizzled, not padded)."""
    rq = -(-slice_ // 32)
    return 4 * (3 * V_TILE_ROWS * (32 * rq + 4)
                + 2 * V_TILE_ROWS * V_TILE_COLS)


class VPlan(NamedTuple):
    """One ``huber_contract_v`` launch: ``cluster`` blocks a column tile
    with rank slices of ``slice`` (0, 0 off the cluster route), the
    ``splits`` row ranges of ``rows`` rows, and the grid (column tiles x
    blocks a tile, splits, E)."""

    cluster: int
    slice: int
    splits: int
    rows: int
    grid: tuple[int, int, int]


def v_plan(e: int, m: int, n: int, r: int, sms: int) -> VPlan:
    """The launch of ``huber_contract_v`` at (E, m, n, r) on a card with
    ``sms`` SMs: one register block up to r = 256, the cluster kernel
    (:func:`v_slices`) up to ``_launch.V_CLUSTER_MAX_RANK``, the chunk
    kernel above.  A pure function of the shape and the SM count."""
    col_tiles = -(-n // V_TILE_COLS)
    if r <= RANK_CHUNK or v_chunked(r):
        chunks = rank_chunks(r)
        splits, rows = v_splits(e, m, n, sms, chunks)
        return VPlan(0, 0, splits, rows, (col_tiles * chunks, splits, e))
    cluster, slice_ = v_slices(r)
    splits, rows = v_splits(e, m, n, sms, cluster=cluster)
    return VPlan(cluster, slice_, splits, rows,
                 (col_tiles * cluster, splits, e))


def u_cluster_slots_on_device(device: torch.device, cluster: int,
                              slice_: int = SLICE_MAX) -> int:
    """The card's own count behind :data:`CLUSTER_SLOTS_H100` for the
    row-stripe kernels (``cudaOccupancyMaxActiveClusters`` of
    ``stripe_cluster_kernel`` with rank slices of ``slice_``); raises where
    the query fails."""
    lib = _build.library("contract_u_diag", {
        "repro_stripe_cluster_slots": (ctypes.c_int, ctypes.c_int)})
    with torch.cuda.device(device):
        slots = lib.repro_stripe_cluster_slots(cluster, slice_)
    if slots < 0:
        raise RuntimeError(f"cluster occupancy query failed for {cluster} "
                           f"stripe blocks with rank slices of {slice_}")
    return slots


@functools.lru_cache(maxsize=1024)
def u_splits(e: int, m: int, n: int, sms: int, chunks: int = 1,
             cluster: int = 0) -> tuple[int, int]:
    """``(splits, cols_per_split)`` of the n reduction in the row-stripe
    kernels (``huber_contract_u``, ``huber_contract_u_diag``,
    ``huber_dual_contract``) on a card with ``sms`` SMs: every range a
    whole number of 64-column tiles, none empty, together exactly the n
    columns.

    The grid is (64-row stripes x splits x clients) blocks, costed by
    :func:`_splits`; at E = 1 the splits fill the card (one client's
    3000 rows are 47 stripes).  A pure function of the shape and the SM
    count, and the three kernels take the same splits, so they share every
    sum of ``Psi V`` and of the diagnostics bit for bit.  With rank
    ``chunks`` (the chunk kernel, r > 2048) the grid holds that many times
    the blocks, one resident on an SM; with a ``cluster`` (the cluster
    kernel, r 257-2048) one cluster of that many blocks a stripe,
    :func:`cluster_slots` clusters resident at once."""
    stripes = -(-m // U_TILE_ROWS)
    col_tiles = -(-n // U_TILE_COLS)
    if cluster:
        splits, per = _splits(e * stripes, col_tiles,
                              cluster_slots(cluster, sms))
    else:
        splits, per = _splits(e * chunks * stripes, col_tiles,
                              (2 if chunks == 1 else 1) * sms)
    return splits, per * U_TILE_COLS


def u_slices(r: int) -> tuple[int, int]:
    """``(cluster, slice)`` of the row-stripe cluster kernel at rank ``r``
    (257 .. ``_launch.U_CLUSTER_MAX_RANK``): :func:`_rank_slices`, as
    ``huber_contract_v``'s."""
    return _rank_slices(r)


class UPlan(NamedTuple):
    """One row-stripe launch: ``cluster`` blocks a stripe with rank slices
    of ``slice`` (0, 0 off the cluster route), the ``splits`` column ranges
    of ``cols`` columns, and the grid (stripes x blocks a stripe, splits,
    E)."""

    cluster: int
    slice: int
    splits: int
    cols: int
    grid: tuple[int, int, int]


def u_plan(e: int, m: int, n: int, r: int, sms: int) -> UPlan:
    """The launch of the row-stripe kernels (``huber_contract_u``,
    ``huber_contract_u_diag``, ``huber_dual_contract``) at (E, m, n, r) on
    a card with ``sms`` SMs: one register block up to r = 256, the cluster
    kernel (:func:`u_slices`) up to ``_launch.U_CLUSTER_MAX_RANK``, the
    chunk kernel above.  A pure function of the shape and the SM count."""
    stripes = -(-m // U_TILE_ROWS)
    if r <= RANK_CHUNK or u_chunked(r):
        chunks = rank_chunks(r)
        splits, cols = u_splits(e, m, n, sms, chunks)
        return UPlan(0, 0, splits, cols, (stripes * chunks, splits, e))
    cluster, slice_ = u_slices(r)
    splits, cols = u_splits(e, m, n, sms, cluster=cluster)
    return UPlan(cluster, slice_, splits, cols,
                 (stripes * cluster, splits, e))


def _f32(*shape, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device)


def huber_contract_v_plain(u, v, m, lam, w=None) -> torch.Tensor:
    if w is None:
        return ref.huber_contract_v(u, v, m, lam)
    return ref.huber_contract_v_masked(u, v, m, w, lam)


def huber_contract_v(u, v, m, lam, w=None) -> torch.Tensor:
    """``Psi^T U`` (E, n, r); masked when ``w`` is given."""
    if on_cpu(u):
        return huber_contract_v_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w)
    out = _f32(op.e, op.n, op.r, device=u.device)
    plan = v_plan(op.e, op.m, op.n, op.r, sm_count(u.device))
    partial = out if plan.splits == 1 else _f32(plan.splits, op.e, op.n,
                                                op.r, device=u.device)
    _call("contract_v", "huber_contract_v", op, u, v, m, w, lam, out, partial,
          ints=(plan.splits, plan.rows, plan.cluster, plan.slice))
    return out


def huber_contract_u_plain(u, v, m, lam, w=None) -> torch.Tensor:
    if w is None:
        return ref.huber_contract_u(u, v, m, lam)
    return ref.huber_contract_u_masked(u, v, m, w, lam)


def _u_scratch(op, device) -> tuple[UPlan, torch.Tensor | None]:
    """The plan of a row-stripe launch and the (splits, E, m, r) partial
    planes of out_u its column splits need (none with one split)."""
    plan = u_plan(op.e, op.m, op.n, op.r, sm_count(device))
    partial = None if plan.splits == 1 else _f32(
        plan.splits, op.e, op.m, op.r, device=device)
    return plan, partial


def _diag_partial(op, plan: UPlan, device) -> torch.Tensor:
    """Per-block partials of the two diagnostics: 2 x E x stripes x splits
    (x the cluster's blocks on the cluster route, each summing the entries
    it formed)."""
    blocks = -(-op.m // U_TILE_ROWS) * plan.splits * max(1, plan.cluster)
    return _f32(2 * op.e * blocks, device=device)


def huber_contract_u(u, v, m, lam, w=None) -> torch.Tensor:
    """``Psi V`` (E, m, r); masked when ``w`` is given."""
    if on_cpu(u):
        return huber_contract_u_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w)
    out_u = _f32(op.e, op.m, op.r, device=u.device)
    plan, u_partial = _u_scratch(op, u.device)
    _call("contract_u", "huber_contract_u", op, u, v, m, w, lam, out_u,
          u_partial, ints=(plan.splits, plan.cols, plan.cluster, plan.slice))
    return out_u


def huber_contract_u_diag_plain(u, v, m, lam, w=None):
    if w is None:
        return ref.huber_contract_u_diag(u, v, m, lam)
    return ref.huber_contract_u_diag_masked(u, v, m, w, lam)


def huber_contract_u_diag(u, v, m, lam, w=None):
    """``(Psi V (E, m, r), H_lam(R_W) (E,), ||Psi||_F^2 (E,))``; masked
    when ``w`` is given."""
    if on_cpu(u):
        return huber_contract_u_diag_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w)
    dev = u.device
    out_u = _f32(op.e, op.m, op.r, device=dev)
    diag = _f32(2, op.e, device=dev)
    plan, u_partial = _u_scratch(op, dev)
    _call("contract_u_diag", "huber_contract_u_diag", op, u, v, m, w, lam,
          out_u, diag[0], diag[1], _diag_partial(op, plan, dev), u_partial,
          ints=(plan.splits, plan.cols, plan.cluster, plan.slice))
    return out_u, diag[0], diag[1]


def huber_dual_contract_plain(u, v, m, lam, w=None):
    if w is None:
        return ref.huber_dual_contract(u, v, m, lam)
    return ref.huber_dual_contract_masked(u, v, m, w, lam)


#: Bytes of fp32 out_v partial planes ``huber_dual_contract`` may hold:
#: the reference's bound on its resident out_v
#: (``repro/kernels/ops.py::RESIDENT_OUT_V_BYTES``).
DUAL_SCRATCH_BYTES = 4 << 20
#: Cluster sizes a row group of the dual may take (portable on Hopper).
DUAL_CLUSTERS = (1, 2, 4, 8)
#: Largest rank at which the dual's row groups may be clusters: a
#: cluster's receive buffers (2 x 64 x 32 RQ floats) fit a block's shared
#: memory beside its U stripe, two V stages and Psi^T only up to RQ = 5
#: (225 KB of 227; 266 KB at RQ = 6), and not at all beside the rank
#: slices or chunks of r > 256.
DUAL_CLUSTER_MAX_RANK = 160


def dual_groups(e: int, n: int, r: int) -> int:
    """The most (E, n, r) fp32 out_v partial planes that fit
    :data:`DUAL_SCRATCH_BYTES` (at least one: out_v itself)."""
    return max(1, DUAL_SCRATCH_BYTES // (4 * e * n * r))


def dual_scratch_shape(e: int, n: int, r: int) -> tuple[int, ...] | None:
    """The fp32 out_v scratch ``huber_dual_contract`` allocates: the
    (:func:`dual_groups`, E, n, r) partial planes, ``None`` where one plane
    (out_v itself) is all.  A function of (E, n, r) alone, so its bytes do
    not grow with m; at most :data:`DUAL_SCRATCH_BYTES`."""
    groups = dual_groups(e, n, r)
    return None if groups == 1 else (groups, e, n, r)


@functools.lru_cache(maxsize=1024)
def dual_plan(e: int, m: int, n: int, r: int) -> tuple[int, int] | None:
    """``(cluster, groups)`` of ``huber_dual_contract``'s row groups:
    ``groups`` thread-block clusters of ``cluster`` consecutive 64-row
    stripes cover every stripe, none empty, each adding its stripes'
    shares of out_v into one partial plane (out_v itself when ``groups ==
    1``) of :func:`dual_scratch_shape`.  The smallest cluster whose groups
    fit it, clusters of 1 only above :data:`DUAL_CLUSTER_MAX_RANK`;
    ``None`` where no allowed cluster does (then the wrapper takes the
    reference's two passes, as it does past its own 4 MiB)."""
    stripes = -(-m // U_TILE_ROWS)
    clusters = DUAL_CLUSTERS if r <= DUAL_CLUSTER_MAX_RANK else (1,)
    for cluster in clusters:
        groups = -(-stripes // cluster)
        if groups <= dual_groups(e, n, r):
            return cluster, groups
    return None


def huber_dual_contract(u, v, m, lam, w=None):
    """``(Psi^T U (E, n, r), Psi V (E, m, r), H_lam(R_W) (E,),
    ||Psi||_F^2 (E,))`` from one pass; masked when ``w`` is given.  Where
    the row groups' planes would pass 4 MiB (:func:`dual_plan` is
    ``None``), two passes instead: ``huber_contract_v`` and
    ``huber_contract_u_diag`` (their launches count under their names)."""
    if on_cpu(u):
        return huber_dual_contract_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w)
    plan = dual_plan(op.e, op.m, op.n, op.r)
    if plan is None:
        return (huber_contract_v(u, v, m, lam, w),
                *huber_contract_u_diag(u, v, m, lam, w))
    dev = u.device
    out_v = _f32(op.e, op.n, op.r, device=dev)
    out_u = _f32(op.e, op.m, op.r, device=dev)
    diag = _f32(2, op.e, device=dev)
    u_launch, u_partial = _u_scratch(op, dev)
    cluster, groups = plan
    scratch = dual_scratch_shape(op.e, op.n, op.r)
    v_partial = None if scratch is None else _f32(*scratch, device=dev)
    _call("dual", "huber_dual_contract", op, u, v, m, w, lam, out_v, out_u,
          diag[0], diag[1], _diag_partial(op, u_launch, dev), u_partial,
          v_partial, ints=(u_launch.splits, u_launch.cols, cluster, groups,
                           u_launch.cluster, u_launch.slice))
    return out_v, out_u, diag[0], diag[1]
