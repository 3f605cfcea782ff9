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
Ranks above 256 take the rank in chunks of at most 256
(``_launch.rank_chunks``): the grid holds one block for each chunk of the
output's rank axis, each forming the whole Psi of its tile (two halves
staged side by side up to r = 512, chunks staged in turn above:
``_launch.chunked``).
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

import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    MASK_SUFFIX, check_operands, chunked, launch, on_cpu, rank_chunks,
    signature, sm_count,
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
# per split) for contract_v, (splits, columns per split) for the others,
# and the dual's row groups (cluster, groups) after them; every entry then
# takes the rank route (``_launch.chunked``).
_ENTRIES = {
    "contract_v": ("repro_huber_contract_v", 2, 3),
    "contract_u": ("repro_huber_contract_u", 2, 3),
    "contract_u_diag": ("repro_huber_contract_u_diag", 5, 3),
    "dual": ("repro_huber_dual_contract", 7, 5),
}


def _call(stem: str, base: str, op, u, v, m, w, lam, *outputs,
          ints: tuple = ()) -> None:
    entry, pointers, extra = _ENTRIES[stem]
    lib = _build.library(stem, {entry: signature(pointers, extra)})
    launch(lib, entry, base + op.suffix, launches, op, u, v, m, w, lam,
           *outputs, ints=(*ints, int(chunked(op.r))))


#: Rows and columns of one ``huber_contract_v`` residual tile (``kVRows``
#: and ``kVCols`` in ``csrc/contract_v.cu``).
V_TILE_ROWS = V_TILE_COLS = 64
#: Rows of one stripe and columns of one residual tile of the row-stripe
#: kernels ``huber_contract_u``, ``huber_contract_u_diag`` and
#: ``huber_dual_contract`` (``kT64`` in ``csrc/stripe.cuh``).
U_TILE_ROWS = U_TILE_COLS = 64


def _splits(blocks: int, tiles: int, sms: int,
            per_sm: int = 2) -> tuple[int, int]:
    """``(splits, tiles_per_split)`` of a reduction over ``tiles`` tiles
    for a grid of ``blocks`` x splits blocks, ``per_sm`` resident on an SM.
    A split count is costed as ``ceil(blocks * splits / (per_sm sms))``
    waves, each as long as a block's tiles plus one (staging, writing the
    partials); the cheapest wins, and among equals the fewest splits (the
    least partial traffic)."""
    best = None
    for want in range(1, tiles + 1):
        per = -(-tiles // want)
        splits = -(-tiles // per)
        cost = -(-blocks * splits // (per_sm * sms)) * (per + 1)
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


@functools.lru_cache(maxsize=1024)
def v_splits(e: int, m: int, n: int, sms: int,
             chunks: int = 1) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the m reduction in
    ``huber_contract_v`` on a card with ``sms`` SMs: every range a whole
    number of 64-row tiles, none empty, together exactly the m rows.

    The grid is (column tiles x splits x clients) blocks, two resident on
    an SM (``csrc/contract_v.cu`` at r <= 160), costed by :func:`_splits`;
    with rank ``chunks`` (r > 256, :func:`rank_chunks`) that many times the
    blocks, one resident on an SM.  A pure function of the shape and the SM
    count, so a launch is the same on every run of one card."""
    splits, per = _splits(e * chunks * -(-n // V_TILE_COLS),
                          -(-m // V_TILE_ROWS), sms, 2 if chunks == 1 else 1)
    return splits, per * V_TILE_ROWS


@functools.lru_cache(maxsize=1024)
def u_splits(e: int, m: int, n: int, sms: int,
             chunks: int = 1) -> tuple[int, int]:
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
    ``chunks`` (r > 256) the grid holds that many times the blocks, one
    resident on an SM."""
    splits, per = _splits(e * chunks * -(-m // U_TILE_ROWS),
                          -(-n // U_TILE_COLS), sms, 2 if chunks == 1 else 1)
    return splits, per * U_TILE_COLS


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
    splits, rows = v_splits(op.e, op.m, op.n, sm_count(u.device),
                            rank_chunks(op.r))
    partial = out if splits == 1 else _f32(splits, op.e, op.n, op.r,
                                           device=u.device)
    _call("contract_v", "huber_contract_v", op, u, v, m, w, lam, out, partial,
          ints=(splits, rows))
    return out


def huber_contract_u_plain(u, v, m, lam, w=None) -> torch.Tensor:
    if w is None:
        return ref.huber_contract_u(u, v, m, lam)
    return ref.huber_contract_u_masked(u, v, m, w, lam)


def _u_scratch(op, device) -> tuple[tuple[int, int], torch.Tensor | None]:
    """The column splits of a row-stripe launch and the (splits, E, m, r)
    partial planes of out_u they need (none with one split)."""
    splits, cols = u_splits(op.e, op.m, op.n, sm_count(device),
                            rank_chunks(op.r))
    partial = None if splits == 1 else _f32(splits, op.e, op.m, op.r,
                                            device=device)
    return (splits, cols), partial


def _diag_partial(op, splits: int, device) -> torch.Tensor:
    """Per-block partials of the two diagnostics: 2 x E x stripes x
    splits."""
    return _f32(2 * op.e * -(-op.m // U_TILE_ROWS) * splits, device=device)


def huber_contract_u(u, v, m, lam, w=None) -> torch.Tensor:
    """``Psi V`` (E, m, r); masked when ``w`` is given."""
    if on_cpu(u):
        return huber_contract_u_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w)
    out_u = _f32(op.e, op.m, op.r, device=u.device)
    ints, u_partial = _u_scratch(op, u.device)
    _call("contract_u", "huber_contract_u", op, u, v, m, w, lam, out_u,
          u_partial, ints=ints)
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
    ints, u_partial = _u_scratch(op, dev)
    _call("contract_u_diag", "huber_contract_u_diag", op, u, v, m, w, lam,
          out_u, diag[0], diag[1], _diag_partial(op, ints[0], dev),
          u_partial, ints=ints)
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
#: chunks of r > 256.
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
    ints, u_partial = _u_scratch(op, dev)
    cluster, groups = plan
    scratch = dual_scratch_shape(op.e, op.n, op.r)
    v_partial = None if scratch is None else _f32(*scratch, device=dev)
    _call("dual", "huber_dual_contract", op, u, v, m, w, lam, out_v, out_u,
          diag[0], diag[1], _diag_partial(op, ints[0], dev), u_partial,
          v_partial, ints=(*ints, cluster, groups))
    return out_v, out_u, diag[0], diag[1]
