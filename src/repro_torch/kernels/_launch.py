"""What every kernel wrapper shares: device routing, operand checks and the
ctypes call plumbing.

A wrapper asks :func:`on_cpu` first: CPU tensors go to its plain version,
CUDA tensors to its kernel (anything else raises).  Before a launch it
validates the operands with :func:`check_operands`, which also gives the
codes of M's data type and of the mask mode that every C entry takes, and
calls the entry through :func:`launch` (or, for another operand layout,
:func:`call`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

#: Ranks one register block of the kernels covers (r <= 32 * 8), and the
#: width of a rank chunk above it (``kRankChunk`` in ``csrc/tile64.cuh``).
RANK_CHUNK = 256
#: The contractions above :data:`RANK_CHUNK` (``contract_v_cluster_kernel``
#: and ``stripe_cluster_kernel``): the widest rank slice of one block of a
#: cluster (``kSliceMax`` in ``csrc/tile64.cuh``: a factor slice, two
#: stages of the other factor's, a partial and Psi fill the 227 KB a block
#: may take) and the most blocks of its thread-block cluster
#: (``kClusterMax``, the portable cluster size).
SLICE_MAX = 256
CLUSTER_MAX = 8
#: Ranks up to which ``huber_contract_v`` takes r > :data:`RANK_CHUNK` in
#: its cluster kernel (CLUSTER_MAX slices of SLICE_MAX); above, in the
#: chunk kernel ``contract_v_chunk_kernel`` (:func:`v_chunked`).
V_CLUSTER_MAX_RANK = CLUSTER_MAX * SLICE_MAX
#: The same for the row-stripe contractions (``huber_contract_u``,
#: ``huber_contract_u_diag``, ``huber_dual_contract``): their cluster
#: kernel ``stripe_cluster_kernel`` up to this rank, ``stripe_chunk_kernel``
#: above (:func:`u_chunked`).
U_CLUSTER_MAX_RANK = CLUSTER_MAX * SLICE_MAX
#: The CUDA grid's limit on its y and z axes.
GRID_YZ = 65535
#: Rows and columns of one residual tile (``kT64`` in ``csrc/tile64.cuh``).
TILE = 64
#: Rows and columns of one output tile of the shrink above
#: :data:`RANK_CHUNK` (``shrink_stream_kernel``: ``kStreamRows`` and
#: ``kStreamCols`` in ``csrc/shrink.cu``).
STREAM_ROWS, STREAM_COLS = 128, 64
#: Codes of M's data type and of the mask mode (``DType`` and ``MaskMode``
#: in ``csrc/tile.cuh``).
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NO_MASK, DENSE_MASK, PACKED_MASK = 0, 1, 2
#: Launch-count suffix of each mask mode.
MASK_SUFFIX = {NO_MASK: "", DENSE_MASK: "_masked", PACKED_MASK: "_packed"}

P, I = ctypes.c_void_p, ctypes.c_int


class Operands(NamedTuple):
    """Sizes and codes of validated kernel operands."""

    e: int
    m: int
    n: int
    r: int
    dtype: int  # DTYPE_CODES of M
    mask: int  # NO_MASK, DENSE_MASK or PACKED_MASK

    @property
    def suffix(self) -> str:
        return MASK_SUFFIX[self.mask]


def rank_chunks(r: int) -> int:
    """Rank chunks a contraction's chunk kernel takes at rank ``r``:
    ``ceil(r / 256)``, so 1 up to :data:`RANK_CHUNK`; the grid holds that
    many blocks a tile, one for each chunk of the output's rank axis."""
    return -(-r // RANK_CHUNK)


def u_chunked(r: int) -> bool:
    """Whether the row-stripe contractions take rank ``r`` in the chunk
    kernel ``stripe_chunk_kernel`` (chunks of :data:`RANK_CHUNK` staged in
    turn, each block forming the tile's whole Psi: above
    :data:`U_CLUSTER_MAX_RANK`) rather than in one register block (r <=
    256) or the cluster kernel ``stripe_cluster_kernel``."""
    return r > U_CLUSTER_MAX_RANK


def v_chunked(r: int) -> bool:
    """Whether ``huber_contract_v`` takes rank ``r`` in the chunk kernel
    ``contract_v_chunk_kernel`` (chunks of :data:`RANK_CHUNK` staged in
    turn, each block forming the tile's whole Psi: above
    :data:`V_CLUSTER_MAX_RANK`) rather than in one register block (r <=
    256) or the cluster kernel ``contract_v_cluster_kernel``."""
    return r > V_CLUSTER_MAX_RANK


def grid_limit_error(e: int, m: int, r: int) -> str | None:
    """Why no kernel grid holds E = ``e`` clients of ``m`` rows at rank
    ``r``, or ``None`` when one does: the grids' y and z axes stop at
    65535, and the shrink's y axis counts its row tiles (64 rows up to
    r = 256, :data:`STREAM_ROWS` above; ``huber_contract_v``'s counts row
    splits, at most as many 64-row tiles, and few), every z axis one block
    a client.  The rank chunks and slices ride the grids' x axis or a
    block's own loop, which set no limit here."""
    if e > GRID_YZ:
        return (f"E={e} clients at rank {r} need a grid z axis of {e} "
                f"blocks; CUDA allows {GRID_YZ}")
    rows = TILE if r <= RANK_CHUNK else STREAM_ROWS
    tiles = -(-m // rows)
    if tiles > GRID_YZ:
        return (f"m={m} rows are {tiles} tiles of {rows}; the CUDA grid's "
                f"y axis allows {GRID_YZ}")
    return None


def on_cpu(u: torch.Tensor) -> bool:
    """True for a CPU tensor (use the plain version), False for a CUDA
    tensor (launch the kernel); raises for any other device."""
    if u.device.type == "cpu":
        return True
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    return False


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (the kernels' grid splits
    are pure functions of the shape and this)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check_operands(u, v, m, lam, w=None) -> Operands:
    """Validate kernel operands.

    All must be contiguous tensors on one CUDA device: fp32 ``u`` (E, m, r),
    ``v`` (E, n, r) and ``lam`` (E,); ``m`` (E, m, n) fp32 or bf16; ``w``
    absent, a dense fp32 0/1 plane shaped like ``m``, or a bit-packed uint8
    plane (E, m, ceil(n/8)).  Anything else raises.
    """
    named = {"u": u, "v": v, "m": m, "lam": lam}
    if w is not None:
        named["w"] = w
    for name, t in named.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != u.device or t.device.type != "cuda":
            raise ValueError(
                f"{name} is on {t.device}; the CUDA kernel needs every "
                f"operand on the device of u ({u.device})"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("u", "v", "lam"):
        if named[name].dtype != torch.float32:
            raise TypeError(f"{name} has dtype {named[name].dtype}; the CUDA "
                            f"kernels take float32 factors and thresholds")
    if m.dtype not in DTYPE_CODES:
        raise TypeError(f"m has dtype {m.dtype}; the CUDA kernels take "
                        f"float32 or bfloat16 data")
    if u.ndim != 3 or v.ndim != 3 or m.ndim != 3:
        raise ValueError(
            f"expected u (E, m, r), v (E, n, r), m (E, m, n); got "
            f"{tuple(u.shape)}, {tuple(v.shape)}, {tuple(m.shape)}"
        )
    e, mm, r = u.shape
    n = v.shape[1]
    if tuple(v.shape) != (e, n, r) or tuple(m.shape) != (e, mm, n):
        raise ValueError(
            f"shape mismatch: u {tuple(u.shape)}, v {tuple(v.shape)}, "
            f"m {tuple(m.shape)}"
        )
    if tuple(lam.shape) != (e,):
        raise ValueError(f"lam must have shape ({e},), got {tuple(lam.shape)}")
    mask = NO_MASK
    if w is not None:
        if w.dtype == torch.float32:
            mask, want = DENSE_MASK, (e, mm, n)
        elif w.dtype == torch.uint8:
            mask, want = PACKED_MASK, (e, mm, -(-n // 8))
        else:
            raise TypeError(
                f"w has dtype {w.dtype}; the kernels take a dense float32 "
                f"mask or a bit-packed uint8 one")
        if tuple(w.shape) != want:
            raise ValueError(
                f"mask shape {tuple(w.shape)} != {want} for data "
                f"{tuple(m.shape)}"
            )
    if min(e, mm, n, r) < 1:
        raise ValueError(f"unsupported sizes E={e}, m={mm}, n={n}, r={r}")
    limit = grid_limit_error(e, mm, r)
    if limit is not None:
        raise ValueError(limit)
    return Operands(e, mm, n, r, DTYPE_CODES[m.dtype], mask)


def signature(pointers: int, ints: int = 0) -> tuple:
    """ctypes argument types of a C entry: ``u, v, m, w, lam`` and
    ``pointers`` more device pointers, then ``E, M, N, r, dtype, mask``,
    ``ints`` more ints, and the stream."""
    return (P,) * (5 + pointers) + (I,) * (6 + ints) + (P,)


def call(lib: ctypes.CDLL, entry: str, name: str, counts: dict[str, int],
         device: torch.device, *args) -> None:
    """Call C entry ``entry`` of ``lib`` with ``args`` and the current
    stream of ``device``, raise if it reports a CUDA error, and count one
    launch of ``name``.  The device context is entered only when
    ``device`` is not the current device already (the usual case skips
    its cost on every launch).  The stream comes as the raw handle
    (``torch._C._cuda_getCurrentRawStream``, as PyTorch's own generated
    kernels take it): building a ``torch.cuda.Stream`` for it cost ~4 us a
    launch on the H100's host, as much as a small kernel's device time."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == current:
        status = getattr(lib, entry)(*args, stream)
    else:
        with torch.cuda.device(device):
            status = getattr(lib, entry)(*args, stream)
    if status != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {status}"
        )
    counts[name] += 1


def launch(lib: ctypes.CDLL, entry: str, name: str, counts: dict[str, int],
           op: Operands, u, v, m, w, lam, *outputs, ints: tuple = ()) -> None:
    """:func:`call` of an entry with the RPCA operand layout (see
    :func:`signature`) on ``u``'s device."""
    call(lib, entry, name, counts, u.device,
         *(None if t is None else t.data_ptr()
           for t in (u, v, m, w, lam, *outputs)),
         op.e, op.m, op.n, op.r, op.dtype, op.mask, *ints)
