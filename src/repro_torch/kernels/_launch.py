"""What every kernel wrapper shares: device routing, operand checks and the
ctypes call plumbing.

A wrapper asks :func:`on_cpu` first: CPU tensors go to its plain version,
CUDA tensors to its kernel (anything else raises).  Before a launch it
validates the operands with :func:`check_operands`, passes each pointer as
:func:`ptr` and the current stream as :func:`stream`, and hands the C
entry's return code to :func:`check`.
"""
from __future__ import annotations

import torch

#: Largest factor rank the kernels take (r <= 32 * 8).
MAX_RANK = 256
#: Rows and columns of one kernel tile (``kTile`` in ``csrc/tile.cuh``).
TILE = 32


def on_cpu(u: torch.Tensor) -> bool:
    """True for a CPU tensor (use the plain version), False for a CUDA
    tensor (launch the kernel); raises for any other device."""
    if u.device.type == "cpu":
        return True
    if u.device.type != "cuda":
        raise ValueError(f"no kernel for device {u.device}")
    return False


def check_operands(u, v, m, lam, w=None) -> tuple[int, int, int, int]:
    """Validate kernel operands; returns ``(E, m, n, r)``.

    All must be contiguous fp32 tensors on one CUDA device: ``u`` (E, m, r),
    ``v`` (E, n, r), ``m`` and a dense 0/1 ``w`` (E, m, n), ``lam`` (E,).
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
        if t.dtype != torch.float32:
            raise TypeError(
                f"{name} has dtype {t.dtype}; the CUDA kernels take float32 "
                f"only (a bf16 data plane and bit-packed masks wait for a "
                f"later slice, see ROADMAP.md)"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
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
    if w is not None and w.shape != m.shape:
        raise ValueError(
            f"mask shape {tuple(w.shape)} != data shape {tuple(m.shape)}"
        )
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside the kernels' range 1..{MAX_RANK}")
    if min(e, mm, n) < 1 or e > 65535 or -(-mm // TILE) > 65535:
        raise ValueError(f"unsupported sizes E={e}, m={mm}, n={n}")
    return e, mm, n, r


def ptr(t: torch.Tensor | None) -> int | None:
    """The device address of ``t`` (``None`` -> a null pointer)."""
    return None if t is None else t.data_ptr()


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as a handle for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def check(status: int, name: str) -> None:
    """Raise if a C entry reported a CUDA error."""
    if status != 0:
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {status}"
        )
