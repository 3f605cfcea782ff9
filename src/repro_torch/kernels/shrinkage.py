"""Low-rank-residual soft threshold: CUDA kernel and its plain version.

``residual_shrink``  ``S = sign(R) * max(|R| - lam, 0)`` with
                     ``R = M - U V^T``, (E, m, n); masked ``W * S``.
                     Replaces ``repro/kernels/shrinkage.py::residual_shrink``
                     (:97, kernel ``_shrink_kernel`` :41) and
                     ``residual_shrink_masked`` (:167, kernel :57).

The kernel (``csrc/shrink.cu``) is bound by fp32 arithmetic on an H100:
2r FLOP of U V^T per entry against 8 bytes (M in, S out), ~37 FLOP/byte at
r = 150 against a ridge of ~20.  Each block computes a 32 x 32 tile of S
from staged rows of U and V; the residual never reaches device memory.  It
runs once per solve.

On CPU tensors the wrapper returns the plain version; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    check, check_operands, on_cpu, ptr, stream,
)

#: Kernel launches per function (CUDA tensors only).
launches = {"residual_shrink": 0, "residual_shrink_masked": 0}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # u, v, m, w, lam, s, E, M, N, r, stream
    "repro_residual_shrink": (_P,) * 6 + (_I,) * 4 + (_P,),
}


def residual_shrink_plain(u, v, m, lam, w=None) -> torch.Tensor:
    if w is None:
        return ref.residual_shrink(u, v, m, lam)
    return ref.residual_shrink_masked(u, v, m, w, lam)


def residual_shrink(u, v, m, lam, w=None) -> torch.Tensor:
    """``S`` (E, m, n); ``W * S`` when ``w`` is given."""
    if on_cpu(u):
        return residual_shrink_plain(u, v, m, lam, w)
    e, mm, n, r = check_operands(u, v, m, lam, w)
    s = torch.empty((e, mm, n), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        status = _build.library("shrink", _SIGNATURES).repro_residual_shrink(
            ptr(u), ptr(v), ptr(m), ptr(w), ptr(lam), ptr(s),
            e, mm, n, r, stream(u.device),
        )
    name = "residual_shrink" if w is None else "residual_shrink_masked"
    check(status, name)
    launches[name] += 1
    return s
