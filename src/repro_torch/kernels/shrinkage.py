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

``M`` is fp32 or bf16 (upcast on load); ``S`` is fp32.  The kernel takes no
mask or a dense fp32 one: it runs once per solve, so a bit-packed mask is
unpacked by the dispatch (``kernels.ops``), as the reference does.  The
kernel (``csrc/shrink.cu``, Psi a template flag of the same tile) computes
each 32 x 32 tile of S from staged rows of U and V, and M, S and Psi each
cross device memory once: 2r FLOP per entry against 6-16 bytes, so fp32
arithmetic bounds it at r = 150 and the bytes at r = 64.

On CPU tensors the wrapper returns the plain version; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    check_operands, launch, on_cpu, signature,
)

#: Kernel launches per function (CUDA tensors only).
launches = {"residual_shrink": 0, "residual_shrink_masked": 0,
            "residual_shrink_psi": 0, "residual_shrink_psi_masked": 0}

_ENTRY = "repro_residual_shrink"
_PSI_ENTRY = "repro_residual_shrink_psi"
_SIGNATURES = {_ENTRY: signature(1), _PSI_ENTRY: signature(2)}


def residual_shrink_plain(u, v, m, lam, w=None) -> torch.Tensor:
    if w is None:
        return ref.residual_shrink(u, v, m, lam)
    return ref.residual_shrink_masked(u, v, m, w, lam)


def residual_shrink(u, v, m, lam, w=None) -> torch.Tensor:
    """``S`` (E, m, n); ``W * S`` when ``w`` (dense) is given."""
    if on_cpu(u):
        return residual_shrink_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w, packed=False)
    s = torch.empty((op.e, op.m, op.n), dtype=torch.float32, device=u.device)
    lib = _build.library("shrink", _SIGNATURES)
    launch(lib, _ENTRY, "residual_shrink" + op.suffix, launches, op,
           u, v, m, w, lam, s)
    return s


def residual_shrink_psi_plain(u, v, m, lam, w=None):
    if w is None:
        return ref.residual_shrink_psi(u, v, m, lam)
    return ref.residual_shrink_psi_masked(u, v, m, w, lam)


def residual_shrink_psi(u, v, m, lam, w=None):
    """``(S, Psi)``, each (E, m, n); ``(W * S, W * R - W * S)`` when ``w``
    (dense) is given."""
    if on_cpu(u):
        return residual_shrink_psi_plain(u, v, m, lam, w)
    op = check_operands(u, v, m, lam, w, packed=False)
    s, psi = (torch.empty((op.e, op.m, op.n), dtype=torch.float32,
                          device=u.device) for _ in range(2))
    lib = _build.library("shrink", _SIGNATURES)
    launch(lib, _PSI_ENTRY, "residual_shrink_psi" + op.suffix, launches, op,
           u, v, m, w, lam, s, psi)
    return s, psi
