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
it packs, and an all-ones plane the bits of no mask.  The kernel
(``csrc/shrink.cu``, Psi a template flag of the same tile) computes each
64 x 64 tile of S from cp.async-staged rows of U and V (``csrc/tile64.cuh``),
and M, W, S and Psi each cross device memory once: 2r FLOP per entry
against 4-16 bytes, so fp32 arithmetic bounds it at r = 150 and the bytes
about as much at r = 64.

On CPU tensors the wrapper returns the plain version; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    MASK_SUFFIX, check_operands, launch, on_cpu, signature,
)

#: Kernel launches per function (CUDA tensors only).
launches = {base + suffix: 0
            for base in ("residual_shrink", "residual_shrink_psi")
            for suffix in MASK_SUFFIX.values()}

_ENTRY = "repro_residual_shrink"
_PSI_ENTRY = "repro_residual_shrink_psi"
_SIGNATURES = {_ENTRY: signature(1), _PSI_ENTRY: signature(2)}


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
           u, v, m, w, lam, s)
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
           u, v, m, w, lam, s, psi)
    return s, psi
