"""Huber-residual contractions: CUDA kernels and their plain versions.

Two functions, each batched over a leading client axis E (U is (E, m, r):
after the first U-step every client holds its own copy):

``huber_contract_v``       ``Psi^T U`` -> (E, n, r), with
                           ``Psi = clip(M - U V^T, +-lam)``, masked
                           ``Psi = W * clip(M - U V^T, +-lam)``.  Replaces
                           ``repro/kernels/huber_contract.py::huber_contract_v``
                           (:159, kernel :82) and ``huber_contract_v_masked``
                           (:239, kernel :97).
``huber_contract_u_diag``  ``(Psi V, H_lam(R_W), ||Psi||_F^2)`` ->
                           (E, m, r), (E,), (E,), with ``R_W = W * R`` and
                           ``Psi = clip(R_W, +-lam)``.  Replaces
                           ``huber_contract_u_diag`` (:521) and
                           ``huber_contract_u_diag_masked`` (:537), both the
                           body ``_make_dual_kernel(with_v=False)`` (:341).

The kernels (``csrc/contract.cu``) are bound by fp32 arithmetic on an H100,
not by device memory: each residual entry costs 4r FLOP against 4 bytes of
M, ~150 FLOP/byte at r = 150 against a ridge of ~20.  They read M once,
keep each residual tile in shared memory, and spend the rest on register-
blocked FMA loops; see the source for the layout.  ``lam`` is a device
tensor of shape (E,), so the solver loop never reads a value back to the
host.  The launches are deterministic (no atomics): ``huber_contract_v``
splits its m reduction into a number of row ranges fixed by the shape and
the card's SM count, then sums them in order.

A wrapper given CPU tensors returns its plain version (``*_plain``, the
``kernels.ref`` oracles); given CUDA tensors it launches its kernel or
raises.  ``launches`` counts kernel launches per function.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    TILE, check, check_operands, on_cpu, ptr, stream,
)

#: Kernel launches per function (CUDA tensors only).
launches = {
    "huber_contract_v": 0,
    "huber_contract_v_masked": 0,
    "huber_contract_u_diag": 0,
    "huber_contract_u_diag_masked": 0,
}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # u, v, m, w, lam, out, partial, E, M, N, r, splits, rows, stream
    "repro_huber_contract_v": (_P,) * 7 + (_I,) * 6 + (_P,),
    # u, v, m, w, lam, out_u, obj, psi2, partial, E, M, N, r, stream
    "repro_huber_contract_u_diag": (_P,) * 9 + (_I,) * 4 + (_P,),
}


def _lib() -> ctypes.CDLL:
    return _build.library("contract", _SIGNATURES)


def v_splits(e: int, m: int, n: int, device: torch.device) -> tuple[int, int]:
    """``(splits, rows_per_split)`` of the m reduction in
    ``huber_contract_v``: enough row ranges that the (column tile x split x
    client) grid holds about two blocks per SM, each range a whole number of
    32-row tiles and none empty."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    m_tiles = -(-m // TILE)
    n_tiles = -(-n // TILE)
    splits = min(m_tiles, max(1, -(-2 * sms // (e * n_tiles))))
    per = -(-m_tiles // splits)
    return -(-m_tiles // per), per * TILE


def huber_contract_v_plain(u, v, m, lam, w=None) -> torch.Tensor:
    if w is None:
        return ref.huber_contract_v(u, v, m, lam)
    return ref.huber_contract_v_masked(u, v, m, w, lam)


def huber_contract_v(u, v, m, lam, w=None) -> torch.Tensor:
    """``Psi^T U`` (E, n, r); masked when ``w`` is given."""
    if on_cpu(u):
        return huber_contract_v_plain(u, v, m, lam, w)
    e, mm, n, r = check_operands(u, v, m, lam, w)
    out = torch.empty((e, n, r), dtype=torch.float32, device=u.device)
    splits, rows = v_splits(e, mm, n, u.device)
    partial = out if splits == 1 else torch.empty(
        (splits, e, n, r), dtype=torch.float32, device=u.device)
    with torch.cuda.device(u.device):
        status = _lib().repro_huber_contract_v(
            ptr(u), ptr(v), ptr(m), ptr(w), ptr(lam), ptr(out),
            ptr(partial), e, mm, n, r, splits, rows, stream(u.device),
        )
    name = "huber_contract_v" if w is None else "huber_contract_v_masked"
    check(status, name)
    launches[name] += 1
    return out


def huber_contract_u_diag_plain(u, v, m, lam, w=None):
    if w is None:
        return ref.huber_contract_u_diag(u, v, m, lam)
    return ref.huber_contract_u_diag_masked(u, v, m, w, lam)


def huber_contract_u_diag(u, v, m, lam, w=None):
    """``(Psi V (E, m, r), H_lam(R_W) (E,), ||Psi||_F^2 (E,))``; masked
    when ``w`` is given."""
    if on_cpu(u):
        return huber_contract_u_diag_plain(u, v, m, lam, w)
    e, mm, n, r = check_operands(u, v, m, lam, w)
    dev = u.device
    out_u = torch.empty((e, mm, r), dtype=torch.float32, device=dev)
    diag = torch.empty((2, e), dtype=torch.float32, device=dev)
    partial = torch.empty(2 * e * -(-mm // TILE), dtype=torch.float32,
                          device=dev)
    with torch.cuda.device(dev):
        status = _lib().repro_huber_contract_u_diag(
            ptr(u), ptr(v), ptr(m), ptr(w), ptr(lam), ptr(out_u),
            ptr(diag[0]), ptr(diag[1]), ptr(partial), e, mm, n, r,
            stream(dev),
        )
    name = ("huber_contract_u_diag" if w is None
            else "huber_contract_u_diag_masked")
    check(status, name)
    launches[name] += 1
    return out_u, diag[0], diag[1]
