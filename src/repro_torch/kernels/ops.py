"""Dispatch layer: the solvers call these; ``impl`` picks the backend.

``impl='cuda'``  the hand-written kernels (CUDA tensors only).
``impl='ref'``   the plain PyTorch oracles of ``kernels.ref``, any device.
``impl='auto'``  by the tensors' device: the kernel for CUDA tensors, the
                 plain version for CPU tensors.

Signatures follow ``repro.kernels.ops``.  Operands are one problem
(``m`` is (m, n), factors (m, r) and (n, r)) or a stack of client blocks
with a leading axis E (``m`` is (E, m, n), ``u`` (E, m, r), ``v`` (E, n, r));
``m`` is fp32 or bf16; ``lam`` is a float, a 0-d tensor or one threshold per
client (E,).  ``w`` is an optional 0/1 mask: dense (shaped like ``m``) or
bit-packed uint8 (``kernels.bitmask``); every kernel reads a packed plane
as it is (the reference unpacks one for its shrink; the plain route here
unpacks it inside ``kernels.ref``).

``launch_counts`` covers every kernel of the port, the attention kernel
(``kernels.flash_attention``) included.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import huber_contract as _hc
from repro_torch.kernels import shrinkage as _sh

IMPLS = ("auto", "cuda", "ref")


def _use_kernel(impl: str, m: torch.Tensor) -> bool:
    """True when the call goes to a kernel wrapper (which itself takes the
    plain version for CPU tensors)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and m.device.type != "cuda":
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {m.device}")
    return impl != "ref"


def _kernel_args(u, v, m, lam, w):
    """Stack a single problem as E=1 and give ``lam`` one entry per client."""
    single = m.ndim == 2
    if single:
        u, v, m = u[None], v[None], m[None]
        w = None if w is None else w[None]
    if not isinstance(lam, torch.Tensor):  # filled on the device, no copy
        lam = torch.full((), float(lam), device=m.device)
    lam = lam.to(dtype=torch.float32, device=m.device)
    if lam.ndim == 0:
        lam = lam.expand(m.shape[0])
    return single, u, v, m, lam.contiguous(), w


def huber_contract_v(u, v, m, lam, *, w=None, impl: str = "auto"):
    """(n, r) = Psi^T U, Psi = clip(M - U V^T, +-lam); W * clip when ``w``."""
    if not _use_kernel(impl, m):
        if w is not None:
            return ref.huber_contract_v_masked(u, v, m, w, lam)
        return ref.huber_contract_v(u, v, m, lam)
    single, u, v, m, lam, w = _kernel_args(u, v, m, lam, w)
    out = _hc.huber_contract_v(u, v, m, lam, w)
    return out[0] if single else out


def huber_contract_u_diag(u, v, m, lam, *, w=None, impl: str = "auto"):
    """(Psi V, H_lam(R_W), ||Psi||_F^2) in one pass; Psi = clip(W R) when
    ``w``."""
    if not _use_kernel(impl, m):
        if w is not None:
            return ref.huber_contract_u_diag_masked(u, v, m, w, lam)
        return ref.huber_contract_u_diag(u, v, m, lam)
    single, u, v, m, lam, w = _kernel_args(u, v, m, lam, w)
    out_u, obj, psi2 = _hc.huber_contract_u_diag(u, v, m, lam, w)
    return (out_u[0], obj[0], psi2[0]) if single else (out_u, obj, psi2)


def residual_shrink(u, v, m, lam, *, w=None, impl: str = "auto"):
    """(m, n) = soft_threshold(M - U V^T, lam); W * S when ``w``."""
    if not _use_kernel(impl, m):
        if w is not None:
            return ref.residual_shrink_masked(u, v, m, w, lam)
        return ref.residual_shrink(u, v, m, lam)
    single, u, v, m, lam, w = _kernel_args(u, v, m, lam, w)
    s = _sh.residual_shrink(u, v, m, lam, w)
    return s[0] if single else s


def huber_contract_u(u, v, m, lam, *, w=None, impl: str = "auto"):
    """(m, r) = Psi V; masked when ``w``."""
    if not _use_kernel(impl, m):
        if w is not None:
            return ref.huber_contract_u_masked(u, v, m, w, lam)
        return ref.huber_contract_u(u, v, m, lam)
    single, u, v, m, lam, w = _kernel_args(u, v, m, lam, w)
    out = _hc.huber_contract_u(u, v, m, lam, w)
    return out[0] if single else out


def huber_dual_contract(u, v, m, lam, *, w=None, impl: str = "auto"):
    """(Psi^T U, Psi V, H_lam(R_W), ||Psi||_F^2) in one pass over M; Psi =
    clip(W R) when ``w``.  Always the one fused kernel on CUDA tensors."""
    if not _use_kernel(impl, m):
        if w is not None:
            return ref.huber_dual_contract_masked(u, v, m, w, lam)
        return ref.huber_dual_contract(u, v, m, lam)
    single, u, v, m, lam, w = _kernel_args(u, v, m, lam, w)
    outs = _hc.huber_dual_contract(u, v, m, lam, w)
    return tuple(x[0] for x in outs) if single else outs


def residual_shrink_psi(u, v, m, lam, *, w=None, impl: str = "auto"):
    """((m, n) S, (m, n) Psi = R - S) in one pass; (W S, W R - W S) when
    ``w``."""
    if not _use_kernel(impl, m):
        if w is not None:
            return ref.residual_shrink_psi_masked(u, v, m, w, lam)
        return ref.residual_shrink_psi(u, v, m, lam)
    single, u, v, m, lam, w = _kernel_args(u, v, m, lam, w)
    s, psi = _sh.residual_shrink_psi(u, v, m, lam, w)
    return (s[0], psi[0]) if single else (s, psi)


def launch_counts() -> dict[str, int]:
    """Kernel launches so far, per function."""
    return {**_hc.launches, **_sh.launches, **_fa.launches}


def reset_launch_counts() -> None:
    for table in (_hc.launches, _sh.launches, _fa.launches):
        for name in table:
            table[name] = 0


def add_launch_counts(delta: dict[str, int]) -> None:
    """Add ``delta`` (kernel name -> launches) to the counts: a CUDA graph's
    replay launches its captured kernels without running their wrappers
    (``core.runtime.CapturedRound``)."""
    for table in (_hc.launches, _sh.launches, _fa.launches):
        for name in table.keys() & delta.keys():
            table[name] += delta[name]
