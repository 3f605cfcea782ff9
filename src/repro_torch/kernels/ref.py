"""Plain PyTorch versions of every kernel function (the oracles).

The same semantics as ``repro.kernels.ref``, in fp32 (a bf16 ``M`` is
upcast before anything else), for any number of leading batch axes (the
client axis E of the simulated engine):

    R   = M - U V^T
    S   = sign(R) * max(|R| - lam, 0)
    Psi = clip(R, -lam, lam) = R - S

``lam`` is a Python float, a 0-d tensor, or a tensor with the batch shape
(one threshold per client).  Masked forms take a 0/1 plane ``w`` (dense, or
bit-packed uint8) and mirror where the reference applies it: the
contractions and the shrink multiply after the clip/threshold, the fused
diagnostics (``huber_dual_contract*``, ``huber_contract_u_diag*``) clip
``W * R``.  With an all-ones ``w`` every masked form equals its unmasked
twin bit for bit (multiplying by 1.0 is exact).

``flash_attention`` is the oracle of the attention kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmask

Tensor = torch.Tensor


def _lam(lam, like: Tensor) -> Tensor:
    """``lam`` as fp32 on ``like``'s device, broadcastable against planes."""
    lam = torch.as_tensor(lam, dtype=torch.float32, device=like.device)
    return lam.reshape(lam.shape + (1, 1)) if lam.ndim else lam


def _dense_w(w: Tensor, n: int) -> Tensor:
    return bitmask.resolve_mask(w, n).to(torch.float32)


def _residual(u: Tensor, v: Tensor, m: Tensor) -> Tensor:
    """R = M - U V^T in fp32."""
    return m.to(torch.float32) - u @ v.transpose(-1, -2)


def _huber_sum(r: Tensor, lam: Tensor) -> Tensor:
    """Huber loss H_lam summed over the last two axes."""
    a = r.abs()
    h = torch.where(a <= lam, 0.5 * r * r, lam * a - 0.5 * lam * lam)
    return h.sum(dim=(-2, -1))


def _soft_threshold(r: Tensor, lam) -> Tensor:
    return torch.sign(r) * torch.clamp_min(r.abs() - _lam(lam, r), 0.0)


def residual_shrink(u, v, m, lam) -> Tensor:
    """S = soft_threshold(M - U V^T, lam)."""
    return _soft_threshold(_residual(u, v, m), lam)


def residual_shrink_psi(u, v, m, lam) -> tuple[Tensor, Tensor]:
    """``(S, Psi)`` from one residual, ``Psi = R - S`` (the reference
    kernel's formula; equal to ``clip(R)`` up to rounding)."""
    r = _residual(u, v, m)
    s = _soft_threshold(r, lam)
    return s, r - s


def residual_clip(u, v, m, lam) -> Tensor:
    """Psi = clip(M - U V^T, [-lam, lam])."""
    r = _residual(u, v, m)
    lam = _lam(lam, r)
    return torch.minimum(torch.maximum(r, -lam), lam)


def huber_contract_v(u, v, m, lam) -> Tensor:
    """Psi^T U: the (n, r) inner-solve contraction."""
    return residual_clip(u, v, m, lam).transpose(-1, -2) @ u


def huber_contract_u(u, v, m, lam) -> Tensor:
    """Psi V: the (m, r) U-step contraction."""
    return residual_clip(u, v, m, lam) @ v


def huber_dual_contract(u, v, m, lam):
    """``(Psi^T U, Psi V, H_lam(R), ||Psi||_F^2)`` from one residual."""
    r = _residual(u, v, m)
    lam = _lam(lam, r)
    psi = torch.minimum(torch.maximum(r, -lam), lam)
    return (psi.transpose(-1, -2) @ u, psi @ v, _huber_sum(r, lam),
            (psi * psi).sum(dim=(-2, -1)))


def huber_contract_u_diag(u, v, m, lam):
    """``(Psi V, H_lam(R), ||Psi||_F^2)``: the U-step contraction with the
    round diagnostics."""
    _, out_u, obj, psi2 = huber_dual_contract(u, v, m, lam)
    return out_u, obj, psi2


def residual_clip_masked(u, v, m, w, lam) -> Tensor:
    """Psi_W = W * clip(M - U V^T, [-lam, lam])."""
    return _dense_w(w, m.shape[-1]) * residual_clip(u, v, m, lam)


def residual_shrink_masked(u, v, m, w, lam) -> Tensor:
    """S_W = W * soft_threshold(M - U V^T, lam)."""
    return _dense_w(w, m.shape[-1]) * residual_shrink(u, v, m, lam)


def residual_shrink_psi_masked(u, v, m, w, lam) -> tuple[Tensor, Tensor]:
    """``(W S, W R - W S)``, the reference kernel's masked formulas."""
    w = _dense_w(w, m.shape[-1])
    r = _residual(u, v, m)
    s = w * _soft_threshold(r, lam)
    return s, w * r - s


def huber_contract_v_masked(u, v, m, w, lam) -> Tensor:
    """Psi_W^T U: the masked (n, r) inner-solve contraction."""
    return residual_clip_masked(u, v, m, w, lam).transpose(-1, -2) @ u


def huber_contract_u_masked(u, v, m, w, lam) -> Tensor:
    """Psi_W V: the masked (m, r) U-step contraction."""
    return residual_clip_masked(u, v, m, w, lam) @ v


def huber_dual_contract_masked(u, v, m, w, lam):
    """Masked fused primitive: ``Psi_W = clip(W * R, +-lam)``,
    ``obj = H_lam(W * R)``."""
    rw = _dense_w(w, m.shape[-1]) * _residual(u, v, m)
    lam = _lam(lam, rw)
    psi = torch.minimum(torch.maximum(rw, -lam), lam)
    return (psi.transpose(-1, -2) @ u, psi @ v, _huber_sum(rw, lam),
            (psi * psi).sum(dim=(-2, -1)))


def huber_contract_u_diag_masked(u, v, m, w, lam):
    """Masked ``(Psi_W V, H_lam(W R), ||Psi_W||_F^2)``."""
    _, out_u, obj, psi2 = huber_dual_contract_masked(u, v, m, w, lam)
    return out_u, obj, psi2


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> Tensor:
    """Naive softmax attention in fp32 on (B, S, H, d) tensors (GQA heads
    expanded): the oracle of the flash kernel, as
    tests/test_flash_attention.py's ``naive``; rows and columns absolute
    from 0, masked scores -1e30.  Returns ``q``'s type."""
    sq, sk = q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / q.shape[-1] ** 0.5
    s = torch.einsum("bqhd,bshd->bhqs", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        mask = rows >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqs,bshd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)
