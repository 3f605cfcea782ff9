"""Elementary RPCA operators (PyTorch counterparts of ``repro.core.ops``).

Plain functions on tensors; the kernels in ``repro_torch.kernels`` fuse the
hot paths (the soft threshold of a low-rank residual, the Huber-clipped
contractions) and these are the semantics they match.  Functions that take
a Gram matrix accept any number of leading batch axes, and :func:`svt`,
:func:`fro`, :func:`total` and :func:`amax` a leading problem axis (B, m,
n) with one result a problem, as the batched solvers need.
"""
from __future__ import annotations

import math

import torch

Tensor = torch.Tensor


def soft_threshold(x: Tensor, lam) -> Tensor:
    """``sign(x) * max(|x| - lam, 0)``: the prox of ``lam ||.||_1`` (Eq. 16)."""
    return torch.sign(x) * torch.clamp_min(x.abs() - lam, 0.0)


def masked_soft_threshold(x: Tensor, lam, w: Tensor) -> Tensor:
    """``W * soft_threshold(x, lam)``: the prox of ``lam ||P_Omega(.)||_1``
    on the observed support (S == 0 outside Omega)."""
    return w * soft_threshold(x, lam)


def per_problem(x):
    """A per-problem scalar (B,) shaped to broadcast against (B, m, n); a
    0-d tensor or a float (one problem) passes through as it is."""
    if isinstance(x, Tensor) and x.ndim == 1:
        return x[:, None, None]
    return x


def fro(x: Tensor) -> Tensor:
    """Frobenius norm of a matrix, or one a matrix of a batch (B, m, n)."""
    if x.ndim == 2:
        return torch.linalg.norm(x)
    return torch.linalg.vector_norm(x, dim=(-2, -1))


def total(x: Tensor) -> Tensor:
    """Sum of a matrix's entries, or one sum a matrix of a batch."""
    return x.sum() if x.ndim == 2 else x.sum(dim=(-2, -1))


def amax(x: Tensor) -> Tensor:
    """Largest entry of a matrix, or one a matrix of a batch."""
    return x.amax() if x.ndim == 2 else x.amax(dim=(-2, -1))


def svd_driver(x: Tensor) -> str | None:
    """The SVD algorithm for ``x``: cuSOLVER's ``gesvd`` (Householder
    bidiagonalization and QR iteration, LAPACK's accuracy) on a CUDA
    tensor, where PyTorch's default (Jacobi, ``gesvdj``) left 60-200-step
    convex solves at 160 x 160 2.6e-5 to 1.1e-4 away from the CPU's (on an
    H100); LAPACK (``None``) on the CPU."""
    return "gesvd" if x.is_cuda else None


def spectral_norm(x: Tensor) -> Tensor:
    """``||x||_2``, the largest singular value (``svd_driver``'s SVD)."""
    return torch.linalg.svdvals(x, driver=svd_driver(x))[..., 0]


def svt(x: Tensor, tau, full_matrices: bool = False
        ) -> tuple[Tensor, Tensor]:
    """Singular-value thresholding, the prox of ``tau ||.||_*``: returns
    ``(D_tau(x), the singular values after the threshold)``.  Only the
    convex baselines (APGM, IALM) call it: one thin SVD
    (``torch.linalg.svd``), O(m n min(m, n)), the centralized cost that
    DCF-PCA avoids.  On a CUDA tensor cuSOLVER's SVD synchronises with the
    host (it reads back its ``info``).  A batch (B, m, n) takes ``tau``
    (B,), one threshold a problem, in one batched call."""
    u, s, vt = torch.linalg.svd(x, full_matrices=full_matrices,
                                driver=svd_driver(x))
    if isinstance(tau, Tensor) and tau.ndim == 1:
        tau = tau[:, None]
    s_shrunk = torch.clamp_min(s - tau, 0.0)
    return (u * s_shrunk[..., None, :]) @ vt, s_shrunk


def huber_clip(x: Tensor, lam) -> Tensor:
    """Derivative of the Huber loss (Eq. 32): clip to ``[-lam, lam]``."""
    lam = torch.as_tensor(lam, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, -lam), lam)


def huber_loss(x: Tensor, lam, dim=None) -> Tensor:
    """Huber loss ``H_lam`` (Eq. 32) summed over all entries, or over
    ``dim`` (e.g. ``(-2, -1)`` for one sum per client block)."""
    a = x.abs()
    h = torch.where(a <= lam, 0.5 * x * x, lam * a - 0.5 * lam * lam)
    return h.sum() if dim is None else h.sum(dim=dim)


def masked_huber_loss(x: Tensor, lam, w: Tensor) -> Tensor:
    """Huber loss over observed entries only (``H_lam(0) == 0``)."""
    return huber_loss(w * x, lam)


def factored_objective(u, v, s, m, rho: float, lam: float, w=None) -> Tensor:
    """The nonconvex objective, Eq. (4):
    ``1/2 ||U V^T + S - M||_F^2 + rho/2 (||U||_F^2 + ||V||_F^2) + lam ||S||_1``
    (data-fit and l1 terms over observed entries when ``w`` is given)."""
    resid = u @ v.T + s - m
    if w is not None:
        resid = w * resid
        s = w * s
    return (0.5 * (resid * resid).sum()
            + 0.5 * rho * ((u * u).sum() + (v * v).sum())
            + lam * s.abs().sum())


def eliminated_objective(u, v, m, rho: float, lam: float, w=None) -> Tensor:
    """Objective with S eliminated (Eq. 17), plus ``rho/2 ||U||_F^2``."""
    resid = m - u @ v.T
    if w is not None:
        resid = w * resid
    return huber_loss(resid, lam) + 0.5 * rho * ((v * v).sum() + (u * u).sum())


def spectral_norm_ub_gram(g: Tensor, iters: int = 8) -> Tensor:
    """``sigma_max^2`` estimate from Gram matrices ``g`` (..., r, r) by power
    iteration, with a 1.01 safety factor; returns shape ``g.shape[:-2]``."""
    r = g.shape[-1]
    x = torch.ones(g.shape[:-1], dtype=g.dtype, device=g.device) / math.sqrt(r)
    for _ in range(iters):
        y = (g @ x[..., None])[..., 0]
        x = y / (torch.linalg.vector_norm(y, dim=-1, keepdim=True) + 1e-30)
    gx = (g @ x[..., None])[..., 0]
    return 1.01 * (x * gx).sum(-1) / (x * x).sum(-1)


def spectral_norm_ub(u: Tensor, iters: int = 8) -> Tensor:
    """Upper estimate of ``sigma_max(U)^2`` by power iteration on the
    r x r Gram matrix ``U^T U`` (leading batch axes allowed)."""
    return spectral_norm_ub_gram(u.transpose(-1, -2) @ u, iters)
