"""Evaluation metrics (counterpart of ``repro.core.metrics``): Eq. (30),
the observed / unobserved split of the low-rank error, and paper Table 1's
spectrum metrics."""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.ops import svd_driver

Tensor = torch.Tensor


def relative_error(l: Tensor, s: Tensor, l0: Tensor, s0: Tensor) -> Tensor:
    """Eq. (30): ``(||L-L0||^2 + ||S-S0||^2) / (||L0||^2 + ||S0||^2)``."""
    num = ((l - l0) ** 2).sum() + ((s - s0) ** 2).sum()
    return num / ((l0 ** 2).sum() + (s0 ** 2).sum())


def low_rank_relative_error(l: Tensor, l0: Tensor) -> Tensor:
    """``||L - L0||_F / ||L0||_F``."""
    return torch.linalg.norm(l - l0) / torch.linalg.norm(l0)


class CompletionErrors(NamedTuple):
    """Relative Frobenius error of L on observed, unobserved and all entries
    (``unobserved`` is 0 when the mask is all ones)."""

    observed: Tensor
    unobserved: Tensor
    overall: Tensor


def _rel_norm(diff: Tensor, ref: Tensor) -> Tensor:
    den = torch.linalg.norm(ref)
    return torch.linalg.norm(diff) / torch.where(den > 0, den, 1.0)


def completion_errors(l: Tensor, l0: Tensor,
                      mask: Tensor | None = None) -> CompletionErrors:
    """Observed / unobserved / overall relative error of the L estimate."""
    overall = _rel_norm(l - l0, l0)
    if mask is None:
        return CompletionErrors(observed=overall,
                                unobserved=torch.zeros_like(overall),
                                overall=overall)
    obs = _rel_norm(mask * (l - l0), mask * l0)
    hid = _rel_norm((1.0 - mask) * (l - l0), (1.0 - mask) * l0)
    return CompletionErrors(observed=obs, unobserved=hid, overall=overall)


def singular_value_error(l: Tensor, l0: Tensor, rank: int) -> Tensor:
    """Table 1: ``max_i |sigma_i(L) - sigma_i(L0)| / sigma_r(L0)``, the
    spectra of the recovered and true matrices compared."""
    sv = torch.linalg.svdvals(l, driver=svd_driver(l))
    sv0 = torch.linalg.svdvals(l0, driver=svd_driver(l0))
    k = min(sv.shape[-1], sv0.shape[-1])
    return (sv[..., :k] - sv0[..., :k]).abs().amax(-1) / sv0[..., rank - 1]


def rank_gap(l: Tensor, rank: int) -> Tensor:
    """``sigma_{r+1}(L) / sigma_r(L)``: how sharply L has rank r."""
    sv = torch.linalg.svdvals(l, driver=svd_driver(l))
    return sv[..., rank] / sv[..., rank - 1]
