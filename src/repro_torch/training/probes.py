"""Activation-outlier RPCA probe, as ``repro/training/probes.py``.

A hidden-state matrix X (d_model x tokens) splits into low-rank structure
(the features the layer uses) plus sparse outliers (the heavy-hitter
activations that break quantization).  The tokens are the paper's
column-split "n": ``num_clients`` simulated clients, each a block of
tokens, run DCF-PCA (``core.dcf_pca``); on the card its rounds launch
``huber_contract_v`` and ``huber_contract_u_diag``, and its finalize one
``residual_shrink``.

    stats = activation_probe(hidden, rank=8)
    stats["outlier_fraction"], stats["energy_low_rank"], ...
"""
from __future__ import annotations

import torch

from repro_torch.core.dcf_pca import dcf_pca
from repro_torch.core.factorized import DCFConfig

Tensor = torch.Tensor


@torch.no_grad()
def activation_probe(hidden: Tensor, rank: int = 8, num_clients: int = 8,
                     outer_iters: int = 40) -> dict[str, Tensor]:
    """Split ``hidden`` (..., tokens, d_model; leading dims flattened) into
    low-rank plus sparse on its device, in fp32, the tokens trimmed to a
    multiple of ``num_clients``; returns the energy shares of L and S, the
    fraction of nonzero S, the 8 channels (rows) with the most S energy and
    the residual share, as device tensors."""
    x = hidden.reshape(-1, hidden.shape[-1]).to(torch.float32).T
    t = x.shape[1]
    x = x[:, :(t // num_clients) * num_clients]
    cfg = DCFConfig.tuned(rank, outer_iters=outer_iters)
    res = dcf_pca(x, cfg, num_clients=num_clients, device=x.device)

    total = torch.sum(x * x) + 1e-30
    e_low = torch.sum(res.l * res.l) / total
    e_sparse = torch.sum(res.s * res.s) / total
    nnz = torch.mean((res.s.abs() > 0).to(torch.float32))
    row_energy = torch.sum(res.s * res.s, dim=1)
    return {
        "energy_low_rank": e_low,
        "energy_sparse": e_sparse,
        "outlier_fraction": nnz,
        "top_outlier_channels": torch.argsort(-row_energy, stable=True)[:8],
        "residual": 1.0 - e_low - e_sparse,
    }
