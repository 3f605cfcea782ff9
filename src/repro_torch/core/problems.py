"""Synthetic RPCA problems and the column split of the distributed data
model (counterpart of ``repro.core.problems``, Sec. 4.1).

``L0 = U0 V0^T`` with standard-Gaussian factors plus a sparse corruption
``S0`` with ``round(s m n)`` nonzeros of magnitude ``sqrt(m n)``, and an
optional observation mask.  Random numbers are drawn on the CPU from a
``torch.Generator`` seeded by the caller, then moved to ``device``: a seed
gives the same problem on every device (but not the numbers of
``jax.random``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bitmask import pack_mask, unpack_mask  # noqa: F401

Tensor = torch.Tensor


@dataclass(frozen=True)
class RPCAProblem:
    """A generated RPCA instance and its ground truth."""

    m_obs: Tensor  # observed matrix M = P_Omega(L0 + S0), (m, n)
    l0: Tensor  # ground-truth low-rank component, (m, n)
    s0: Tensor  # ground-truth sparse component (observed support), (m, n)
    rank: int
    sparsity: float
    mask: Tensor | None = None  # 0/1 fp32 observation mask Omega, (m, n)


def generator(seed: int | torch.Generator | None) -> torch.Generator:
    """A CPU generator: ``seed`` (default 0) or the generator itself."""
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator().manual_seed(0 if seed is None else int(seed))


def generate_mask(
    seed: int | torch.Generator | None,
    m: int,
    n: int,
    observed_frac: float,
    kind: Literal["uniform", "columns"] = "uniform",
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """A 0/1 observation mask (on the CPU) with ``observed_frac`` of the
    entries kept.

    ``uniform``  iid Bernoulli(observed_frac) over entries.
    ``columns``  every column loses one contiguous (cyclic) run of
                 ``round((1 - p) m)`` rows from a random offset, so every
                 column keeps the same count and none is empty.
    """
    gen = generator(seed)
    if kind == "uniform":
        return (torch.rand(m, n, generator=gen) < observed_frac).to(dtype)
    if kind == "columns":
        miss = int(round((1.0 - observed_frac) * m))
        starts = torch.randint(0, m, (n,), generator=gen)
        offset = torch.remainder(torch.arange(m)[:, None] - starts[None, :], m)
        return (offset >= miss).to(dtype)
    raise ValueError(f"unknown mask kind {kind!r}")


def generate_problem(
    seed: int | torch.Generator | None,
    m: int,
    n: int,
    rank: int,
    sparsity: float,
    *,
    observed_frac: float = 1.0,
    mask_kind: Literal["uniform", "columns"] = "uniform",
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> RPCAProblem:
    """Generate a problem per Sec. 4.1 on ``device`` (the card unless
    ``"cpu"`` is asked for):
    ``L0 = U0 V0^T`` with U0, V0 ~ N(0, 1) and ``round(s m n)`` corrupted
    entries, placed uniformly without replacement, each ``+-sqrt(m n)``.

    ``observed_frac < 1`` hides entries behind a mask (:func:`generate_mask`,
    drawn after everything else, so the unmasked part is the problem of
    the same seed at ``observed_frac = 1``): ``m_obs`` and ``s0`` are zero
    on the hidden entries and ``mask`` records Omega (fp32).
    ``dtype=torch.bfloat16`` stores ``m_obs``, ``l0`` and ``s0`` in bf16
    (computed in fp32, then rounded)."""
    device = resolve_device(device)
    gen = generator(seed)
    u0 = torch.randn(m, rank, generator=gen)
    v0 = torch.randn(n, rank, generator=gen)
    nnz = int(round(sparsity * m * n))
    flat_idx = torch.randperm(m * n, generator=gen)[:nnz]
    signs = torch.randint(0, 2, (nnz,), generator=gen).to(torch.float32) * 2 - 1
    mag = math.sqrt(float(m) * float(n))
    s0 = torch.zeros(m * n)
    s0[flat_idx] = signs * mag
    l0 = u0.to(device) @ v0.to(device).T
    s0 = s0.reshape(m, n).to(device)
    if observed_frac >= 1.0:
        return RPCAProblem(m_obs=(l0 + s0).to(dtype), l0=l0.to(dtype),
                           s0=s0.to(dtype), rank=rank, sparsity=sparsity)
    omega = generate_mask(gen, m, n, observed_frac, mask_kind).to(device)
    return RPCAProblem(m_obs=(omega * (l0 + s0)).to(dtype), l0=l0.to(dtype),
                       s0=(omega * s0).to(dtype), rank=rank,
                       sparsity=sparsity, mask=omega)


def client_column_counts(n: int, num_clients: int) -> tuple[int, ...]:
    """True per-client column counts under the padded contiguous split:
    blocks of ``ceil(n/E)`` columns, the zero padding on the last client(s)."""
    ni = -(-n // num_clients)
    return tuple(min(ni, max(0, n - i * ni)) for i in range(num_clients))


def split_columns(mat: Tensor, num_clients: int) -> Tensor:
    """Split ``(m, n)`` into column blocks stacked as ``(E, m, ceil(n/E))``,
    zero-padding a ragged tail.  Returns a view (not contiguous for E > 1):
    callers that feed kernels make it contiguous once."""
    m, n = mat.shape
    ni = -(-n // num_clients)
    pad = ni * num_clients - n
    if pad:
        mat = torch.nn.functional.pad(mat, (0, pad))
    return mat.reshape(m, num_clients, ni).movedim(1, 0)


def merge_columns(blocks: Tensor, n: int | None = None) -> Tensor:
    """Inverse of :func:`split_columns`: ``(E, m, ni) -> (m, n)``, or
    ``(B, E, m, ni) -> (B, m, n)`` for a batch, trimming the padding to
    ``n`` columns when given."""
    e, m, ni = blocks.shape[-3:]
    merged = blocks.movedim(-3, -2).reshape(*blocks.shape[:-3], m, e * ni)
    return merged if n is None else merged[..., :n]


def participation_schedule(
    seed: int | torch.Generator | None,
    rounds: int,
    num_clients: int,
    rate: float,
    dtype: torch.dtype = torch.float32,
) -> Tensor:
    """A ``(rounds, E)`` 0/1 Bernoulli(``rate``) participation schedule, on
    the CPU from ``seed`` (or a ``torch.Generator``).

    Every round keeps at least one participant: in a round where every
    client dropped out, one uniformly chosen client is forced on (an empty
    round would freeze U and read as convergence to the early exits).  The
    reference's rule; its ``jax.random`` draw is not reproduced.
    """
    gen = generator(seed)
    draw = torch.rand(rounds, num_clients, generator=gen) < float(rate)
    forced = torch.randint(0, num_clients, (rounds,), generator=gen)
    empty = ~draw.any(dim=1, keepdim=True)
    draw = draw | (empty & (torch.arange(num_clients)[None, :]
                            == forced[:, None]))
    return draw.to(dtype)
