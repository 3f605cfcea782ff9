"""The front door for the ported solvers (counterpart of ``repro.rpca``):
methods ``"cf"`` and ``"dcf"``; ``method="auto"`` picks by the reference's
rules (:func:`auto_method`).

    from repro_torch import rpca
    res = rpca.solve(m_obs, method="dcf", cfg=DCFConfig.tuned(150),
                     num_clients=10)            # on the card
    res = rpca.solve(m_obs, method="cf", rank=8, device="cpu")

A solve runs on the CUDA card unless ``device="cpu"`` is passed; with no
card and no device named it raises.  ``dtype=torch.bfloat16`` stores M as
the compact bf16 plane (results stay fp32); with ``DCFConfig(pack_mask=True,
fused="dual")`` it is the compact data plane of the reference.  The other
methods of the reference (the convex solvers, the sharded engine), batched
problems, participation schedules and fault injection wait for later slices
(``ROADMAP.md``) and raise.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

import torch

from repro_torch.core import cf_pca, dcf_pca
from repro_torch.core import runtime as rt
from repro_torch.core import validate
from repro_torch.core.factorized import DCFConfig
from repro_torch.device import resolve_device

METHODS = ("cf", "dcf")
#: One SVD of an (m, n) problem costs about m n min(m, n) flops; past this,
#: ``method="auto"`` picks the SVD-free ``"cf"`` when a rank is known (the
#: reference's ``repro.rpca.SVD_COST_THRESHOLD``).
SVD_COST_THRESHOLD = 1 << 26
#: The reference's methods that take each feature (its ``methods_with``),
#: named in the refusals so that they read as the reference's.
_METHODS_WITH = {
    "supports_clients": ("dcf",),
    "supports_participation": ("dcf", "dcf_sharded"),
    "supports_robust_agg": ("dcf", "dcf_sharded"),
}


@dataclass(frozen=True)
class RPCASpec:
    """One RPCA problem: ``m_obs`` (m, n), an optional 0/1 ``mask``, the
    target ``rank`` (when no cfg is passed), the client count
    ``num_clients`` for ``"dcf"``, warm factors ``(U, V)``, and ``key``,
    the seed (or ``torch.Generator``) of the random factor init (default
    0).  ``dtype`` casts ``m_obs`` (fp32 or bf16).  ``participation`` and
    ``faults`` are not ported yet."""

    m_obs: Any
    mask: Any = None
    rank: int | None = None
    num_clients: int | None = None
    participation: Any = None
    warm: tuple[Any, Any] | None = None
    key: int | torch.Generator | None = None
    dtype: torch.dtype | None = None
    faults: Any = None

    @property
    def batched(self) -> bool:
        return len(self.m_obs.shape) == 3

    @property
    def shape(self) -> tuple[int, int]:
        """The per-problem ``(m, n)`` shape (batch axis stripped)."""
        return tuple(self.m_obs.shape[-2:])

    def validate(self) -> None:
        nd = len(self.m_obs.shape)
        if nd not in (2, 3):
            raise ValueError(
                f"m_obs must be (m, n) or (B, m, n); got ndim={nd}"
            )
        validate.check_mask(self.mask, tuple(self.m_obs.shape))
        if self.warm is not None:
            validate.check_warm_pair(self.warm)


@dataclass(frozen=True)
class RPCAResult:
    """Uniform solve result: components, factors, stats, the method."""

    l: torch.Tensor
    s: torch.Tensor
    u: torch.Tensor | None
    v: torch.Tensor | None
    stats: rt.SolveStats
    method: str
    spec: RPCASpec = field(repr=False)

    @property
    def factors(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        return None if self.u is None else (self.u, self.v)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} waits for a later slice of the port (ROADMAP.md)")


def _unsupported(name: str, feature: str, flag: str) -> ValueError:
    """The reference's refusal of a feature a method lacks (its
    ``repro.rpca._unsupported``), word for word."""
    return ValueError(
        f"method {name!r} does not support {feature}; methods with "
        f"{feature}: {', '.join(_METHODS_WITH[flag])}"
    )


def _is_lowp(dtype: Any) -> bool:
    return dtype in (torch.bfloat16, torch.float16)


def auto_method(spec: RPCASpec, cfg: Any = None) -> str:
    """The method ``method="auto"`` picks, by the reference's rules
    (``repro.rpca.auto_method``), in its order:

    1. a device mesh -> ``"dcf_sharded"``;
    2. a participation schedule or ``num_clients`` -> ``"dcf"``;
    3. a cfg that carries a rank -> ``"cf"``;
    4. a low-precision data plane -> ``"cf"`` (a rank is then required);
    5. a known rank and one SVD costlier than :data:`SVD_COST_THRESHOLD`
       flops -> ``"cf"``;
    6. otherwise ``"ialm"``.

    ``solve`` refuses ``"dcf_sharded"`` and ``"ialm"``: they wait for
    later slices (ROADMAP.md)."""
    if getattr(spec, "mesh", None) is not None:
        return "dcf_sharded"
    if spec.participation is not None or spec.num_clients is not None:
        return "dcf"
    if cfg is not None and getattr(cfg, "rank", None) is not None:
        return "cf"
    if _is_lowp(spec.m_obs.dtype):
        if spec.rank is None:
            raise ValueError(
                "a low-precision (bf16/f16) data plane needs a factorized "
                "method: set RPCASpec.rank (auto then picks 'cf') or cast "
                "m_obs to float32 for the convex solvers"
            )
        return "cf"
    m, n = spec.shape
    if spec.rank is not None and m * n * min(m, n) > SVD_COST_THRESHOLD:
        return "cf"
    return "ialm"


def solve(spec_or_matrix: RPCASpec | Any, method: str = "auto", *,
          run: rt.RunConfig | str | None = None, cfg: DCFConfig | None = None,
          device: torch.device | str | None = None,
          **spec_kwargs: Any) -> RPCAResult:
    """Solve one RPCA problem with ``"cf"`` or ``"dcf"`` on ``device``;
    ``"auto"`` picks by :func:`auto_method` and refuses, before solving,
    what it picks that is not ported."""
    if isinstance(spec_or_matrix, RPCASpec):
        if spec_kwargs:
            raise ValueError(
                "pass spec fields either in the RPCASpec or as keywords, "
                f"not both: {sorted(spec_kwargs)}"
            )
        spec = spec_or_matrix
    else:
        spec = RPCASpec(spec_or_matrix, **spec_kwargs)
    if spec.dtype is not None and spec.m_obs.dtype != spec.dtype:
        spec = replace(spec, m_obs=torch.as_tensor(spec.m_obs).to(spec.dtype))
    spec.validate()
    device = resolve_device(device)
    if spec.batched:
        raise _not_ported("batched solves")
    run_cfg = rt.resolve_run(run)
    if method == "auto":
        method = auto_method(spec, cfg)
    if method not in METHODS:
        raise _not_ported(f"method {method!r} (ported: {', '.join(METHODS)})")
    if cfg is None:
        if spec.rank is None:
            raise ValueError(
                f"method {method!r} needs a target rank: set RPCASpec.rank "
                f"or pass cfg=DCFConfig(...)"
            )
        cfg = (DCFConfig.masked(spec.rank) if spec.mask is not None
               else DCFConfig.tuned(spec.rank))
    if not isinstance(cfg, DCFConfig):
        raise ValueError(
            f"method {method!r} takes a DCFConfig, got {type(cfg).__name__}"
        )
    if method == "cf":
        if spec.faults is not None:
            raise _unsupported("cf", "fault injection (no consensus "
                               "boundary)", "supports_robust_agg")
        if spec.num_clients is not None:
            raise _unsupported("cf", "simulated client topologies "
                               "(num_clients)", "supports_clients")
        if spec.participation is not None:
            raise _unsupported("cf", "participation schedules",
                               "supports_participation")
        res = cf_pca.cf_pca(spec.m_obs, cfg, spec.key, run=run_cfg,
                            warm=spec.warm, mask=spec.mask, device=device)
    else:
        if spec.num_clients is None:
            raise ValueError(
                "method 'dcf' needs a client count: set RPCASpec.num_clients"
            )
        res = dcf_pca.dcf_pca(
            spec.m_obs, cfg, spec.num_clients, spec.key, run=run_cfg,
            warm=spec.warm, mask=spec.mask, participation=spec.participation,
            faults=spec.faults, device=device,
        )
    return RPCAResult(l=res.l, s=res.s, u=res.u, v=res.v, stats=res.stats,
                      method=method, spec=spec)
