"""PyTorch and CUDA port of the DCF-PCA system (``repro`` is the JAX
reference).  Entry points run on the CUDA card unless ``device="cpu"`` is
passed.

``repro_torch.rpca``     the front door: :func:`repro_torch.rpca.solve`
                         over the solver registry, with ``RPCASpec`` /
                         ``RPCAResult``.
``repro_torch.core``     the solvers (runtime, problems, metrics, CF-PCA,
                         DCF-PCA, APGM, IALM), one problem or a batch.
``repro_torch.serving``  the serving plane: ``RPCAGateway`` (the async
                         continuous-batching front end) over
                         ``RPCAService`` (the slot table), with the
                         ``CapacityError`` / ``QueueFull`` admission
                         errors, and dense-LM generation.  Lazy, as in the
                         reference: importing ``repro_torch`` does not pull
                         in the serving stack.
"""
from repro_torch import rpca
from repro_torch.rpca import (
    RPCAResult,
    RPCASpec,
    SOLVERS,
    SolverCaps,
    auto_method,
    register_solver,
    solve,
)

__all__ = [
    "rpca",
    "RPCAResult",
    "RPCASpec",
    "SOLVERS",
    "SolverCaps",
    "auto_method",
    "register_solver",
    "solve",
    "CapacityError",
    "QueueFull",
    "GatewayConfig",
    "RPCAGateway",
    "RPCAService",
    "RPCAServiceConfig",
]

_SERVING_EXPORTS = {
    "CapacityError": ("repro_torch.core.validate", "CapacityError"),
    "QueueFull": ("repro_torch.core.validate", "QueueFull"),
    "GatewayConfig": ("repro_torch.serving.gateway", "GatewayConfig"),
    "RPCAGateway": ("repro_torch.serving.gateway", "RPCAGateway"),
    "RPCAService": ("repro_torch.serving.rpca_service", "RPCAService"),
    "RPCAServiceConfig": ("repro_torch.serving.rpca_service",
                          "RPCAServiceConfig"),
}


def __getattr__(name: str):
    target = _SERVING_EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module 'repro_torch' has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = value  # later lookups skip __getattr__
    return value


def __dir__():
    return sorted(set(globals()) | set(_SERVING_EXPORTS))
