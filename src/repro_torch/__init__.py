"""PyTorch and CUDA port of the DCF-PCA system (``repro`` is the JAX
reference).  Entry points run on the CUDA card unless ``device="cpu"`` is
passed.

``repro_torch.rpca``  the front door: :func:`repro_torch.rpca.solve` over
                      the solver registry, with ``RPCASpec`` /
                      ``RPCAResult``.
``repro_torch.core``  the solvers (runtime, problems, metrics, CF-PCA,
                      DCF-PCA, APGM, IALM), one problem or a batch.

The reference's serving plane (``RPCAGateway``, ``RPCAService`` and their
configs) is not ported yet (ROADMAP.md); its admission errors
``CapacityError`` and ``QueueFull`` are.
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
from repro_torch.core.validate import CapacityError, QueueFull

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
]
