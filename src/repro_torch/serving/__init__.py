"""Serving of the port: batched LM generation (``serving.engine``), the
slot-based RPCA service (``serving.rpca_service``), the async gateway in
front of it (``serving.gateway``) and their host-side parts
(``serving.pages``, ``serving.metrics``)."""
from repro_torch.serving.gateway import GatewayConfig, RPCAGateway, Ticket
from repro_torch.serving.metrics import (
    LatencyWindow, OutcomeCounter, RateMeter,
)
from repro_torch.serving.pages import PageEntry, PagePool, PageTable
from repro_torch.serving.rpca_service import (
    RPCAResponse, RPCAService, RPCAServiceConfig,
)

__all__ = [
    "GatewayConfig",
    "LatencyWindow",
    "OutcomeCounter",
    "PageEntry",
    "PagePool",
    "PageTable",
    "RPCAGateway",
    "RPCAResponse",
    "RPCAService",
    "RPCAServiceConfig",
    "RateMeter",
    "Ticket",
]
