"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when there is none (the port never falls back to the CPU on its
    own: pass ``device="cpu"`` to run the plain versions there)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda")
