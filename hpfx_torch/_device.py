"""Where the port's loaders put their tensors: the CUDA card unless the
caller names another device."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises ``RuntimeError`` for ``None`` when no card is present, so a
    run never falls back to the CPU unasked: pass ``device="cpu"`` to
    run on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hpfx_torch puts its data on the CUDA card by default and no "
            "card is available: pass device='cpu' to run on the CPU")
    return torch.device("cuda")
