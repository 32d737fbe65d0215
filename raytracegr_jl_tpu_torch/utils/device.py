"""Where the port's factories put their tensors."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device named, else the CUDA card. There is no quiet CPU
    fallback: without a card, a caller must ask for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to build on "
                           "the CPU")
    return torch.device("cuda")
