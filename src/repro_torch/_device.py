"""Device resolution for the port's entry points.

Entry points run on the CUDA card by default.  Without a card they raise
rather than fall back: a caller who wants the CPU (the tests, a laptop)
asks for it with ``device="cpu"``.
"""
from __future__ import annotations

import torch


def has_cuda() -> bool:
    """Whether a CUDA card is visible to this process."""
    return torch.cuda.is_available()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless ``device`` says
    otherwise.  Raises when CUDA is asked for (explicitly or by default)
    and no card is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not has_cuda():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev
