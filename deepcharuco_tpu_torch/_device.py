"""The port's device rule, shared by every entry point: ``None`` means the
card, and asking for the card where there is none raises."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` → the card. A CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port's plain versions on the CPU")
    return dev
