"""Where an entry point runs: the card, unless the caller names the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` means the CUDA card and raises where there is none; the CPU
    only when the caller says ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry point runs on the card by default; "
                           'pass device="cpu" to run on the CPU')
    return torch.device("cuda")
