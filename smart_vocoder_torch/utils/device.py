"""Where an entry point runs: the card, unless the caller names the CPU."""

from __future__ import annotations

import subprocess

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


def device_label(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or what the CPU run is."""
    if device.type != "cuda":
        return "cpu: host times, not a device measurement"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
