"""Residual-coupling flow step + channel flip (reference modules.py:270-343).

Counterpart of ``smart_vocoder_tpu/nn/coupling.py``, over ``(B, C, T)``. The
coupling layers of the model are mean-only (models.py:70); inference runs
them in reverse.
"""

from __future__ import annotations

import torch
from torch import nn

from smart_vocoder_torch.nn.conv import Conv1d
from smart_vocoder_torch.nn.wn import WN


def flip_channels(x: torch.Tensor) -> torch.Tensor:
    """Reverse the channel axis -- the Flip flow step, its own inverse."""
    return torch.flip(x, dims=(1,))


class Flip(nn.Module):
    """Parameter-free flow step; holds the odd ``flows.<i>`` slots."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return flip_channels(x)


class ResidualCouplingLayer(nn.Module):
    """Mean-only affine coupling: ``x1 <- x1 -/+ m(x0)``."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int,
                 dilation_rate: int, n_layers: int, gin_channels: int = 0,
                 conditioned: bool = False, weight_norm: bool = True, device=None):
        super().__init__()
        if channels % 2:
            raise ValueError("channels should be divisible by 2")
        self.half = channels // 2
        self.pre = Conv1d(self.half, hidden_channels, 1, device=device)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, conditioned=conditioned,
                      weight_norm=weight_norm, device=device)
        self.post = Conv1d(hidden_channels, self.half, 1, device=device)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None, reverse: bool = False) -> torch.Tensor:
        x0, x1 = x[:, : self.half], x[:, self.half :]
        h = self.pre(x0) * x_mask
        h = self.enc(h, x_mask, g=g)
        m = self.post(h) * x_mask
        x1 = (x1 - m) * x_mask if reverse else (m + x1) * x_mask
        return torch.cat([x0, x1], dim=1)
