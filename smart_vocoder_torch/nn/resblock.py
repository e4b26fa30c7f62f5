"""HiFi-GAN multi-receptive-field ResBlocks (reference modules.py:187-256).

Counterpart of ``smart_vocoder_tpu/nn/resblock.py``, over ``(B, C, T)``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from smart_vocoder_torch.nn.conv import LRELU_SLOPE, Conv1d, get_padding


class ResBlock1(nn.Module):
    """3x (lrelu -> dilated conv -> lrelu -> conv) residual block."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3, 5), weight_norm: bool = True,
                 device=None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                   dilation=d, weight_norm=weight_norm, device=device)
            for d in dilation)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size),
                   weight_norm=weight_norm, device=device)
            for _ in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c1(F.leaky_relu(x, LRELU_SLOPE))
            xt = c2(F.leaky_relu(xt, LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """2x (lrelu -> dilated conv) residual block."""

    def __init__(self, channels: int, kernel_size: int = 3,
                 dilation: Sequence[int] = (1, 3), weight_norm: bool = True,
                 device=None):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                   dilation=d, weight_norm=weight_norm, device=device)
            for d in dilation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x
