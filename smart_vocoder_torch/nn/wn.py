"""WN: the WaveNet-style gated dilated-conv stack (reference modules.py:111-184).

Counterpart of ``smart_vocoder_tpu/nn/wn.py``. Per layer: dilated conv
``H -> 2H`` (+ the layer's slice of the speaker conditioning) ->
``tanh(a) * sigmoid(b)`` -> 1x1 res/skip conv; the residual half feeds the
next layer, the skip halves are summed. ``cond_layer`` exists only for a
speaker-conditioned model, as in the JAX package (which creates it only when
init sees a speaker embedding).
"""

from __future__ import annotations

import torch
from torch import nn

from smart_vocoder_torch.nn.conv import Conv1d


def gated_activation(x: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
    """``tanh(x[:, :H]) * sigmoid(x[:, H:])`` with optional additive conditioning
    (the reference's ``fused_add_tanh_sigmoid_multiply``, commons.py:100-107)."""
    if g is not None:
        x = x + g
    h = x.shape[1] // 2
    return torch.tanh(x[:, :h]) * torch.sigmoid(x[:, h:])


class WN(nn.Module):
    """Gated dilated-conv stack over ``(B, H, T)``."""

    def __init__(self, hidden_channels: int, kernel_size: int, dilation_rate: int,
                 n_layers: int, gin_channels: int = 0, conditioned: bool = False,
                 weight_norm: bool = True, device=None):
        super().__init__()
        h = hidden_channels
        self.hidden_channels = h
        self.n_layers = n_layers
        self.in_layers = nn.ModuleList()
        self.res_skip_layers = nn.ModuleList()
        for i in range(n_layers):
            dilation = dilation_rate ** i
            padding = int((kernel_size * dilation - dilation) / 2)
            self.in_layers.append(Conv1d(h, 2 * h, kernel_size, padding=padding,
                                         dilation=dilation, weight_norm=weight_norm,
                                         device=device))
            # the last layer needs no residual half (modules.py:138-142)
            out = 2 * h if i < n_layers - 1 else h
            self.res_skip_layers.append(Conv1d(h, out, 1, weight_norm=weight_norm,
                                               device=device))
        self.cond_layer = (Conv1d(gin_channels, 2 * h * n_layers, 1,
                                  weight_norm=weight_norm, device=device)
                           if conditioned else None)

    def forward(self, x: torch.Tensor, x_mask: torch.Tensor,
                g: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, H, T); x_mask: (B, 1, T); g: (B, gin, 1) or None."""
        h = self.hidden_channels
        output = torch.zeros_like(x)
        if g is not None:
            if self.cond_layer is None:
                raise ValueError("speaker conditioning passed to an unconditioned WN")
            g = self.cond_layer(g)
        for i in range(self.n_layers):
            g_l = None if g is None else g[:, i * 2 * h : (i + 1) * 2 * h]
            acts = gated_activation(self.in_layers[i](x), g_l)
            res_skip = self.res_skip_layers[i](acts)
            if i < self.n_layers - 1:
                x = (x + res_skip[:, :h]) * x_mask
                output = output + res_skip[:, h:]
            else:
                output = output + res_skip
        return output * x_mask
