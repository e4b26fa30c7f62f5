"""Multi-period + multi-scale discriminator ensemble (reference models.py:170-257).

Counterpart of ``smart_vocoder_tpu/models/discriminator.py``. Waveforms are
channel-first ``(B, 1, samples)``, as the reference's; each discriminator
returns ``(logits (B, n), fmaps)`` with channel-first feature maps (``(B, C,
H, p)`` for a period discriminator, ``(B, C, T)`` for the scale one), and the
ensemble returns per-discriminator lists for the real and generated inputs,
the structure the losses take. Parameter names follow the reference
(``discriminators.1.convs.0.weight_v``), so the JAX tree crosses through
``utils.torch_compat`` and a reference ``D_*.pth`` loads unchanged.

The JAX package's ``fold_period`` and ``pack_grouped`` are TPU layout choices
over the same parameters and math; the port runs cuDNN's strided and grouped
convolutions directly.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from smart_vocoder_torch.nn.conv import LRELU_SLOPE, Conv1d, Conv2d, get_padding

PERIODS = (2, 3, 5, 7, 11)  # reference models.py:238


class DiscriminatorP(nn.Module):
    """Period discriminator: fold time into ``(T/p, p)`` (reflect-padded to a
    multiple of ``p``) and convolve along ``T/p`` with ``(k, 1)`` kernels
    (ref: models.py:170-204). ``width_mult`` scales the channel counts."""

    def __init__(self, period: int, kernel_size: int = 5, stride: int = 3,
                 width_mult: float = 1.0, use_spectral_norm: bool = False, device=None):
        super().__init__()
        self.period = period
        sn = use_spectral_norm
        pad = get_padding(kernel_size, 1)
        self.convs = nn.ModuleList()
        cin = 1
        for i, ch in enumerate([32, 128, 512, 1024, 1024]):
            ch = max(4, int(ch * width_mult))
            self.convs.append(Conv2d(cin, ch, (kernel_size, 1), (stride if i < 4 else 1, 1),
                                     (pad, 0), weight_norm=not sn, spectral_norm=sn,
                                     device=device))
            cin = ch
        self.conv_post = Conv2d(cin, 1, (3, 1), (1, 1), (1, 0), weight_norm=not sn,
                                spectral_norm=sn, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        b, c, t = x.shape
        if t % self.period:
            x = F.pad(x, (0, self.period - t % self.period), mode="reflect")
        # (B, 1, T) -> (B, 1, T/p, p): the JAX package's (B, T/p, p, 1) in NCHW
        x = x.reshape(b, c, -1, self.period)
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(b, -1), fmap


class DiscriminatorS(nn.Module):
    """Scale discriminator on the raw waveform: grouped strided 1-D convs
    (ref: models.py:207-232). Groups are reduced to gcd(groups, in, out),
    which leaves the reference widths unchanged."""

    SPECS = (  # (features, kernel, stride, groups, padding), models.py:211-218
        (16, 15, 1, 1, 7),
        (64, 41, 4, 4, 20),
        (256, 41, 4, 16, 20),
        (1024, 41, 4, 64, 20),
        (1024, 41, 4, 256, 20),
        (1024, 5, 1, 1, 2),
    )

    def __init__(self, width_mult: float = 1.0, use_spectral_norm: bool = False,
                 device=None):
        super().__init__()
        sn = use_spectral_norm
        self.convs = nn.ModuleList()
        cin = 1
        for ch, k, s, g, p in self.SPECS:
            ch = max(8, int(ch * width_mult))
            g = math.gcd(math.gcd(g, cin), ch)
            self.convs.append(Conv1d(cin, ch, k, padding=p, stride=s, groups=g,
                                     weight_norm=not sn, spectral_norm=sn, device=device))
            cin = ch
        self.conv_post = Conv1d(cin, 1, 3, padding=1, weight_norm=not sn,
                                spectral_norm=sn, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        fmap = []
        for conv in self.convs:
            x = F.leaky_relu(conv(x), LRELU_SLOPE)
            fmap.append(x)
        x = self.conv_post(x)
        fmap.append(x)
        return x.reshape(x.shape[0], -1), fmap


class MultiPeriodDiscriminator(nn.Module):
    """1 x DiscriminatorS + DiscriminatorP per period (ref: models.py:235-257).
    ``use_spectral_norm`` swaps weight norm for spectral norm on every conv
    (models.py:175, :210)."""

    def __init__(self, use_spectral_norm: bool = False, width_mult: float = 1.0,
                 periods: Sequence[int] = PERIODS, device=None):
        super().__init__()
        self.use_spectral_norm = use_spectral_norm
        self.discriminators = nn.ModuleList(
            [DiscriminatorS(width_mult, use_spectral_norm, device=device)]
            + [DiscriminatorP(p, width_mult=width_mult, use_spectral_norm=use_spectral_norm,
                              device=device) for p in periods])

    def forward(self, y: torch.Tensor, y_hat: torch.Tensor):
        """y, y_hat: (B, 1, samples) -> (y_d_rs, y_d_gs, fmap_rs, fmap_gs).

        Without spectral norm, equal shapes run as one doubled batch per
        discriminator (the same per-row math, half the launches), as the JAX
        package does. Under spectral norm each input runs its own forward, so
        ``u`` advances twice per call, as torch's hook and JAX advance it."""
        y_d_rs, y_d_gs, fmap_rs, fmap_gs = [], [], [], []
        if not self.use_spectral_norm and y.shape == y_hat.shape:
            b = y.shape[0]
            both = torch.cat([y, y_hat], dim=0)
            for d in self.discriminators:
                logits, fmaps = d(both)
                y_d_rs.append(logits[:b])
                y_d_gs.append(logits[b:])
                fmap_rs.append([f[:b] for f in fmaps])
                fmap_gs.append([f[b:] for f in fmaps])
            return y_d_rs, y_d_gs, fmap_rs, fmap_gs
        for d in self.discriminators:
            y_d_r, fmap_r = d(y)
            y_d_g, fmap_g = d(y_hat)
            y_d_rs.append(y_d_r)
            y_d_gs.append(y_d_g)
            fmap_rs.append(fmap_r)
            fmap_gs.append(fmap_g)
        return y_d_rs, y_d_gs, fmap_rs, fmap_gs
