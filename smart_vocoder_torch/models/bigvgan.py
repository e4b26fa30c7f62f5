"""BigVGAN-v2's generator: the module graph, in float32, with the parameter
names of NVIDIA's ``bigvgan.py`` (``conv_pre``, ``ups.i.0``,
``resblocks.n.convs1/convs2/activations``, ``activation_post``,
``conv_post``); arXiv:2206.04658, github.com/NVIDIA/BigVGAN.

It is the eager oracle of the port's AMP route (``kernels/amp.py``), and what
``GeneratorVocoder`` checks and loads a state dict into before it packs the
weights for that route. The equations, channel-first
``(B, C, T)``:

- ``x = conv_pre(mel)``; each stage ``x = ups[i](x)`` (no activation before
  it), then ``x = mean_k AMP_k(x)`` over the kernel sizes;
- ``AMP_k``: for each dilation d, ``x = x + conv2(A2(conv1_d(A1(x))))``;
- ``A(x) = down2(SnakeBeta(up2(x)))`` (:func:`anti_aliased_snake`);
- the tail ``conv_post(activation_post(x))``, no bias, then a clamp to
  [-1, 1] without tanh (``use_tanh_at_final`` and ``use_bias_at_final``
  false, as BigVGAN-v2 is published).

Every conv has weight norm (``weight_g``/``weight_v``) unless built with
``weight_norm=False`` for folded weights. The resampling filters are fixed
(:func:`kaiser_sinc_filter`), held as non-persistent buffers: a published
checkpoint's ``*.filter`` entries are dropped at load (``drop_filters``).
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from smart_vocoder_torch.nn.conv import Conv1d, ConvTranspose1d, get_padding

SNAKE_EPS = 1e-9  # BigVGAN's no_div_by_zero
TAPS = 12         # up_kernel_size and down_kernel_size of Activation1d
RATIO = 2


def kaiser_sinc_filter(cutoff: float = 0.5 / RATIO, half_width: float = 0.6 / RATIO,
                       kernel_size: int = TAPS) -> torch.Tensor:
    """BigVGAN's ``kaiser_sinc_filter1d`` in float32, as a ``(kernel_size,)``
    tensor: a Kaiser window times ``2 c sinc(2 c t)`` at ``t = -5.5 ... 5.5``,
    normalised to sum 1 (even kernel sizes only)."""
    if kernel_size % 2:
        raise ValueError("the anti-aliasing filter has an even number of taps")
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * (4 * half_width) + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    t = torch.arange(-half, half) + 0.5
    f = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return f / f.sum()


def up2(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """BigVGAN's ``UpSample1d(2, 12)``: (B, C, T) -> (B, C, 2T)."""
    c, pad = x.shape[1], TAPS // RATIO - 1
    crop = pad * RATIO + (TAPS - RATIO) // 2
    x = F.pad(x, (pad, pad), mode="replicate")
    x = RATIO * F.conv_transpose1d(x, filt.view(1, 1, -1).expand(c, -1, -1), stride=RATIO,
                                   groups=c)
    return x[..., crop:-crop]


def down2(x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """BigVGAN's ``DownSample1d(2, 12)``: (B, C, 2T) -> (B, C, T)."""
    c = x.shape[1]
    x = F.pad(x, (TAPS // 2 - 1, TAPS // 2), mode="replicate")
    return F.conv1d(x, filt.view(1, 1, -1).expand(c, -1, -1), stride=RATIO, groups=c)


def snake_beta(y: torch.Tensor, a: torch.Tensor, ib: torch.Tensor) -> torch.Tensor:
    """``y + sin^2(a y) * ib`` with per-channel ``a = exp(log alpha)`` and
    ``ib = 1 / (exp(log beta) + 1e-9)``."""
    return y + torch.sin(y * a[:, None]) ** 2 * ib[:, None]


def snake_coefficients(log_alpha: torch.Tensor, log_beta: torch.Tensor):
    """SnakeBeta's ``(a, ib)`` from its log-scale parameters, in float32."""
    return torch.exp(log_alpha.float()), 1.0 / (torch.exp(log_beta.float()) + SNAKE_EPS)


def anti_aliased_snake(x: torch.Tensor, a: torch.Tensor, ib: torch.Tensor,
                       filt: torch.Tensor) -> torch.Tensor:
    """``down2(SnakeBeta(up2(x)))`` as torch's chain, in ``x``'s dtype."""
    return down2(snake_beta(up2(x, filt), a, ib), filt)


class SnakeBeta(nn.Module):
    """Per-channel log-scale ``alpha`` and ``beta`` (``snake_logscale``)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))


class Activation1d(nn.Module):
    """BigVGAN's ``Activation1d(SnakeBeta)``: up2, SnakeBeta, down2."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.act = SnakeBeta(channels, device)
        self.register_buffer("filter", kaiser_sinc_filter().to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, ib = snake_coefficients(self.act.alpha, self.act.beta)
        return anti_aliased_snake(x, a.to(x.dtype), ib.to(x.dtype), self.filter.to(x.dtype))


class AMPBlock1(nn.Module):
    def __init__(self, channels: int, kernel_size: int, dilations: Sequence[int],
                 weight_norm: bool, device=None):
        super().__init__()
        self.convs1 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size, d),
                   dilation=d, weight_norm=weight_norm, device=device) for d in dilations)
        self.convs2 = nn.ModuleList(
            Conv1d(channels, channels, kernel_size, padding=get_padding(kernel_size),
                   weight_norm=weight_norm, device=device) for _ in dilations)
        self.activations = nn.ModuleList(
            Activation1d(channels, device) for _ in range(2 * len(dilations)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acts = self.activations
        for c1, c2, a1, a2 in zip(self.convs1, self.convs2, acts[::2], acts[1::2]):
            x = c2(a2(c1(a1(x)))) + x
        return x


class BigVGAN(nn.Module):
    """mel ``(B, n_mels, T)`` -> waveform ``(B, 1, T * prod(upsample_rates))``."""

    def __init__(self, n_mels: int, upsample_rates: Sequence[int],
                 upsample_kernel_sizes: Sequence[int], upsample_initial_channel: int,
                 resblock_kernel_sizes: Sequence[int],
                 resblock_dilation_sizes: Sequence[Sequence[int]], weight_norm: bool = True,
                 device=None):
        super().__init__()
        c0 = upsample_initial_channel
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(n_mels, c0, 7, padding=3, weight_norm=weight_norm, device=device)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = c0 // 2 ** (i + 1)
            self.ups.append(nn.ModuleList([ConvTranspose1d(
                2 * ch, ch, k, u, padding=(k - u) // 2, weight_norm=weight_norm,
                device=device)]))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(AMPBlock1(ch, rk, rd, weight_norm, device))
        ch = c0 // 2 ** len(upsample_rates)
        self.activation_post = Activation1d(ch, device)
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False, weight_norm=weight_norm,
                                device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = self.conv_pre(mel)
        nk = self.num_kernels
        for i, up in enumerate(self.ups):
            x = up[0](x)
            xs = None
            for j in range(nk):
                y = self.resblocks[i * nk + j](x)
                xs = y if xs is None else xs + y
            x = xs / nk
        x = self.conv_post(self.activation_post(x))
        return torch.clamp(x, -1.0, 1.0)


def build_bigvgan(hps, weight_norm: bool = True, device=None) -> BigVGAN:
    """The generator of a ``model.kind: "bigvgan"`` config."""
    m = hps.model
    return BigVGAN(hps.data.n_mel_channels, tuple(m.upsample_rates),
                   tuple(m.upsample_kernel_sizes), m.upsample_initial_channel,
                   tuple(m.resblock_kernel_sizes),
                   tuple(tuple(d) for d in m.resblock_dilation_sizes),
                   weight_norm=weight_norm, device=device)


def drop_filters(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """A state dict without the fixed resampling filters a published
    checkpoint carries (``...upsample.filter``, ``...downsample.lowpass.filter``)."""
    return {k: v for k, v in state_dict.items() if not k.endswith(".filter")}
