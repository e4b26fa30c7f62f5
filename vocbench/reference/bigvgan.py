"""The plain reference of BigVGAN-v2's generator (NVIDIA BigVGAN
``bigvgan.py``, ``activations.py``, ``alias_free_activation/torch``;
arXiv:2206.04658), in float32, and what ``Vocoder.mel_to_wav`` returns for a
batch call of it.

Plain ``torch`` over a flat dict of tensors named as BigVGAN's state dict with
the weight norms folded; it imports nothing of the program and sets no
precision itself: the caller turns TF32 off (``compare.reference_precision``).
Every model convolution goes through ``graph.Numerics.conv``, so
``Numerics("fp8")`` is the control (both operands of each conv rounded to
float8 e4m3); the activations' resampling filters are not model convolutions
and stay float32 in both. The equations, channel-first ``(B, C, T)``:

- ``x = conv_pre(mel)`` (k 7, pad 3); each stage ``x = ups[i](x)``
  (transposed, kernel K, stride u, pad (K - u) / 2, no activation before it),
  then ``x = mean_k AMP_k(x)`` over the kernel sizes 3, 7, 11;
- ``AMP_k``: for each dilation d in (1, 3, 5), ``x = x + conv2(A2(conv1_d(A1(x))))``,
  ``conv1`` dilated by d with pad d (k - 1) / 2, ``conv2`` undilated;
- ``A(x) = down2(SnakeBeta(up2(x)))``: ``up2`` replicate-pads by 5, takes
  ``2 conv_transpose1d(., f, stride 2, groups C)`` and crops 15 each side;
  ``SnakeBeta(y) = y + sin^2(e^alpha y) / (e^beta + 1e-9)`` per channel;
  ``down2`` replicate-pads by 5 and 6 and takes ``conv1d(., f, stride 2, groups C)``;
  ``f`` is ``kaiser_sinc_filter1d(0.25, 0.3, 12)``;
- the tail ``clamp(conv_post(A_post(x)), -1, 1)``, ``conv_post`` without bias.

A batch call pads every row to the program's next bucket, decodes in blocks
of rows, and cuts each row to ``frames * hop`` samples.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from vocbench.reference.graph import F32, Numerics, Param
from vocbench.reference.synthesis import bucket

TAPS = 12
SNAKE_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class Sizes:
    n_mels: int
    upsample_rates: tuple
    upsample_kernels: tuple
    upsample_initial: int
    res_kernels: tuple
    res_dilations: tuple
    hop: int

    @classmethod
    def from_config(cls, cfg: dict) -> "Sizes":
        m, d = cfg["model"], cfg["data"]
        if m.get("kind") != "bigvgan" or m.get("resblock") != "1":
            raise ValueError("the BigVGAN reference holds model.kind 'bigvgan', AMPBlock1")
        if m.get("activation") != "snakebeta" or not m.get("snake_logscale"):
            raise ValueError("the BigVGAN reference holds log-scale SnakeBeta only")
        if m.get("use_tanh_at_final") or m.get("use_bias_at_final"):
            raise ValueError("the BigVGAN reference holds BigVGAN-v2's clamped, biasless tail")
        return cls(n_mels=int(d["n_mel_channels"]), upsample_rates=tuple(m["upsample_rates"]),
                   upsample_kernels=tuple(m["upsample_kernel_sizes"]),
                   upsample_initial=int(m["upsample_initial_channel"]),
                   res_kernels=tuple(m["resblock_kernel_sizes"]),
                   res_dilations=tuple(tuple(x) for x in m["resblock_dilation_sizes"]),
                   hop=int(d["hop_length"]))


def generator_params(s: Sizes, log_scale_bound: float = 0.5) -> list[Param]:
    """Every leaf, in BigVGAN's order. SnakeBeta's log-alpha and log-beta are
    ``log_scale`` leaves whose ``fan_in`` makes them uniform in
    ``±log_scale_bound`` under ``vocbench.weights.make``."""
    out: list[Param] = []
    snake_fan_in = 1.0 / log_scale_bound ** 2

    def conv(name, cout, cin, k, bias=True):
        out.append(Param(f"{name}.weight", (cout, cin, k), cin * k, "weight"))
        if bias:
            out.append(Param(f"{name}.bias", (cout,), cin * k, "bias"))

    def snake(name, c):
        out.append(Param(f"{name}.act.alpha", (c,), snake_fan_in, "log_scale"))
        out.append(Param(f"{name}.act.beta", (c,), snake_fan_in, "log_scale"))

    c0 = s.upsample_initial
    conv("conv_pre", c0, s.n_mels, 7)
    for i, k in enumerate(s.upsample_kernels):
        ch = c0 // 2 ** (i + 1)
        out.append(Param(f"ups.{i}.0.weight", (2 * ch, ch, k), ch * k, "weight"))
        out.append(Param(f"ups.{i}.0.bias", (ch,), ch * k, "bias"))
    j = 0
    for i in range(len(s.upsample_kernels)):
        ch = c0 // 2 ** (i + 1)
        for rk, rd in zip(s.res_kernels, s.res_dilations):
            for n in range(len(rd)):
                conv(f"resblocks.{j}.convs1.{n}", ch, ch, rk)
            for n in range(len(rd)):
                conv(f"resblocks.{j}.convs2.{n}", ch, ch, rk)
            for m in range(2 * len(rd)):
                snake(f"resblocks.{j}.activations.{m}", ch)
            j += 1
    ch = c0 // 2 ** len(s.upsample_kernels)
    snake("activation_post", ch)
    conv("conv_post", 1, ch, 7, bias=False)
    return out


def param_count(params: list[Param]) -> int:
    return sum(math.prod(q.shape) for q in params)


def kaiser_sinc_filter(cutoff: float = 0.25, half_width: float = 0.3,
                       kernel_size: int = TAPS) -> torch.Tensor:
    """``kaiser_sinc_filter1d`` of BigVGAN (even ``kernel_size``), float32."""
    half = kernel_size // 2
    a = 2.285 * (half - 1) * math.pi * 4 * half_width + 7.95
    beta = (0.1102 * (a - 8.7) if a > 50.0
            else 0.5842 * (a - 21) ** 0.4 + 0.07886 * (a - 21.0) if a >= 21.0 else 0.0)
    window = torch.kaiser_window(kernel_size, beta=beta, periodic=False)
    t = torch.arange(-half, half) + 0.5
    f = 2 * cutoff * window * torch.sinc(2 * cutoff * t)
    return f / f.sum()


def activation(p, name: str, x: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """``down2(SnakeBeta(up2(x)))`` of the activation ``name``."""
    c = x.shape[1]
    w = filt.to(x.device).view(1, 1, -1).expand(c, -1, -1)
    y = F.pad(x, (5, 5), mode="replicate")
    y = 2 * F.conv_transpose1d(y, w, stride=2, groups=c)[..., 15:-15]
    alpha = torch.exp(p[f"{name}.act.alpha"].float())[:, None]
    beta = torch.exp(p[f"{name}.act.beta"].float())[:, None]
    y = y + (1.0 / (beta + SNAKE_EPS)) * torch.sin(y * alpha) ** 2
    y = F.pad(y, (5, 6), mode="replicate")
    return F.conv1d(y, w, stride=2, groups=c)


def generator(p, s: Sizes, mel_ct: torch.Tensor, nx: Numerics = F32) -> torch.Tensor:
    """mel ``(B, n_mels, T)`` -> waveform ``(B, 1, T * hop)``."""
    filt = kaiser_sinc_filter()

    def conv(name, x, padding, dilation=1):
        return nx.conv(F.conv1d, x, p[f"{name}.weight"], p.get(f"{name}.bias"),
                       padding=padding, dilation=dilation)

    x = conv("conv_pre", mel_ct.float(), 3)
    nk = len(s.res_kernels)
    for i, (u, k) in enumerate(zip(s.upsample_rates, s.upsample_kernels)):
        x = nx.conv(F.conv_transpose1d, x, p[f"ups.{i}.0.weight"], p[f"ups.{i}.0.bias"],
                    stride=u, padding=(k - u) // 2)
        xs = None
        for j, (rk, rd) in enumerate(zip(s.res_kernels, s.res_dilations)):
            blk = f"resblocks.{i * nk + j}"
            y = x
            for n, d in enumerate(rd):
                t = activation(p, f"{blk}.activations.{2 * n}", y, filt)
                t = conv(f"{blk}.convs1.{n}", t, d * (rk - 1) // 2, d)
                t = activation(p, f"{blk}.activations.{2 * n + 1}", t, filt)
                t = conv(f"{blk}.convs2.{n}", t, (rk - 1) // 2)
                y = t + y
            xs = y if xs is None else xs + y
        x = xs / nk
    x = conv("conv_post", activation(p, "activation_post", x, filt), 3)
    return torch.clamp(x, -1.0, 1.0)


@torch.no_grad()
def batch_call(p, s: Sizes, mel: np.ndarray, lengths: np.ndarray, device,
               nx: Numerics = F32, block: int = 8) -> list[np.ndarray]:
    """One ``mel_to_wav`` call: mel (B, T, n_mels) -> B waveforms of
    ``lengths[i] * hop`` samples."""
    b, t, _ = mel.shape
    mel = np.pad(np.asarray(mel, np.float32), ((0, 0), (0, bucket(t) - t), (0, 0)))
    out = []
    for r0 in range(0, b, block):
        rows = torch.from_numpy(mel[r0: r0 + block]).to(device).transpose(1, 2)
        out.extend(generator(p, s, rows, nx)[:, 0].cpu().numpy())
    return [w[: int(n) * s.hop] for w, n in zip(out, lengths)]
