"""Convolutions with the reference's weight-norm parameter names.

Counterpart of ``smart_vocoder_tpu/nn/conv.py`` (``NormConv1d``,
``NormConvTranspose1d``, ``fold_weight_norm``). The reference wraps nearly
every conv in ``torch.nn.utils.weight_norm`` (``w = g * v / ||v||``, the norm
taken over every dim but 0), which stores ``weight_g`` / ``weight_v``; these
modules keep exactly those keys and torch's layouts

  Conv1d          weight (out, in, k)
  ConvTranspose1d weight (in, out, k)

so ``load_state_dict`` takes a reference ``G_*.pth`` unchanged. A module built
with ``weight_norm=False`` holds a plain ``weight`` instead: that is the
inference form, fed by :func:`fold_weight_norm`.

Activations are channel-first ``(B, C, T)``. A module computes in the dtype
of its parameters (cast the module with ``.to(torch.bfloat16)`` for a bf16
graph); the input is cast to it.

The JAX package's space-to-depth packing, polyphase transposed conv and
per-tap forms are TPU lane re-layouts of the same math and are not ported.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

LRELU_SLOPE = 0.1  # reference: modules.py:17


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))


class _WeightNormConv(nn.Module):
    """Weight (plain or weight-normed) + optional bias of one conv."""

    def __init__(self, shape, out_channels: int, bias: bool, weight_norm: bool,
                 fan_in: int, device=None):
        super().__init__()
        self.fan_in = fan_in
        self.weight_norm = weight_norm
        if weight_norm:
            self.weight_g = nn.Parameter(torch.empty((shape[0], 1, 1), device=device))
            self.weight_v = nn.Parameter(torch.empty(shape, device=device))
        else:
            self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) if bias else None

    def effective_weight(self) -> torch.Tensor:
        if self.weight_norm:
            return self.weight_v * (self.weight_g / _norm_except_dim0(self.weight_v))
        return self.weight

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, zero: bool = False) -> None:
        """torch's conv default (uniform +-1/sqrt(fan_in)) drawn from
        ``generator``; with weight norm ``g`` starts at ``||v||`` as torch's
        wrapper sets it. ``zero`` zero-initialises (the coupling ``post``)."""
        bound = 1.0 / math.sqrt(self.fan_in)

        def uniform(p):
            r = torch.rand(p.shape, generator=generator, dtype=torch.float32)
            p.copy_((r * 2 - 1) * bound)

        w = self.weight_v if self.weight_norm else self.weight
        if zero:
            w.zero_()
        else:
            uniform(w)
        if self.weight_norm:
            self.weight_g.copy_(_norm_except_dim0(w))
        if self.bias is not None:
            uniform(self.bias)


class Conv1d(_WeightNormConv):
    """``torch.nn.Conv1d`` semantics, with the reference's weight-norm keys."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 weight_norm: bool = False, device=None):
        super().__init__((out_channels, in_channels, kernel_size), out_channels, bias,
                         weight_norm, in_channels * kernel_size, device)
        self.padding = padding
        self.dilation = dilation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight()
        return F.conv1d(x.to(w.dtype), w, self.bias, padding=self.padding,
                        dilation=self.dilation)


class ConvTranspose1d(_WeightNormConv):
    """``torch.nn.ConvTranspose1d`` semantics, with weight-norm keys (g over
    dim 0 of the ``(in, out, k)`` weight, as torch's wrapper does)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int, padding: int = 0, bias: bool = True,
                 weight_norm: bool = True, device=None):
        super().__init__((in_channels, out_channels, kernel_size), out_channels, bias,
                         weight_norm, out_channels * kernel_size, device)
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.effective_weight()
        return F.conv_transpose1d(x.to(w.dtype), w, self.bias, stride=self.stride,
                                  padding=self.padding)


def fold_weight_norm(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Bake every ``weight_v`` / ``weight_g`` pair into a plain ``weight``.

    The inference-time analogue of the reference's ``remove_weight_norm``
    (models.py:162-167); load the result into a model built with
    ``weight_norm=False``."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in state_dict.items():
        if key.endswith(".weight_g") and key[:-1] + "v" in state_dict:
            continue
        if key.endswith(".weight_v") and key[:-1] + "g" in state_dict:
            g = state_dict[key[:-1] + "g"]
            out[key[: -len("_v")]] = val * (g / _norm_except_dim0(val))
        else:
            out[key] = val
    return out
