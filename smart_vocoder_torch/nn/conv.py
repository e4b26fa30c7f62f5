"""Convolutions with the reference's weight-norm parameter names.

Counterpart of ``smart_vocoder_tpu/nn/conv.py`` (``NormConv1d``,
``NormConvTranspose1d``, ``NormConv2d``, ``fold_weight_norm``). The reference
wraps nearly every conv in ``torch.nn.utils.weight_norm`` (``w = g * v /
||v||``, the norm taken over every dim but 0), which stores ``weight_g`` /
``weight_v``; these modules keep exactly those keys and torch's layouts

  Conv1d          weight (out, in/groups, k)
  ConvTranspose1d weight (in, out, k)
  Conv2d          weight (out, in, kh, kw)

so ``load_state_dict`` takes a reference ``G_*.pth`` / ``D_*.pth`` unchanged.
A module built with ``weight_norm=False`` holds a plain ``weight`` instead:
that is the inference form, fed by :func:`fold_weight_norm`. With
``spectral_norm=True`` (the discriminators under ``use_spectral_norm``,
models.py:175) it holds ``weight_orig`` and the buffer ``weight_u``, as
``torch.nn.utils.spectral_norm`` does.

Activations are channel-first ``(B, C, T)`` (``(B, C, H, W)`` for Conv2d). A
module computes in the dtype of its parameters (cast the module with
``.to(torch.bfloat16)`` for a bf16 graph), or in ``compute_dtype`` where
:func:`set_compute_dtype` set one: the weight (normalised in the parameters'
dtype) and bias are cast to it at each call, and the bias is added to the
conv's rounded output, so a trainer keeps f32 master weights under bf16
compute and rounds where the JAX modules' ``dtype`` over f32 params rounds.
The input is cast to the weight's dtype.

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


def get_padding(kernel_size: int, dilation: int = 1) -> int:
    """Same-length padding for odd kernels (ref: commons.py:14-15)."""
    return int((kernel_size * dilation - dilation) / 2)


def _norm_except_dim0(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=tuple(range(1, v.ndim)), keepdim=True))


SPECTRAL_EPS = 1e-12  # torch.nn.utils.spectral_norm's default eps


class _WeightNormConv(nn.Module):
    """Weight (plain, weight-normed or spectral-normed) + optional bias of one
    conv."""

    def __init__(self, shape, out_channels: int, bias: bool, weight_norm: bool,
                 fan_in: int, device=None, spectral_norm: bool = False):
        super().__init__()
        self.fan_in = fan_in
        self.spectral_norm = spectral_norm
        self.weight_norm = weight_norm and not spectral_norm
        self.compute_dtype: torch.dtype | None = None
        if spectral_norm:
            self.weight_orig = nn.Parameter(torch.empty(shape, device=device))
            self.register_buffer("weight_u", torch.empty(shape[0], device=device))
        elif weight_norm:
            g_shape = (shape[0],) + (1,) * (len(shape) - 1)
            self.weight_g = nn.Parameter(torch.empty(g_shape, device=device))
            self.weight_v = nn.Parameter(torch.empty(shape, device=device))
        else:
            self.weight = nn.Parameter(torch.empty(shape, device=device))
        self.bias = nn.Parameter(torch.empty(out_channels, device=device)) if bias else None

    def effective_weight(self) -> torch.Tensor:
        if self.spectral_norm:
            return self._spectral_weight()
        if self.weight_norm:
            return self.weight_v * (self.weight_g / _norm_except_dim0(self.weight_v))
        return self.weight

    def _spectral_weight(self) -> torch.Tensor:
        """``w / sigma_max(w)`` from one power-iteration step in f32, as
        ``smart_vocoder_tpu/nn/conv.py:_spectral_weight`` computes it: from
        the stored ``u``, ``v = norm(W^T u)``, ``u' = norm(W v)``, ``sigma =
        u' . (W v)``, differentiated through ``v`` and ``u'`` (the stored
        ``u`` is a constant). In training mode ``u'`` replaces ``u``, so the
        estimate advances once per forward; in eval mode ``u`` is left as
        it is (JAX's apply without ``mutable=['spectral']``)."""
        w = self.weight_orig
        mat = w.reshape(w.shape[0], -1).float()
        u = self.weight_u.clone()
        v = mat.T @ u
        v = v / (torch.linalg.vector_norm(v) + SPECTRAL_EPS)
        wv = mat @ v
        u_new = wv / (torch.linalg.vector_norm(wv) + SPECTRAL_EPS)
        if self.training:
            with torch.no_grad():
                self.weight_u.copy_(u_new)
        sigma = torch.dot(u_new, wv)
        return w / sigma.to(w.dtype)

    def _conv(self, conv, x: torch.Tensor, **kwargs) -> torch.Tensor:
        """``conv(x, weight, bias, **kwargs)`` in the dtype the module computes
        in. Under a ``compute_dtype`` the bias is added to the conv's rounded
        output, where the JAX modules add it (``y + b.astype(dtype)``)."""
        w, b = self.effective_weight(), self.bias
        if self.compute_dtype is None:
            return conv(x.to(w.dtype), w, b, **kwargs)
        w = w.to(self.compute_dtype)
        y = conv(x.to(w.dtype), w, None, **kwargs)
        if b is None:
            return y
        return y + b.to(self.compute_dtype).reshape(-1, *([1] * (y.ndim - 2)))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, zero: bool = False) -> None:
        """torch's conv default (uniform +-1/sqrt(fan_in)) drawn from
        ``generator``; with weight norm ``g`` starts at ``||v||`` as torch's
        wrapper sets it. ``zero`` zero-initialises (the coupling ``post``)."""
        bound = 1.0 / math.sqrt(self.fan_in)

        def uniform(p):
            r = torch.rand(p.shape, generator=generator, dtype=torch.float32)
            p.copy_((r * 2 - 1) * bound)

        if self.spectral_norm:
            w = self.weight_orig
        else:
            w = self.weight_v if self.weight_norm else self.weight
        if zero:
            w.zero_()
        else:
            uniform(w)
        if self.weight_norm:
            self.weight_g.copy_(_norm_except_dim0(w))
        if self.spectral_norm:  # the JAX package draws u from a normal (conv.py:79)
            self.weight_u.copy_(torch.randn(self.weight_u.shape, generator=generator))
        if self.bias is not None:
            uniform(self.bias)


class Conv1d(_WeightNormConv):
    """``torch.nn.Conv1d`` semantics, with the reference's weight-norm keys."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 padding: int = 0, dilation: int = 1, bias: bool = True,
                 weight_norm: bool = False, device=None, stride: int = 1,
                 groups: int = 1, spectral_norm: bool = False):
        if in_channels % groups:
            raise ValueError(f"in_channels {in_channels} not divisible by groups {groups}")
        fan_in = in_channels // groups * kernel_size
        super().__init__((out_channels, in_channels // groups, kernel_size), out_channels,
                         bias, weight_norm, fan_in, device, spectral_norm)
        self.padding = padding
        self.dilation = dilation
        self.stride = stride
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(F.conv1d, x, stride=self.stride, padding=self.padding,
                          dilation=self.dilation, groups=self.groups)


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
        return self._conv(F.conv_transpose1d, x, stride=self.stride, padding=self.padding)


class Conv2d(_WeightNormConv):
    """``torch.nn.Conv2d`` semantics over ``(B, C, H, W)``, with weight-norm
    (g over dim 0) or spectral-norm keys: the period discriminators' convs
    (models.py:176-183)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: tuple,
                 stride: tuple = (1, 1), padding: tuple = (0, 0), bias: bool = True,
                 weight_norm: bool = True, spectral_norm: bool = False, device=None):
        kh, kw = kernel_size
        super().__init__((out_channels, in_channels, kh, kw), out_channels, bias,
                         weight_norm, in_channels * kh * kw, device, spectral_norm)
        self.stride = tuple(stride)
        self.padding = tuple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(F.conv2d, x, stride=self.stride, padding=self.padding)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> nn.Module:
    """Make every conv under ``module`` compute in ``dtype`` over parameters
    that keep their own dtype (``None``: the parameters' dtype)."""
    for m in module.modules():
        if isinstance(m, _WeightNormConv):
            m.compute_dtype = dtype
    return module


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
