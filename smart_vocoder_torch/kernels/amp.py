"""BigVGAN-v2's generator on the card: the AMP route and its fused
anti-aliased SnakeBeta kernel.

:func:`amp_generator_apply` runs ``models/bigvgan.py``'s equations over folded
weights packed once (:func:`pack_amp_generator`): ``conv_pre``, then each
stage's transposed-conv upsample, its kernel sizes' AMP blocks (three
residual pairs each) and their mean, then the tail (``activation_post``,
``conv_post``, a clamp). Precision, as the config's ``tpu`` block states it:
every conv takes bf16 operands with f32 accumulation (cuDNN, through
``decoder.py``'s ``_conv1d`` and ``_conv_transpose1d``); every activation
computes in f32 and stores bf16; the residual stream and the branch mean are
f32, as iitp_base's hifi 2 keeps its early decoder (``conv_pre`` and the
upsamples round their outputs to bf16 first); ``conv_post`` takes bf16
operands into an f32 result.

:func:`aa_snake` is ``down2(SnakeBeta(up2(x)))`` in one kernel
(``csrc/aa_snake.cu``: each input read once, the 2T upsampled signal kept in
shared memory, each output written once; 109 launches a call at BigVGAN-v2's
six stages, counted as ``LAUNCHES["aa_snake"]``). It replaces no TPU kernel:
the JAX package has no BigVGAN. Its plain version, :func:`aa_snake_plain`,
is torch's chain of the model module; the wrapper takes it only for a tensor
on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Mapping, NamedTuple

import torch

from smart_vocoder_torch.kernels._build import launch, load_library
from smart_vocoder_torch.kernels.decoder import DecoderConfig, _conv1d, _conv_transpose1d
from smart_vocoder_torch.models.bigvgan import (
    anti_aliased_snake,
    kaiser_sinc_filter,
    snake_coefficients,
)


class Snake(NamedTuple):
    """One activation's per-channel ``a = exp(log alpha)`` and
    ``ib = 1 / (exp(log beta) + 1e-9)``, f32 on the device."""
    a: torch.Tensor
    ib: torch.Tensor


@functools.lru_cache(maxsize=None)
def _host_taps() -> ctypes.Array:
    return (ctypes.c_float * 12)(*kaiser_sinc_filter().tolist())


def aa_snake_plain(x: torch.Tensor, act: Snake, taps: torch.Tensor) -> torch.Tensor:
    """``down2(SnakeBeta(up2(x)))`` as torch's chain, in f32."""
    return anti_aliased_snake(x.float(), act.a, act.ib, taps.float())


def aa_snake(x: torch.Tensor, act: Snake, taps: torch.Tensor) -> torch.Tensor:
    """``x (B, C, T)`` f32 or bf16 -> the anti-aliased SnakeBeta ``(B, C, T)``,
    computed in f32 and stored bf16 (the next conv's operand). ``taps``: the
    12-tap filter (:func:`kaiser_sinc_filter`; the kernel holds its own copy)."""
    if x.device.type == "cpu":
        return aa_snake_plain(x, act, taps).to(torch.bfloat16)
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"aa_snake takes a contiguous (B, C, T) tensor, got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"aa_snake reads f32 or bf16, got {x.dtype}")
    b, c, t = x.shape
    if act.a.shape != (c,) or act.a.dtype != torch.float32 or act.a.device != x.device:
        raise ValueError("aa_snake's coefficients are (C,) f32 on the input's device")
    out = torch.empty(x.shape, dtype=torch.bfloat16, device=x.device)
    launch("aa_snake", load_library().svt_aa_snake, x.data_ptr(), out.data_ptr(),
           act.a.data_ptr(), act.ib.data_ptr(), _host_taps(), b * c, c, t,
           int(x.dtype == torch.bfloat16))
    return out


class PackedAmp(NamedTuple):
    """What :func:`amp_generator_apply` reads at every call: the conv weights
    and biases in bf16, each activation's :class:`Snake` by module name
    (``resblocks.n.activations.m``, ``activation_post``) and the filter taps."""
    convs: dict
    acts: dict
    taps: torch.Tensor


def pack_amp_generator(params: Mapping[str, torch.Tensor]) -> PackedAmp:
    """Folded generator weights (``models/bigvgan.py``'s names) as the route
    reads them, made once per weight set."""
    convs = {k: v.to(torch.bfloat16) for k, v in params.items() if ".act." not in k}
    acts = {k[: -len(".act.alpha")]: Snake(*snake_coefficients(v, params[k[:-5] + "beta"]))
            for k, v in params.items() if k.endswith(".act.alpha")}
    device = next(iter(params.values())).device
    return PackedAmp(convs, acts, kaiser_sinc_filter().to(device))


def branch_mean(ys: list) -> torch.Tensor:
    """The stage's AMP branches' mean, summed in place into the first."""
    xs = ys[0]
    for y in ys[1:]:
        xs.add_(y)
    return xs.div_(len(ys))


def amp_generator_apply(packed: PackedAmp, mel: torch.Tensor, cfg: DecoderConfig) -> torch.Tensor:
    """mel ``(B, n_mels, T)`` -> waveform ``(B, 1, T * prod(upsample_rates))``, f32."""
    p, acts, taps = packed.convs, packed.acts, packed.taps
    bf16 = torch.bfloat16

    def conv(x, name, padding, dilation=1, out_f32=False):
        return _conv1d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), padding, bf16,
                       out_f32=out_f32, dilation=dilation)

    def act(x, name):
        return aa_snake(x.contiguous(), acts[name], taps)

    def amp_block(x, blk, rk, rd):
        y = x
        for n, d in enumerate(rd):
            t = act(y, f"{blk}.activations.{2 * n}")
            t = conv(t, f"{blk}.convs1.{n}", d * (rk - 1) // 2, d)
            t = act(t, f"{blk}.activations.{2 * n + 1}")
            t = conv(t, f"{blk}.convs2.{n}", (rk - 1) // 2)
            y = t + y if y is x else y.add_(t)  # x stays for the next branch
        return y

    # conv_pre and the upsamples on the tensor cores, their bf16 outputs widened
    # to the f32 residual stream (in f32 they would run on cuDNN's f32 path)
    x = conv(mel, "conv_pre", 3).float()
    nk = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = _conv_transpose1d(x, p[f"ups.{i}.0.weight"], p[f"ups.{i}.0.bias"], u, (k - u) // 2,
                              bf16).float()
        x = branch_mean([amp_block(x, f"resblocks.{i * nk + j}", rk, rd) for j, (rk, rd)
                         in enumerate(zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes))])
    x = conv(act(x, "activation_post"), "conv_post", 3, out_f32=True)
    return torch.clamp(x, -1.0, 1.0)
