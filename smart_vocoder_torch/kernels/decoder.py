"""Fast decoder over folded generator weights.

Counterpart of ``smart_vocoder_tpu/kernels/decoder.py:decoder_apply``: the
HiFi-GAN generator as plain functions over a folded state dict, so that each
stage can be routed to a hand-written kernel or to cuDNN convolutions, with
the serving-fidelity ``hifi_tail`` levels of the JAX function.

Routing (a stage/channel rule): the last stage runs as ONE kernel --
lrelu -> transposed-conv upsample -> MRF -> lrelu(0.01) -> conv_post -> tanh
(:func:`up_mrf_stage`); the stage before it runs its MRF as one kernel
(:func:`mrf_stage`) after a cuDNN upsample; all earlier stages, and any stage
whose channel counts the kernels are not built for, run cuDNN convolutions
with the plain MRF (:func:`mrf_stage_reference`). At iitp_base these are
stages 4 (64 -> 32 channels) and 3 (64 channels), the late narrow stages.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from smart_vocoder_torch.kernels.mrf import (
    LRELU_SLOPE,
    MRF_CHANNELS,
    POST_SLOPE,
    UP_CHANNELS,
    leaky_native,
    mrf_stage,
    mrf_stage_reference,
    up_mrf_stage,
)


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)

    @classmethod
    def from_hparams(cls, hps) -> "DecoderConfig":
        return cls(
            resblock=hps.model.resblock,
            resblock_kernel_sizes=tuple(hps.model.resblock_kernel_sizes),
            resblock_dilation_sizes=tuple(tuple(d) for d in hps.model.resblock_dilation_sizes),
            upsample_rates=tuple(hps.model.upsample_rates),
            upsample_initial_channel=hps.model.upsample_initial_channel,
            upsample_kernel_sizes=tuple(hps.model.upsample_kernel_sizes),
        )


def _conv1d(x, w, bias, padding: int, dtype, out_f32: bool = False):
    """Conv over (B, C, T) as the JAX ``_conv1d`` rounds it: operands in
    ``dtype``; a bf16 conv rounds its output and then its bias add, while
    ``out_f32`` keeps bf16 operands with an f32 result and f32 bias."""
    if dtype == torch.float32 or out_f32:
        y = F.conv1d(x.to(dtype).float(), w.to(dtype).float(), padding=padding)
        return y if bias is None else y + bias.float()[:, None]
    y = F.conv1d(x.to(dtype), w.to(dtype), padding=padding)
    return y if bias is None else y + bias.to(dtype)[:, None]


def _conv_transpose1d(x, w, bias, stride: int, padding: int, dtype, out_f32: bool = False):
    """Transposed conv with ``_conv1d``'s rounding (JAX evaluates it in its
    polyphase form; torch's direct form is the same math)."""
    if dtype == torch.float32 or out_f32:
        y = F.conv_transpose1d(x.to(dtype).float(), w.to(dtype).float(), stride=stride,
                               padding=padding)
        return y + bias.float()[:, None]
    y = F.conv_transpose1d(x.to(dtype), w.to(dtype), stride=stride, padding=padding)
    return y + bias.to(dtype)[:, None]


def _stage_branches(params: Mapping[str, torch.Tensor], stage: int, num_kernels: int,
                    n_pairs: int, dtype):
    """(w1, b1, w2, b2) per branch, weights as (n_pairs, k, Cin, Cout), rounded
    to ``dtype`` with their biases as decoder.py:121-133 rounds them."""
    branches = []
    for j in range(num_kernels):
        pre = f"resblocks.{stage * num_kernels + j}"

        def stack(kind, leaf):
            ts = [params[f"{pre}.{kind}.{i}.{leaf}"] for i in range(n_pairs)]
            if leaf == "weight":
                ts = [t.permute(2, 1, 0) for t in ts]
            return torch.stack(ts).to(dtype)

        branches.append((stack("convs1", "weight"), stack("convs1", "bias"),
                         stack("convs2", "weight"), stack("convs2", "bias")))
    return branches


def decoder_apply(params_dec: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: DecoderConfig, g: torch.Tensor | None = None,
                  dtype=torch.bfloat16, hifi_tail: int = 0) -> torch.Tensor:
    """Folded decoder weights (the ``dec.`` state dict without its prefix) and
    latent ``x (B, T, C)`` -> waveform ``(B, T*hop, 1)``.

    ``g``: speaker conditioning (B, 1, gin) or None. ``hifi_tail`` keeps the
    levels of decoder.py:153-165: 0 off (bf16 throughout); 1 the last stage
    in F32 mode and the stage before in f32 storage; 2 also keeps the early
    decoder (conv_pre, the cuDNN upsamples and MRF stages) in f32 activations
    with bf16-rounded operands; 3 also runs the second-to-last stage in F32
    mode (the JAX hi/lo split). The levels are meant for ``dtype=bfloat16``;
    ``Vocoder`` sets 0 for float32."""
    if cfg.resblock != "1":
        raise ValueError("the fast decoder supports ResBlock1 configs")
    num_kernels = len(cfg.resblock_kernel_sizes)
    ks = tuple(cfg.resblock_kernel_sizes)
    dil = tuple(cfg.resblock_dilation_sizes[0])
    # One dilation tuple shared across branches (true of the reference config
    # family); a per-branch mix would silently produce wrong audio here.
    if not all(tuple(d) == dil for d in cfg.resblock_dilation_sizes):
        raise ValueError("the fast decoder assumes identical dilation tuples across "
                         f"MRF branches; got {cfg.resblock_dilation_sizes}")
    hifi = int(hifi_tail)
    early_f32 = hifi >= 2
    p = params_dec

    y = _conv1d(x.transpose(1, 2), p["conv_pre.weight"], p["conv_pre.bias"], 3, dtype,
                out_f32=early_f32)
    if g is not None:
        y = y + _conv1d(g.transpose(1, 2), p["cond.weight"], p["cond.bias"], 0, dtype,
                        out_f32=early_f32)

    n_stages = len(cfg.upsample_rates)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        ch = cfg.upsample_initial_channel // (2 ** (i + 1))
        up_w, up_b = p[f"ups.{i}.weight"], p[f"ups.{i}.bias"]
        branches = _stage_branches(p, i, num_kernels, len(dil), dtype)
        if i == n_stages - 1 and (2 * ch, ch) in UP_CHANNELS:
            return up_mrf_stage(y.transpose(1, 2), up_w, up_b, k, u, (k - u) // 2,
                                branches, ks, dil, post_weight=p["conv_post.weight"],
                                hifi=hifi >= 1)
        y = _conv_transpose1d(leaky_native(y, LRELU_SLOPE), up_w, up_b, u, (k - u) // 2,
                              dtype, out_f32=early_f32)
        if i == n_stages - 2 and ch in MRF_CHANNELS:
            y = mrf_stage(y.transpose(1, 2).to(dtype), branches, ks, dil,
                          f32_storage=hifi >= 1, x2=hifi >= 3).transpose(1, 2)
        else:
            y = mrf_stage_reference(y.transpose(1, 2), branches, ks, dil,
                                    mixed_f32=early_f32).transpose(1, 2)

    y = _conv1d(leaky_native(y, POST_SLOPE), p["conv_post.weight"], None, 3, dtype)
    return torch.tanh(y).transpose(1, 2)
