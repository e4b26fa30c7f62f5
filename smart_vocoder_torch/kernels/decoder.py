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
At hifi >= 2 with bf16 weights, an earlier stage whose channels are a
multiple of 128 that the unpacked kernel takes runs its MRF on
:func:`mrf_stage_unpacked` in F32_STORAGE mode instead, which computes what
``mrf_stage_reference(mixed_f32=True)`` does on the tensor cores (stages 1-2
at iitp_base, 256 and 128 channels); its upsample stays on cuDNN.

``pallas_stage2=True`` is the JAX package's route of the same name
(decoder.py:209-255, driven by scripts/exp_stage2_e2e.py): a stage of 64
channels or fewer folds its upsample into :func:`up_mrf_stage` (stage 3 at
iitp_base, 128 -> 64, with no tail), and a stage whose channels are a
multiple of 128 and whose length is a multiple of 512 runs the unpacked MRF
kernel (:func:`mrf_stage_unpacked`): stage 2 (128 channels) always, stage 1
(256 channels) when 8 x frames is a multiple of 512 (the 1024-, 2048- and
4096-frame buckets).
"""

from __future__ import annotations

import dataclasses
from typing import List, Mapping, NamedTuple, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from smart_vocoder_torch.kernels.mrf import (
    LRELU_SLOPE,
    F32S_CHANNELS,
    MRF_CHANNELS,
    POST_SLOPE,
    UP_CHANNELS,
    BranchWeights,
    PackedMRF,
    PackedUpMRF,
    leaky_native,
    mrf_stage,
    mrf_stage_reference,
    mrf_stage_unpacked,
    pack_mrf_stage,
    pack_up_mrf_stage,
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


def _conv1d(x, w, bias, padding: int, dtype, out_f32: bool = False, dilation: int = 1):
    """Conv over (B, C, T) as the JAX ``_conv1d`` rounds it: operands in
    ``dtype``; a bf16 conv rounds its output and then its bias add, while
    ``out_f32`` keeps bf16 operands with an f32 result and f32 bias."""
    if dtype == torch.float32 or out_f32:
        y = F.conv1d(x.to(dtype).float(), w.to(dtype).float(), padding=padding,
                     dilation=dilation)
        return y if bias is None else y + bias.float()[:, None]
    y = F.conv1d(x.to(dtype), w.to(dtype), padding=padding, dilation=dilation)
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


def _stage_kernel(cfg: DecoderConfig, stage: int, pallas_stage2: bool) -> Optional[str]:
    """Which tensor-core kernel the routing of the module docstring gives a
    stage: ``"up_mrf_stage"``, ``"mrf_stage"`` or neither."""
    n_stages = len(cfg.upsample_rates)
    ch = cfg.upsample_initial_channel // (2 ** (stage + 1))
    last = stage == n_stages - 1
    fold_up = ch <= 32 or (pallas_stage2 and ch <= 64)
    if fold_up and (last or pallas_stage2) and (2 * ch, ch) in UP_CHANNELS:
        return "up_mrf_stage"
    if stage == n_stages - 2 and ch in MRF_CHANNELS:
        return "mrf_stage"
    return None


def _unpacked_route(cfg: DecoderConfig, stage: int, pallas_stage2: bool) -> bool:
    """Whether ``pallas_stage2`` runs a stage's MRF on :func:`mrf_stage_unpacked`
    (given a length that is a multiple of 512): a stage without a kernel of
    its own whose channels are a multiple of 128."""
    ch = cfg.upsample_initial_channel // (2 ** (stage + 1))
    return (pallas_stage2 and ch % 128 == 0
            and _stage_kernel(cfg, stage, pallas_stage2) is None)


def _f32s_route(cfg: DecoderConfig, stage: int, dtype, hifi: int,
                pallas_stage2: bool) -> bool:
    """Whether a stage's MRF runs on ``mrf_stage_unpacked(f32_storage=True)``:
    at hifi >= 2 (the early decoder's f32 activations over bf16 weights, the
    function of ``mrf_stage_reference(mixed_f32=True)``), outside
    ``pallas_stage2``, for a stage without a kernel of its own whose channels
    the unpacked kernel takes and are a multiple of 128, ``F32S_CHANNELS``
    (stages 1-2 at iitp_base). Any length: the kernel masks its ragged tile."""
    ch = cfg.upsample_initial_channel // (2 ** (stage + 1))
    return (int(hifi) >= 2 and dtype == torch.bfloat16 and not pallas_stage2
            and ch in F32S_CHANNELS and _stage_kernel(cfg, stage, pallas_stage2) is None)


class PackedStage(NamedTuple):
    """One stage's weights as :func:`decoder_apply` uses them at every step:
    the stacked branches, and the layout of the stage's tensor-core kernel
    (the unpacked stage's under ``pallas_stage2`` or in F32_STORAGE mode)
    where it has one and its weights are bf16 values."""
    branches: List[BranchWeights]
    kernel: Union[PackedMRF, PackedUpMRF, None]


def pack_decoder(params_dec: Mapping[str, torch.Tensor], cfg: DecoderConfig,
                 dtype=torch.bfloat16, hifi_tail: int = 0,
                 pallas_stage2: bool = False) -> List[PackedStage]:
    """The ``packed`` argument of :func:`decoder_apply` for these weights and
    options: made once per weight set (``Vocoder`` does), so a request does
    not stack, round and lay out the MRF weights again."""
    dil = tuple(cfg.resblock_dilation_sizes[0])
    n_stages = len(cfg.upsample_rates)
    bf16 = dtype == torch.bfloat16
    hifi = int(hifi_tail)
    stages = []
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        branches = _stage_branches(params_dec, i, len(cfg.resblock_kernel_sizes), len(dil),
                                   dtype)
        last = i == n_stages - 1
        kernel = _stage_kernel(cfg, i, pallas_stage2)
        packed = None
        # the last stage's weights are bf16 values under hifi; a stage folded up
        # before it takes the early decoder's f32 activations at hifi >= 2
        up_bf16 = (bf16 or hifi >= 1) if last else (bf16 and hifi < 2)
        if kernel == "up_mrf_stage" and up_bf16:
            packed = pack_up_mrf_stage(
                params_dec[f"ups.{i}.weight"], params_dec[f"ups.{i}.bias"], u, (k - u) // 2,
                branches, params_dec["conv_post.weight"] if last else None,
                device=branches[0][0].device)
        elif kernel == "mrf_stage" and bf16:
            packed = pack_mrf_stage(branches, branches[0][0].device)
        elif kernel is None and ((_unpacked_route(cfg, i, pallas_stage2) and bf16)
                                 or _f32s_route(cfg, i, dtype, hifi, pallas_stage2)):
            # the unpacked kernel's weights (under pallas_stage2, for the lengths
            # that take it)
            packed = pack_mrf_stage(branches, branches[0][0].device)
        stages.append(PackedStage(branches, packed))
    return stages


def decoder_apply(params_dec: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: DecoderConfig, g: torch.Tensor | None = None,
                  dtype=torch.bfloat16, hifi_tail: int = 0,
                  pallas_stage2: bool = False,
                  packed: Optional[Sequence[PackedStage]] = None) -> torch.Tensor:
    """Folded decoder weights (the ``dec.`` state dict without its prefix) and
    latent ``x (B, T, C)`` -> waveform ``(B, T*hop, 1)``.

    ``g``: speaker conditioning (B, 1, gin) or None. ``hifi_tail`` keeps the
    levels of decoder.py:153-165: 0 off (bf16 throughout); 1 the last stage
    in F32 mode and the stage before in f32 storage; 2 also keeps the early
    decoder (conv_pre, the cuDNN upsamples and MRF stages) in f32 activations
    with bf16-rounded operands; 3 also runs the second-to-last stage in F32
    mode (the JAX hi/lo split). The levels are meant for ``dtype=bfloat16``;
    ``Vocoder`` sets 0 for float32. ``pallas_stage2``: the routing of the
    module docstring; the folded-up stage before the last runs without the
    tail and so without ``hifi``. ``packed``: from :func:`pack_decoder` for
    the same weights, ``dtype``, ``hifi_tail`` and ``pallas_stage2``."""
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
        if packed is None:
            branches, kernel_weights = _stage_branches(p, i, num_kernels, len(dil), dtype), None
        else:
            branches, kernel_weights = packed[i]
        last = i == n_stages - 1
        kernel = _stage_kernel(cfg, i, pallas_stage2)
        if kernel == "up_mrf_stage":
            y = up_mrf_stage(y.transpose(1, 2), up_w, up_b, k, u, (k - u) // 2,
                             branches, ks, dil,
                             post_weight=p["conv_post.weight"] if last else None,
                             hifi=hifi >= 1 and last, packed=kernel_weights)
            if last:
                return y
            y = y.transpose(1, 2)
            continue
        y = _conv_transpose1d(leaky_native(y, LRELU_SLOPE), up_w, up_b, u, (k - u) // 2,
                              dtype, out_f32=early_f32)
        if kernel == "mrf_stage":
            y = mrf_stage(y.transpose(1, 2).to(dtype), branches, ks, dil,
                          f32_storage=hifi >= 1, x2=hifi >= 3,
                          packed=kernel_weights).transpose(1, 2)
        elif _unpacked_route(cfg, i, pallas_stage2) and y.shape[2] % 512 == 0:
            y = mrf_stage_unpacked(y.transpose(1, 2).to(dtype), branches, ks, dil,
                                   packed=kernel_weights).transpose(1, 2)
        elif _f32s_route(cfg, i, dtype, hifi, pallas_stage2):
            y = mrf_stage_unpacked(y.transpose(1, 2), branches, ks, dil, f32_storage=True,
                                   packed=kernel_weights).transpose(1, 2)
        else:
            y = mrf_stage_reference(y.transpose(1, 2), branches, ks, dil,
                                    mixed_f32=early_f32).transpose(1, 2)

    y = _conv1d(leaky_native(y, POST_SLOPE), p["conv_post.weight"], None, 3, dtype)
    return torch.tanh(y).transpose(1, 2)
