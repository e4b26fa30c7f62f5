"""NN building blocks (counterpart of ``smart_vocoder_tpu/nn``), channel-first
``(B, C, T)``, with the reference's parameter names and torch layouts."""

from smart_vocoder_torch.nn.conv import (
    LRELU_SLOPE,
    Conv1d,
    Conv2d,
    ConvTranspose1d,
    fold_weight_norm,
    set_compute_dtype,
)
from smart_vocoder_torch.nn.coupling import Flip, ResidualCouplingLayer, flip_channels
from smart_vocoder_torch.nn.resblock import ResBlock1, ResBlock2
from smart_vocoder_torch.nn.wn import WN, gated_activation

__all__ = [
    "LRELU_SLOPE",
    "Conv1d",
    "Conv2d",
    "ConvTranspose1d",
    "Flip",
    "ResBlock1",
    "ResBlock2",
    "ResidualCouplingLayer",
    "WN",
    "flip_channels",
    "fold_weight_norm",
    "gated_activation",
    "set_compute_dtype",
]
