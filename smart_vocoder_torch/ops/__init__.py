"""DSP and masking ops (counterpart of ``smart_vocoder_tpu/ops``)."""

from smart_vocoder_torch.ops.melscale import mel_filterbank
from smart_vocoder_torch.ops.noise import positional_eps, prior_sample
from smart_vocoder_torch.ops.segments import rand_slice_segments, sequence_mask, slice_segments
from smart_vocoder_torch.ops.stft import (
    MelConfig,
    mel_spectrogram,
    spec_to_mel,
    spectrogram,
    stft_magnitude,
)

__all__ = [
    "MelConfig",
    "mel_filterbank",
    "mel_spectrogram",
    "positional_eps",
    "prior_sample",
    "rand_slice_segments",
    "sequence_mask",
    "slice_segments",
    "spec_to_mel",
    "spectrogram",
    "stft_magnitude",
]
