"""STFT / mel-spectrogram ops with reference-exact numerics.

Counterpart of ``smart_vocoder_tpu/ops/stft.py``; reproduces the reference
pipeline (mel_processing.py:51-112):

  wav --reflect-pad (n_fft-hop)/2--> frames --periodic hann--> rfft
      --> sqrt(re^2 + im^2 + 1e-6) --slaney mel basis--> log(clamp(., 1e-5))

Spectrograms are time-major ``(batch, frames, bins)`` like the JAX package's.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from smart_vocoder_torch.ops.melscale import mel_filterbank


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Static DSP hyper-parameters (from the config's ``data`` block)."""

    sampling_rate: int = 22050
    n_fft: int = 1024
    hop_length: int = 256
    win_length: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None

    @classmethod
    def from_hparams(cls, hps) -> "MelConfig":
        return cls(
            sampling_rate=hps.data.sampling_rate,
            n_fft=hps.data.filter_length,
            hop_length=hps.data.hop_length,
            win_length=hps.data.win_length,
            n_mels=hps.data.n_mel_channels,
            fmin=hps.data.mel_fmin,
            fmax=hps.data.mel_fmax,
        )


@functools.lru_cache(maxsize=None)
def _mel_basis(sampling_rate: int, n_fft: int, n_mels: int, fmin: float, fmax) -> np.ndarray:
    return mel_filterbank(sampling_rate, n_fft, n_mels, fmin, fmax)


def stft_magnitude(y: torch.Tensor, n_fft: int, hop_length: int, win_length: int,
                   pad: bool = True) -> torch.Tensor:
    """Linear magnitude STFT of ``y (B, L)`` -> ``(B, n_frames, n_fft//2+1)``."""
    if y.ndim != 2:
        raise ValueError(f"expected (batch, samples), got {tuple(y.shape)}")
    orig_dtype = y.dtype
    y = y.float()
    if pad:
        p = int((n_fft - hop_length) / 2)
        y = F.pad(y[:, None], (p, p), mode="reflect")[:, 0]
    window = torch.hann_window(win_length, periodic=True, dtype=torch.float32,
                               device=y.device)
    spec = torch.stft(y, n_fft, hop_length=hop_length, win_length=win_length,
                      window=window, center=False, normalized=False, onesided=True,
                      return_complex=True)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)
    return mag.transpose(1, 2).to(orig_dtype)


def spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Reference ``spectrogram_torch`` with config-bundled params."""
    return stft_magnitude(y, cfg.n_fft, cfg.hop_length, cfg.win_length)


def spec_to_mel(spec: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Linear spec ``(B, T, n_fft//2+1)`` -> log-mel ``(B, T, n_mels)``."""
    basis = torch.as_tensor(
        _mel_basis(cfg.sampling_rate, cfg.n_fft, cfg.n_mels, cfg.fmin, cfg.fmax),
        dtype=spec.dtype, device=spec.device)
    return torch.log(torch.clamp(spec @ basis.T, min=1e-5))


def mel_spectrogram(y: torch.Tensor, cfg: MelConfig) -> torch.Tensor:
    """Fused wav ``(B, L)`` -> log-mel ``(B, L//hop, n_mels)``."""
    return spec_to_mel(spectrogram(y, cfg), cfg)
