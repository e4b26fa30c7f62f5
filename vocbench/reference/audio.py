"""Spectrograms as the reference SMART-Vocoder computes them
(``mel_processing.py:51-112``), a frozen copy in plain torch and numpy:

  wav --reflect pad (n_fft - hop) / 2--> frames --periodic hann--> rfft
      --> sqrt(re^2 + im^2 + 1e-6) --slaney mel basis--> log(clamp(., 1e-5))

Time-major: ``(B, frames, bins)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _hz_to_mel(f):
    f = np.asanyarray(f, dtype=np.float64)
    lin = f / (200.0 / 3.0)
    log = 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0)
    return np.where(f >= 1000.0, log, lin)


def _mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    log = 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0))
    return np.where(m >= 15.0, log, m * (200.0 / 3.0))


@functools.lru_cache(maxsize=8)
def mel_basis(sr: int, n_fft: int, n_mels: int, fmin: float, fmax) -> np.ndarray:
    """Slaney-normalised triangular filters (librosa.filters.mel, htk=False)."""
    fmax = float(sr) / 2.0 if fmax is None else float(fmax)
    fft_f = np.linspace(0.0, float(sr) / 2.0, n_fft // 2 + 1)
    mel_f = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_f[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    w = np.maximum(0.0, np.minimum(lower, upper))
    w *= (2.0 / (mel_f[2: n_mels + 2] - mel_f[:n_mels]))[:, None]
    return w.astype(np.float32)


def spectrogram(y: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """(B, L) -> (B, L // hop, n_fft // 2 + 1) linear magnitudes."""
    p = (n_fft - hop) // 2
    y = F.pad(y.float()[:, None], (p, p), mode="reflect")[:, 0]
    window = torch.hann_window(win, periodic=True, dtype=torch.float32, device=y.device)
    spec = torch.stft(y, n_fft, hop_length=hop, win_length=win, window=window, center=False,
                      normalized=False, onesided=True, return_complex=True)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6).transpose(1, 2)


def spec_to_mel(spec: torch.Tensor, data: dict) -> torch.Tensor:
    basis = torch.as_tensor(mel_basis(int(data["sampling_rate"]), int(data["filter_length"]),
                                      int(data["n_mel_channels"]), float(data["mel_fmin"]),
                                      data.get("mel_fmax")), device=spec.device)
    return torch.log(torch.clamp(spec @ basis.T, min=1e-5))


def mel_spectrogram(y: torch.Tensor, data: dict) -> torch.Tensor:
    """(B, L) -> (B, L // hop, n_mels) log-mel, ``data`` the config's block."""
    spec = spectrogram(y, int(data["filter_length"]), int(data["hop_length"]),
                       int(data["win_length"]))
    return spec_to_mel(spec, data)
