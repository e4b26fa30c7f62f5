"""Slaney-scale mel filterbank, bit-compatible with ``librosa.filters.mel``.

Counterpart of ``smart_vocoder_tpu/ops/melscale.py`` (numpy there too): the
reference builds its mel basis with ``librosa_mel_fn(sr, n_fft, n_mels, fmin,
fmax)`` (mel_processing.py:78, :96), i.e. ``htk=False`` and ``norm='slaney'``.
"""

from __future__ import annotations

import numpy as np

_F_SP = 200.0 / 3.0            # linear region: mels per Hz below the break
_MIN_LOG_HZ = 1000.0           # break frequency between linear and log regions
_MIN_LOG_MEL = _MIN_LOG_HZ / _F_SP
_LOGSTEP = np.log(6.4) / 27.0  # log region step


def hz_to_mel(frequencies) -> np.ndarray:
    """Hz -> mel (slaney scale: linear below 1 kHz, logarithmic above)."""
    f = np.asanyarray(frequencies, dtype=np.float64)
    mels = f / _F_SP
    safe = np.maximum(f, 1e-10)
    return np.where(f >= _MIN_LOG_HZ,
                    _MIN_LOG_MEL + np.log(safe / _MIN_LOG_HZ) / _LOGSTEP, mels)


def mel_to_hz(mels) -> np.ndarray:
    """Mel -> Hz (inverse of :func:`hz_to_mel`)."""
    m = np.asanyarray(mels, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL,
                    _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)), m * _F_SP)


def mel_frequencies(n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """`n_mels` frequencies evenly spaced on the slaney mel scale."""
    return mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels))


def mel_filterbank(sampling_rate: int, n_fft: int, n_mels: int, fmin: float = 0.0,
                   fmax: float | None = None, dtype=np.float32) -> np.ndarray:
    """Triangular slaney-normalized mel filterbank, shape ``(n_mels, n_fft//2+1)``."""
    if fmax is None:
        fmax = float(sampling_rate) / 2.0
    fftfreqs = np.linspace(0.0, float(sampling_rate) / 2.0, n_fft // 2 + 1)
    mel_f = mel_frequencies(n_mels + 2, fmin, fmax)
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2 : n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(dtype)
