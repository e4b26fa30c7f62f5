"""The port's DSP ops against the JAX package's (smart_vocoder_tpu/ops).

Same numpy inputs through both; tolerances as tests/test_dsp.py holds the JAX
ops against the torch reference math: rtol 1e-4 / atol 2e-4 on the linear
and log-mel spectrograms (f32 FFTs in two libraries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch import ops as tops
from smart_vocoder_tpu import ops as jops


@pytest.fixture(scope="module")
def wav():
    rng = np.random.default_rng(0)
    t = np.arange(2 * 8192) / 22050.0
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * t).reshape(2, 8192)
    return (tone + 0.05 * rng.normal(size=(2, 8192))).astype(np.float32)


def test_mel_filterbank_matches():
    a = tops.mel_filterbank(22050, 1024, 80, 0.0, None)
    b = jops.mel_filterbank(22050, 1024, 80, 0.0, None)
    np.testing.assert_array_equal(a, b)


def test_spectrogram_matches(wav):
    cfg_t, cfg_j = tops.MelConfig(), jops.MelConfig()
    got = tops.spectrogram(torch.from_numpy(wav), cfg_t).numpy()
    want = np.asarray(jops.spectrogram(jnp.asarray(wav), cfg_j))
    assert got.shape == want.shape == (2, 8192 // 256, 513)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


def test_mel_spectrogram_matches(wav):
    cfg_t, cfg_j = tops.MelConfig(), jops.MelConfig()
    got = tops.mel_spectrogram(torch.from_numpy(wav), cfg_t).numpy()
    want = np.asarray(jops.mel_spectrogram(jnp.asarray(wav), cfg_j))
    assert got.shape == want.shape == (2, 32, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-4)


def test_sequence_mask_matches():
    lengths = np.array([3, 7, 0])
    got = tops.sequence_mask(torch.from_numpy(lengths), 8).numpy()
    want = np.asarray(jops.sequence_mask(jnp.asarray(lengths), 8))[..., 0]
    np.testing.assert_array_equal(got, want)
