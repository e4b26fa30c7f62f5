"""Full-width fidelity of the port against the committed golden fixture.

tests/fixtures/golden_iitp_base.npz holds the torch reference's f32 waveform
for a pinned (weights, mel, noise) triple; the weights come from the JAX
package's recipe (smart_vocoder_tpu/utils/golden.py:fidelity_params). Here
they cross the bridge into the port at full iitp_base width, the port's f32
``SynthesizerTrn.infer`` synthesizes on the fixture's mel and noise, and its
mel-L1 against the reference waveform must be <= 1e-2 (the JAX f32 path
scores 4e-5). Marked slow: building the 42.9 M-parameter JAX init alone takes
over a minute on a CPU.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.config import load_config as torch_load_config
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.ops import MelConfig, mel_spectrogram
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.config import load_config
from smart_vocoder_tpu.utils.golden import fidelity_params

pytestmark = pytest.mark.slow

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(_REPO, "tests", "fixtures", "golden_iitp_base.npz")
_CONFIG = os.path.join(_REPO, "configs", "iitp_base.json")


def test_port_golden_fixture_mel_l1():
    gz = np.load(_FIXTURE)
    hps = load_config(_CONFIG)
    gmel = jnp.asarray(gz["mel"])
    lens = jnp.full((1,), gmel.shape[1], jnp.int32)
    spec = jnp.zeros((1, gmel.shape[1], hps.data.filter_length // 2 + 1))
    params = jax.tree.map(np.asarray, fidelity_params(hps, gmel, lens, spec))

    thps = torch_load_config(_CONFIG)
    net = build_synthesizer(thps, weight_norm=False)
    net.load_state_dict(state_dict_from_jax_params(params), strict=True)
    net.eval()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        wav, _ = net.infer(torch.from_numpy(np.asarray(gz["mel"])),
                           torch.tensor([gmel.shape[1]]), torch.from_numpy(gz["eps"]),
                           noise_scale=float(gz["noise_scale"]))
        cfg = MelConfig.from_hparams(thps)
        m_got = mel_spectrogram(wav[..., 0], cfg)
        m_ref = mel_spectrogram(torch.from_numpy(gz["wav_ref"])[None].float(), cfg)
    l1 = float((m_got - m_ref).abs().mean())
    print(f"port f32 mel-L1 vs golden fixture: {l1:.3e}")
    assert l1 <= 1e-2, l1
