"""Full-width fidelity of the port against the committed golden fixture.

tests/fixtures/golden_iitp_base.npz holds the torch reference's f32 waveform
for a pinned (weights, mel, noise) triple; the weights come from the JAX
package's recipe (smart_vocoder_tpu/utils/golden.py:fidelity_params). Here
they cross the bridge into the port at full iitp_base width, the port's f32
``SynthesizerTrn.infer`` synthesizes on the fixture's mel and noise, and its
mel-L1 against the reference waveform must be <= 1e-2 (the JAX f32 path
scores 4e-5). The port's own recipe (``utils/golden.py:fidelity_state_dict``,
no JAX) rebuilds the same weights leaf by leaf, and on them the port's f32
path meets the same bound. Marked slow: building the 42.9 M-parameter JAX
init alone takes over a minute on a CPU.
"""

import functools

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.config import load_config as torch_load_config
from smart_vocoder_torch.models import build_synthesizer
from smart_vocoder_torch.ops import MelConfig, mel_spectrogram
from smart_vocoder_torch.utils.golden import fidelity_state_dict
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.config import load_config
from smart_vocoder_tpu.utils.golden import fidelity_params

pytestmark = pytest.mark.slow

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_FIXTURE = os.path.join(_REPO, "tests", "fixtures", "golden_iitp_base.npz")
_CONFIG = os.path.join(_REPO, "configs", "iitp_base.json")


@functools.lru_cache(maxsize=None)
def jax_fidelity_state_dict():
    """``fidelity_params`` at iitp_base, folded, as a torch state dict."""
    gz = np.load(_FIXTURE)
    hps = load_config(_CONFIG)
    gmel = jnp.asarray(gz["mel"])
    lens = jnp.full((1,), gmel.shape[1], jnp.int32)
    spec = jnp.zeros((1, gmel.shape[1], hps.data.filter_length // 2 + 1))
    return state_dict_from_jax_params(
        jax.tree.map(np.asarray, fidelity_params(hps, gmel, lens, spec)))


def port_mel_l1(state):
    """mel-L1 of the port's f32 ``SynthesizerTrn.infer`` on ``state`` (TF32
    off) against the fixture's reference waveform."""
    gz = np.load(_FIXTURE)
    thps = torch_load_config(_CONFIG)
    net = build_synthesizer(thps, weight_norm=False)
    net.load_state_dict(state, strict=True)
    net.eval()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        wav, _ = net.infer(torch.from_numpy(np.asarray(gz["mel"])),
                           torch.tensor([gz["mel"].shape[1]]), torch.from_numpy(gz["eps"]),
                           noise_scale=float(gz["noise_scale"]))
        cfg = MelConfig.from_hparams(thps)
        m_got = mel_spectrogram(wav[..., 0], cfg)
        m_ref = mel_spectrogram(torch.from_numpy(gz["wav_ref"])[None].float(), cfg)
    return float((m_got - m_ref).abs().mean())


def test_port_golden_fixture_mel_l1():
    l1 = port_mel_l1(jax_fidelity_state_dict())
    print(f"port f32 mel-L1 vs golden fixture: {l1:.3e}")
    assert l1 <= 1e-2, l1


def test_recipe_full_width_matches_fidelity_params():
    """Every leaf of the port's recipe at iitp_base against ``fidelity_params``:
    bit for bit, apart from the folded weight of a weight-normed conv, whose
    norm is a sum whose order XLA's CPU compiler picks (rel 1e-6); then the
    port's f32 path on the recipe's weights against the fixture."""
    want = jax_fidelity_state_dict()
    got = fidelity_state_dict(torch_load_config(_CONFIG))
    assert set(got) == set(want)
    unfolded = build_synthesizer(torch_load_config(_CONFIG), weight_norm=True, device="meta")
    normed = {k[:-len(".weight_v")] for k in unfolded.state_dict() if k.endswith(".weight_v")}
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == torch.float32, k
        if k[:-len(".weight")] in normed:
            rel = ((g - w).abs() / w.abs().clamp_min(1e-30)).max().item()
            worst = max(worst, rel)
            assert rel <= 1e-6, (k, rel)
        else:
            assert torch.equal(g, w), k
    print(f"recipe vs fidelity_params: {len(want)} leaves, folded weight-normed rel {worst:.2e}")
    l1 = port_mel_l1(got)
    print(f"port f32 mel-L1 vs golden fixture on the recipe's weights: {l1:.3e}")
    assert l1 <= 1e-2, l1
