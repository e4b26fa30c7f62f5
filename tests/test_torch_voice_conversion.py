"""The port's ``SynthesizerTrn.voice_conversion`` against the JAX package's.

The JAX method draws its posterior noise from an rng; the port takes it as an
argument. The noise JAX drew is recovered from its own posterior encoder on
the same rng and speaker, ``eps = (z - m_q) * exp(-logs_q)`` on valid frames
(zero past a length, where z, m_q and logs_q are masked to 0), and passed to
the port: o_hat, z, z_p and z_hat agree in f32 within 5e-4 (the bound of
tests/test_torch_slice.py), on the ``tiny_vocoder(ms=True)`` config of
tests/test_inference_api.py (two of its rows ragged).

Twins of tests/test_voice_conversion.py:32-80 on the port: shapes and
finiteness; the same speaker as source and target recovers z through the
flow and its inverse (rtol 1e-4, atol 1e-5 as there); the target speaker
changes the waveform; a model without speaker embeddings refuses.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.models import build_synthesizer as torch_build
from smart_vocoder_torch.utils.init import init_synthesizer
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.models import build_synthesizer as jax_build
from smart_vocoder_tpu.models.synthesizer import SynthesizerTrn as JaxSynth
from test_torch_package import jax_synth_params, tiny_hparams
from test_torch_streaming import one_thread, voc_cfg  # noqa: F401 (fixture)

T = 24


@pytest.fixture(scope="module")
def nets():
    jhps, thps = tiny_hparams(voc_cfg(ms=True))
    params = jax_synth_params(jhps, seed=4)
    net = torch_build(thps)
    net.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jhps, params, net.eval()


def _spec(seed, b):
    return np.random.default_rng(seed).uniform(0, 2, (b, T, 513)).astype(np.float32)


def _vc(net, spec, lens, eps, src, tgt):
    with torch.no_grad():
        return net.voice_conversion(torch.from_numpy(spec), torch.tensor(lens),
                                    torch.from_numpy(eps), torch.tensor(src), torch.tensor(tgt))


def test_voice_conversion_matches_jax(nets):
    jhps, params, net = nets
    jnet = jax_build(jhps)
    spec, lens = _spec(0, 3), np.array([T, 20, 13])
    src, tgt = np.array([1, 2, 0]), np.array([3, 0, 0])
    rng = jax.random.key(9)
    jp = {"params": jax.tree.map(jnp.asarray, params)}
    with jax.default_matmul_precision("highest"):
        o, mask, (z, z_p, z_hat) = jnet.apply(jp, jnp.asarray(spec), jnp.asarray(lens), rng,
                                              jnp.asarray(src), jnp.asarray(tgt),
                                              method=JaxSynth.voice_conversion)
        zq, m_q, logs_q, _ = jnet.apply(
            jp, jnp.asarray(spec), jnp.asarray(lens), rng, jnp.asarray(src),
            method=lambda n, y, l, r, s: n.enc_q(y, l, r, g=n._speaker(s)))
    np.testing.assert_array_equal(np.asarray(zq), np.asarray(z))  # the same draw
    valid = np.arange(T)[None, :, None] < lens[:, None, None]
    eps = np.where(valid, (np.asarray(z) - np.asarray(m_q)) * np.exp(-np.asarray(logs_q)), 0)
    got = _vc(net, spec, lens, eps.astype(np.float32), src, tgt)
    assert got[0].shape == o.shape == (3, T * 256, 1)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(mask))
    for g, w in zip((got[0], *got[2]), (o, z, z_p, z_hat)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=5e-4)


@pytest.fixture(scope="module")
def seeded():
    """The port alone, on its own seeded init."""
    _, thps = tiny_hparams(voc_cfg(ms=True))
    return init_synthesizer(torch_build(thps), 3).eval()


def test_shapes_and_finite(seeded):
    eps = np.random.default_rng(1).normal(0, 1, (2, T, 32)).astype(np.float32)
    o, mask, (z, z_p, z_hat) = _vc(seeded, _spec(2, 2), [T, 20], eps, [1, 2], [3, 0])
    assert o.shape == (2, T * 256, 1) and mask.shape == (2, T, 1)
    assert z.shape == z_p.shape == z_hat.shape == (2, T, 32)
    assert torch.isfinite(o).all()


def test_same_speaker_is_identity_through_flow(seeded):
    eps = np.random.default_rng(3).normal(0, 1, (1, T, 32)).astype(np.float32)
    _, _, (z, _, z_hat) = _vc(seeded, _spec(4, 1), [T], eps, [2], [2])
    np.testing.assert_allclose(z_hat.numpy(), z.numpy(), rtol=1e-4, atol=1e-5)


def test_speaker_embedding_changes_output(seeded):
    eps = np.random.default_rng(5).normal(0, 1, (1, T, 32)).astype(np.float32)
    outs = [_vc(seeded, _spec(6, 1), [T], eps, [0], [tgt])[0].numpy() for tgt in (1, 3)]
    assert not np.allclose(outs[0], outs[1])


def test_requires_spk_embed():
    _, thps = tiny_hparams(voc_cfg())
    net = torch_build(thps)
    with pytest.raises(ValueError, match="use_spk_embed"):
        net.voice_conversion(torch.zeros(1, T, 513), torch.tensor([T]), torch.zeros(1, T, 32),
                             torch.tensor([0]), torch.tensor([1]))
