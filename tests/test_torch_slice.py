"""The serving slice end to end: ``Vocoder.mel_to_wav`` of the port against
the JAX package's, on the same weights, mel and prior noise.

The config (tests/test_torch_package.py:TINY_CFG) is cut to 128/64/32
decoder channels, so the JAX fast decoder runs its stages 2-3 through the
Pallas kernels (interpret mode on the CPU) and stage 1 through XLA convs,
the routing iitp_base gets, and the port sends the same two stages to its
kernel wrappers (their plain versions on a CPU tensor). Two utterances of
different lengths are padded to one bucket.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.inference import Vocoder as TorchVocoder
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.inference import Vocoder as JaxVocoder
from test_torch_package import jax_synth_params, tiny_hparams

LENGTHS = np.array([24, 17])


@pytest.fixture(scope="module")
def setup():
    jhps, thps = tiny_hparams()
    params = jax_synth_params(jhps, seed=3)
    rng = np.random.default_rng(0)
    mel = rng.normal(-4, 2, (2, 24, 80)).astype(np.float32)
    eps = rng.normal(0, 1, (2, 24, jhps.model.inter_channels)).astype(np.float32)
    sd = state_dict_from_jax_params(params)
    return jhps, thps, params, sd, mel, eps


def _jax_wavs(setup, dtype, hifi=None):
    jhps, _, params, _, mel, eps = setup
    with jax.default_matmul_precision("highest"):
        voc = JaxVocoder(jhps, jax.tree.map(jnp.asarray, params), dtype=dtype, buckets=(32,),
                         use_pallas=True, hifi=hifi)
        return voc.mel_to_wav(mel, LENGTHS, eps=eps)


def _port_wavs(setup, dtype, hifi=None, use_kernels=True):
    _, thps, _, sd, mel, eps = setup
    voc = TorchVocoder(thps, sd, dtype=dtype, buckets=(32,), use_kernels=use_kernels,
                       hifi=hifi, device="cpu")
    return voc, voc.mel_to_wav(mel, LENGTHS, eps=eps)


def test_slice_f32_matches_jax(setup):
    """f32: atol 5e-4, the bound tests/test_fast_decoder.py holds the JAX
    Pallas path to against its own XLA path."""
    want = _jax_wavs(setup, jnp.float32)
    voc, got = _port_wavs(setup, torch.float32)
    assert voc.use_kernels and voc.hifi == 0
    for g, w, n in zip(got, want, LENGTHS):
        assert g.shape == w.shape == (n * 16,)
        np.testing.assert_allclose(g, w, atol=5e-4)
    # the port's module graph is its own f32 oracle: same audio
    _, plain = _port_wavs(setup, torch.float32, use_kernels=False)
    for g, p in zip(got, plain):
        np.testing.assert_allclose(g, p, atol=5e-4)


def test_slice_bf16_hifi2_matches_jax(setup):
    """bf16 at hifi level 2 (the serving headline). Both sides round at the
    same points (bf16 operands with f32 storage in the early decoder, f32
    storage in stage 2, F32 stage 3 with bf16 weights, f32 prior), and f32
    summation order flips a rounding now and then, independently on each
    side. Bounds: the port sits as far from the f32 result as JAX does (within
    10%: the same fidelity), and under half that distance from JAX (measured
    0.28 on the decoder alone)."""
    want = _jax_wavs(setup, jnp.bfloat16, hifi=2)
    voc, got = _port_wavs(setup, torch.bfloat16, hifi=2)
    assert voc.hifi == 2
    exact = _jax_wavs(setup, jnp.float32)

    def dist(a, b):
        return np.mean([np.abs(x - y).mean() for x, y in zip(a, b)])

    assert all(np.isfinite(g).all() for g in got)
    jax_err, port_exact_err = dist(want, exact), dist(got, exact)
    assert abs(port_exact_err - jax_err) < 0.1 * jax_err, (port_exact_err, jax_err)
    assert dist(got, want) < 0.5 * jax_err, (dist(got, want), jax_err)


def test_reference_checkpoint_and_copy_synthesis(setup, tmp_path):
    """A reference-format ``G_*.pth`` ({model, iteration, ...}, with the
    cond_layer / cond keys an unconditioned model lacks) loads strictly through
    ``Vocoder.from_torch_checkpoint``; ``wav_to_wav`` re-synthesizes a
    waveform through the port's own mel front end."""
    import json

    from smart_vocoder_torch.models import build_synthesizer
    from smart_vocoder_torch.utils.torch_compat import load_reference_generator
    from test_torch_package import TINY_CFG

    _, thps, _, sd, mel, eps = setup
    payload = dict(sd)
    payload["flow.flows.0.enc.cond_layer.weight_v"] = torch.zeros(64, 256, 1)
    payload["dec.cond.weight"] = torch.zeros(256, 256, 1)
    pth = tmp_path / "G_7.pth"
    torch.save({"model": payload, "iteration": 7, "optimizer": {}, "learning_rate": 0.0}, pth)
    cfg = tmp_path / "config.json"
    cfg.write_text(json.dumps(TINY_CFG))

    assert load_reference_generator(str(pth), build_synthesizer(thps)) == 7
    voc = TorchVocoder.from_torch_checkpoint(str(cfg), str(pth), dtype=torch.float32,
                                             buckets=(32,), device="cpu")
    _, direct = _port_wavs(setup, torch.float32)
    for g, w in zip(voc.mel_to_wav(mel, LENGTHS, eps=eps), direct):
        np.testing.assert_array_equal(g, w)

    wav = 0.3 * np.sin(np.arange(80 * 16 + 5) * 0.05).astype(np.float32)
    out = voc.wav_to_wav(wav, seed=1)  # 80 frames: past the last bucket, unpadded
    assert out.shape == (80 * 16,) and np.isfinite(out).all()


def test_no_device_means_the_card(setup, monkeypatch, tmp_path):
    """``device=None`` is the CUDA card: without one ``Vocoder`` and
    ``from_torch_checkpoint`` raise (the latter before it reads a file)
    instead of carrying on on the CPU, which only ``device="cpu"`` selects."""
    _, thps, _, sd, _, _ = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchVocoder(thps, sd, dtype=torch.float32, buckets=(32,))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TorchVocoder.from_torch_checkpoint(str(tmp_path / "absent.json"),
                                           str(tmp_path / "absent.pth"))
    assert TorchVocoder(thps, sd, dtype=torch.float32, buckets=(32,),
                        device="cpu").device.type == "cpu"
