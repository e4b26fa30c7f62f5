"""The port's modules against their flax counterparts, on bridged weights.

Each flax module's parameter tree (shapes from ``jax.eval_shape`` of its
init, seeded numpy values) crosses through ``state_dict_from_jax_params``
into the torch module with ``strict=True``; the same numpy inputs go through
both, time-major on the JAX side and channel-first on the port's. f32 at
atol/rtol 1e-4, as tests/test_fast_decoder.py holds the JAX fast decoder to
the flax Generator, with JAX at matmul precision "highest".
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch import nn as tnn
from smart_vocoder_torch.models import synthesizer as tsyn
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu import nn as jnn
from smart_vocoder_tpu.models import synthesizer as jsyn
from test_torch_package import random_params

TOL = dict(rtol=1e-4, atol=1e-4)


def _bridge(flax_mod, torch_mod, *args, seed=0, **kw):
    """Seeded params for ``flax_mod`` loaded into ``torch_mod``; returns them."""
    shapes = jax.eval_shape(lambda k: flax_mod.init(k, *args, **kw)["params"],
                            jax.random.key(0))
    params = random_params(shapes, seed)
    torch_mod.load_state_dict(state_dict_from_jax_params(params), strict=True)
    return jax.tree.map(jnp.asarray, params)


def _t(a):  # time-major numpy -> channel-first torch
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(a, 1, 2)))


def _j(t):  # channel-first torch -> time-major numpy
    return np.swapaxes(t.detach().numpy(), 1, 2)


def _mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("conditioned", [False, True])
def test_wn_matches(conditioned):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 40, 16)).astype(np.float32)
    mask = _mask([40, 29], 40)
    g = rng.normal(0, 1, (2, 1, 8)).astype(np.float32) if conditioned else None
    jm = jnn.WN(16, 5, 2, 3, gin_channels=8)
    tm = tnn.WN(16, 5, 2, 3, gin_channels=8, conditioned=conditioned)
    jg = None if g is None else jnp.asarray(g)
    params = _bridge(jm, tm, jnp.asarray(x), jnp.asarray(mask), g=jg)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), g=jg)
    got = tm(_t(x), _t(mask), g=None if g is None else _t(g))
    np.testing.assert_allclose(_j(got), np.asarray(want), **TOL)


def test_coupling_reverse_matches():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 40, 16)).astype(np.float32)
    mask = _mask([40, 23], 40)
    jm = jnn.ResidualCouplingLayer(16, 16, 5, 1, 2)
    tm = tnn.ResidualCouplingLayer(16, 16, 5, 1, 2)
    params = _bridge(jm, tm, jnp.asarray(x), jnp.asarray(mask), reverse=True)
    want = jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), reverse=True)
    got = tm(_t(x), _t(mask), reverse=True)
    np.testing.assert_allclose(_j(got), np.asarray(want), **TOL)
    np.testing.assert_array_equal(_j(tnn.flip_channels(_t(x))),
                                  np.asarray(jnn.flip_channels(jnp.asarray(x))))


@pytest.mark.parametrize("k", [3, 11])
def test_resblock1_matches(k):
    x = np.random.default_rng(3).normal(0, 0.5, (2, 64, 16)).astype(np.float32)
    jm, tm = jnn.ResBlock1(16, k, (1, 3, 5)), tnn.ResBlock1(16, k, (1, 3, 5))
    params = _bridge(jm, tm, jnp.asarray(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(_j(tm(_t(x))), np.asarray(want), **TOL)


def test_mel_encoder_matches():
    mel = np.random.default_rng(4).normal(-4, 2, (2, 30, 80)).astype(np.float32)
    lengths = np.array([30, 21])
    jm, tm = jsyn.MelEncoder(16, 16, n_layers=2), tsyn.MelEncoder(16, 16, n_layers=2)
    params = _bridge(jm, tm, jnp.asarray(mel), jnp.asarray(lengths))
    want = jm.apply({"params": params}, jnp.asarray(mel), jnp.asarray(lengths))
    got = tm(_t(mel), torch.from_numpy(lengths))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_j(g), np.asarray(w), **TOL)


def test_generator_matches():
    """ResBlock1 decoder with the JAX package's default channel packing (an
    exact re-layout) against the port's plain torch convolutions."""
    x = np.random.default_rng(5).normal(0, 0.5, (2, 12, 16)).astype(np.float32)
    args = (16, "1", (3, 7), ((1, 3, 5), (1, 3, 5)), (4, 2), 64, (8, 4))
    jm, tm = jsyn.Generator(*args), tsyn.Generator(*args)
    params = _bridge(jm, tm, jnp.asarray(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    got = tm(_t(x))
    assert want.shape == (2, 12 * 8, 1)
    np.testing.assert_allclose(_j(got), np.asarray(want), **TOL)


def test_posterior_encoder_matches():
    """The posterior encoder (loaded for strict state dicts; training uses
    it), with JAX's own posterior noise handed to the port."""
    rng = np.random.default_rng(6)
    spec = rng.normal(0, 1, (2, 20, 33)).astype(np.float32)
    lengths = np.array([20, 13])
    jm = jsyn.PosteriorEncoder(33, 8, 16, n_layers=2)
    tm = tsyn.PosteriorEncoder(33, 8, 16, n_layers=2)
    key = jax.random.key(9)
    params = _bridge(jm, tm, jnp.asarray(spec), jnp.asarray(lengths), key)
    want = jm.apply({"params": params}, jnp.asarray(spec), jnp.asarray(lengths), key)
    eps = np.asarray(jax.random.normal(key, (2, 20, 8), jnp.float32))
    got = tm(_t(spec), torch.from_numpy(lengths), _t(eps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_j(g), np.asarray(w), **TOL)


def test_fast_decoder_with_speaker_matches_generator():
    """decoder_apply (f32) with speaker conditioning equals the port's own
    Generator module on the same folded weights (the `cond` route)."""
    from smart_vocoder_torch.kernels.decoder import DecoderConfig, decoder_apply

    rng = np.random.default_rng(8)
    args = (16, "1", (3, 7, 11), ((1, 3, 5),) * 3, (4, 2, 2), 256, (8, 4, 4))
    jm = jsyn.Generator(*args, gin_channels=8)
    tm = tsyn.Generator(*args, gin_channels=8, conditioned=True)
    x = rng.normal(0, 0.5, (2, 10, 16)).astype(np.float32)
    g = rng.normal(0, 1, (2, 1, 8)).astype(np.float32)
    _bridge(jm, tm, jnp.asarray(x), g=jnp.asarray(g))
    cfg = DecoderConfig("1", (3, 7, 11), ((1, 3, 5),) * 3, (4, 2, 2), 256, (8, 4, 4))
    with torch.no_grad():
        want = _j(tm(_t(x), g=_t(g)))
        got = decoder_apply(tnn.fold_weight_norm(tm.state_dict()), torch.from_numpy(x), cfg,
                            g=torch.from_numpy(g), dtype=torch.float32).numpy()
    np.testing.assert_allclose(got, want, **TOL)
