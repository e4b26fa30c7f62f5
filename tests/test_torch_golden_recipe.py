"""The fidelity weight recipe without JAX, held to JAX.

- ``utils/jax_random.py`` against ``jax.random``: key data of ``key`` and
  ``fold_in``, and ``uniform`` bit for bit; ``normal`` within 1e-6 (numpy's
  ``log1p`` inside the inverse error function may sit an ulp from XLA's).
- ``utils/golden.py:fidelity_state_dict`` against the flax init of the
  weight-normed generator under ``jax.random.key(1)`` with the ``conv_post``
  gain, as ``smart_vocoder_tpu/utils/golden.py:fidelity_params`` makes it, at
  a tiny single-speaker and a tiny multi-speaker config: the same keys, every
  drawn value bit for bit, the speaker table within 1e-6, and ``weight_g``
  (and the folded weight of a weight-normed conv) within rel 1e-6: a sum of
  squares whose order XLA's CPU compiler picks per shape.
- ``fidelity_inputs`` against the JAX package's.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.models import build_synthesizer as torch_build
from smart_vocoder_torch.utils import jax_random
from smart_vocoder_torch.utils.golden import (
    CONV_POST_GAIN,
    fidelity_inputs,
    fidelity_state_dict,
)
from smart_vocoder_torch.utils.torch_compat import (
    path_to_torch_key,
    state_dict_from_jax_params,
    torch_key_to_path,
)
from smart_vocoder_tpu.models import build_synthesizer as jax_build
from smart_vocoder_tpu.nn import fold_weight_norm as jax_fold
from smart_vocoder_tpu.utils import golden as jax_golden
from smart_vocoder_tpu.utils.torch_compat import torch_key_to_path as jax_torch_key_to_path
from test_torch_package import TINY_CFG, tiny_hparams

SEEDS = [0, 1, 4, 1234, 2 ** 31 + 5]
DATA = [0, 1, 7, 0xDEADBEEF, 2 ** 32 - 1]


def multi_speaker_cfg():
    cfg = copy.deepcopy(TINY_CFG)
    cfg["data"]["n_speakers"] = 3
    cfg["model"].update(gin_channels=8, use_spk_embed=True)
    return cfg


CONFIGS = {"single": lambda: TINY_CFG, "multi": multi_speaker_cfg}


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    np.testing.assert_array_equal(jax_random.key(seed), np.asarray(jax.random.key_data(k)))
    for d in DATA:
        want = np.asarray(jax.random.key_data(jax.random.fold_in(k, d)))
        np.testing.assert_array_equal(jax_random.fold_in(jax_random.key(seed), d), want)


@pytest.mark.parametrize("shape,bound", [((7,), 0.3), ((8, 4, 3), 0.1), ((300, 300), 0.05),
                                         ((70001,), 1.0), ((512, 80, 7), 1 / np.sqrt(560))])
def test_uniform_matches_jax_bit_for_bit(shape, bound):
    key, data = 1, 12345
    want = np.asarray(jax.random.uniform(jax.random.fold_in(jax.random.key(key), data), shape,
                                         jnp.float32, -bound, bound))
    got = jax_random.uniform(jax_random.fold_in(jax_random.key(key), data), shape, -bound, bound)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,shape", [(0, (1, 200, 80)), (4, (1, 200, 192)), (7, (3, 65537))])
def test_normal_within_1e6_of_jax(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape))
    got = jax_random.normal(jax_random.key(seed), shape)
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fidelity_inputs_match_jax():
    jhps, thps = tiny_hparams()
    mel, lens, eps = fidelity_inputs(thps)
    jmel, jlens, jeps = jax_golden.fidelity_inputs(jhps)
    np.testing.assert_array_equal(lens, np.asarray(jlens))
    np.testing.assert_allclose(mel, np.asarray(jmel), rtol=0, atol=2e-6)  # 2x the normal
    np.testing.assert_allclose(eps, np.asarray(jeps), rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def jax_init(config: str):
    """``fidelity_params``' unfolded init at a tiny config, a speaker id
    passed where the config has speakers (the table is made only when used),
    as a torch state dict."""
    jhps, _ = tiny_hparams(CONFIGS[config]())
    net = jax_build(jhps, weight_norm=True)
    t = 32
    mel = jnp.zeros((1, t, jhps.data.n_mel_channels))
    spec = jnp.zeros((1, t, jhps.data.filter_length // 2 + 1))
    lens = jnp.full((1,), t, jnp.int32)
    sid = jnp.zeros((1,), jnp.int32) if config == "multi" else None

    def init(k1, k2):
        params = net.init(k1, mel, lens, spec, lens, k2, sid=sid)["params"]
        params["dec"]["conv_post"]["weight"] = (
            params["dec"]["conv_post"]["weight"] * CONV_POST_GAIN)
        return params

    keys = (jax.random.key(jax_golden.INIT_KEYS[0]), jax.random.key(jax_golden.INIT_KEYS[1]))
    return jax.tree.map(np.asarray, jax.jit(init)(*keys))


@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("config", ["single", "multi"])
def test_recipe_matches_the_jax_init(config, folded):
    params = jax_init(config)
    normed = {k[:-len(".weight_v")] for k in state_dict_from_jax_params(params)
              if k.endswith(".weight_v")}
    if folded:
        params = jax.tree.map(np.asarray, jax_fold(params))
    want = state_dict_from_jax_params(params)
    _, thps = tiny_hparams(CONFIGS[config]())
    got = fidelity_state_dict(thps, folded=folded)
    assert set(got) == set(want)
    assert list(got) == list(torch_build(thps, weight_norm=not folded, device="meta").state_dict())
    assert ("emb_g.weight" in got) == (config == "multi")
    for k, w in want.items():
        g = got[k]
        assert g.dtype == torch.float32 and g.shape == w.shape, k
        if k.endswith(".weight_g") or (folded and k[:-len(".weight")] in normed):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6, atol=0, err_msg=k)
        elif k == "emb_g.weight":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
        else:
            assert torch.equal(g, w), k


def test_key_paths_invert_the_bridge():
    """``torch_key_to_path`` is the JAX package's inverse of the bridge's
    names on every key of a conditioned generator, and the bridge maps each
    path back to its key."""
    keys = list(state_dict_from_jax_params(jax_init("multi")))
    assert "emb_g.weight" in keys and any(".cond_layer." in k for k in keys)
    for k in keys:
        assert torch_key_to_path(k) == jax_torch_key_to_path(k), k
    assert [path_to_torch_key(torch_key_to_path(k)) for k in keys] == keys
