"""The port's train step under ``use_spectral_norm`` against the JAX step.

The tiny config and harness of tests/test_torch_train_step.py, with every
discriminator conv spectral-normed, on seeded weights in JAX's tree (no
zero-initialised layer, so every parameter has a gradient at step 1): the
port's ``weight_u`` buffers start from the same ``spectral`` collection. Steps 1-3 agree as the weight-norm step
does (metrics within rel 1e-4 at step 1 and 1e-3 after, parameters after
step 1 within 1e-6 for >= 99.9 % of elements and 2 lr + 1e-6 for all), and
after each step every ``weight_u`` equals JAX's within 1e-5: four power
iterations a step, real and generated apart in each phase. As
tests/test_train_step.py:155 holds JAX, every ``u`` of more than one element
moves from step to step (a 1-element ``u`` is +-1, a fixed point).
"""

import jax
import numpy as np
import pytest

from smart_vocoder_torch.utils.torch_compat import discriminator_state_dict_from_jax
from test_torch_train_step import (
    assert_metrics_close,
    assert_params_after_one_step,
    run_both,
    train_hparams,
)
from test_torch_streaming import one_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def steps():
    jhps, thps = train_hparams(spectral_norm=True)
    return thps, run_both(jhps, thps, keys=(1, 2, 3), jax_init=False)


def test_metrics_match_jax(steps):
    _, out = steps
    assert_metrics_close(out["port"][0], out["jax"][0], 1e-4, 1)
    for i in (1, 2):
        assert_metrics_close(out["port"][i], out["jax"][i], 1e-3, i + 1)


def test_params_after_step_one_match_jax(steps):
    thps, out = steps
    assert_params_after_one_step(out, thps.train.learning_rate)


def test_weight_u_advances_as_jax(steps):
    _, out = steps
    prev = None
    for i, (js, (_, sd_d)) in enumerate(zip(out["jax_states"][1:], out["port_states"])):
        want = discriminator_state_dict_from_jax({}, jax.tree.map(np.asarray, js.spectral_d))
        assert want and all(k.endswith("weight_u") for k in want)
        for k, u in want.items():
            np.testing.assert_allclose(sd_d[k].numpy(), u.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=f"step {i + 1} {k}")
        if prev is not None:
            multi = [k for k in want if want[k].numel() > 1]
            assert all(not np.array_equal(sd_d[k].numpy(), prev[k].numpy()) for k in multi)
        prev = sd_d
