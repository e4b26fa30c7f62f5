"""The port's bf16 train step against JAX's bf16 step.

One step of the tiny config of tests/test_torch_train_step.py from seeded
weights in JAX's tree and JAX's draws, computed in bf16 over f32 master weights
(``tpu.bf16_run``) on both sides. The repo's rule that bf16 is bounded by
what bf16 costs: each loss of the port's bf16 step is within twice JAX's own
bf16-to-f32 distance on the same inputs of JAX's bf16 value, or within rel
1e-3 of it, whichever is larger. Every metric is finite, and the port's
parameters stay f32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.training import make_train_step
from test_torch_train_step import (
    batches,
    jax_draws,
    jax_state,
    jax_step,
    port_state,
    train_hparams,
)
from test_torch_streaming import one_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def one_step():
    jhps, thps = train_hparams(bf16=True)
    assert thps.tpu.bf16_run
    jb, tb = batches(jhps)
    js = jax_state(jhps, jb, jax_init=False)
    key = jax.random.key(1)
    _, want16 = jax_step(jhps, jnp.bfloat16)(js, jb, key)
    _, want32 = jax_step(jhps, jnp.float32)(js, jb, key)
    state = port_state(thps, js)
    state, got = make_train_step(thps, device="cpu")(state, tb, **jax_draws(jhps, key))
    as_np = lambda m: {k: np.asarray(v, np.float32) for k, v in m.items()}  # noqa: E731
    return state, {k: v.float().numpy() for k, v in got.items()}, as_np(want16), as_np(want32)


def test_bf16_losses_within_the_cost_of_bf16(one_step):
    _, got, want16, want32 = one_step
    names = [k for k in want16 if k.startswith("loss/")]
    assert len(names) == 5 + 3 * 6
    for k in names:
        dist = abs(float(got[k]) - float(want16[k]))
        cost = abs(float(want16[k]) - float(want32[k]))
        bound = max(2 * cost, 1e-3 * abs(float(want16[k])))
        assert dist <= bound, (k, float(got[k]), float(want16[k]), float(want32[k]))


def test_bf16_step_finite_with_f32_master_weights(one_step):
    state, got, _, _ = one_step
    for k, v in got.items():
        assert np.all(np.isfinite(v)), k
    for net in (state.net_g, state.net_d):
        assert all(p.dtype == torch.float32 for p in net.parameters())
    for opt in (state.opt_g, state.opt_d):
        assert all(s["exp_avg"].dtype == torch.float32 for s in opt.state.values())
