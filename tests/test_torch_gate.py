"""The port's fused gate against the JAX package's Pallas gate.

``smart_vocoder_torch.kernels.gate.fused_gate`` runs its plain version on a
CPU tensor; here it is held against ``fused_gate(interpret=True)`` with the
conditioning absent, full and broadcast (the conditioned WN's (B, 1, 2H)). The
Triton kernel itself is held against the plain version on the card, by
tests/test_torch_cuda.py.

Tolerances: f32 1e-6 (the bound tests/test_kernels.py holds the Pallas gate
to against the jnp gate). bf16: JAX rounds after the add, the tanh, the
sigmoid and the product, the port computes in f32 and rounds once, so it is
held to the exact f32 result within one bf16 ulp, and to JAX within JAX's own
distance from that result plus one ulp.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.kernels.gate import fused_gate, fused_gate_plain
from smart_vocoder_tpu.kernels.gate import fused_gate as jax_fused_gate

SHAPE = (3, 50, 24)
G_SHAPES = {"none": None, "full": SHAPE, "broadcast": (3, 1, 24)}


def _inputs(g_kind):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, SHAPE).astype(np.float32)
    g = None if G_SHAPES[g_kind] is None else rng.normal(0, 1, G_SHAPES[g_kind]).astype(np.float32)
    return x, g


def _exact(x, g):
    a = x.astype(np.float64) + (0 if g is None else g.astype(np.float64))
    h = a.shape[-1] // 2
    return np.tanh(a[..., :h]) / (1 + np.exp(-a[..., h:]))


@pytest.mark.parametrize("g_kind", list(G_SHAPES))
def test_fused_gate_f32_matches_pallas(g_kind):
    x, g = _inputs(g_kind)
    want = jax_fused_gate(jnp.asarray(x), None if g is None else jnp.asarray(g), interpret=True)
    got = fused_gate(torch.from_numpy(x), None if g is None else torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (3, 50, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


@pytest.mark.parametrize("g_kind", list(G_SHAPES))
def test_fused_gate_bf16_matches_pallas(g_kind):
    x, g = _inputs(g_kind)
    xb = torch.from_numpy(x).bfloat16()
    gb = None if g is None else torch.from_numpy(g).bfloat16()
    want = jax_fused_gate(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                          None if gb is None else jnp.asarray(gb.float().numpy(), jnp.bfloat16),
                          interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = fused_gate(xb, gb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    exact = _exact(xb.float().numpy(), None if gb is None else gb.float().numpy())
    ulp = np.abs(exact) * 2.0 ** -7  # one bf16 ulp of a value is at most this
    assert (np.abs(got - exact) <= ulp).all()
    assert (np.abs(got - want) <= np.abs(want - exact) + ulp).all()


def test_fused_gate_takes_any_leading_shape_and_rejects_odd_widths():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 5, 8)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (5, 8)).astype(np.float32))
    np.testing.assert_allclose(fused_gate(x, g).numpy(),
                               _exact(x.numpy(), g.numpy()), atol=1e-6)
    assert torch.equal(fused_gate(x, g), fused_gate_plain(x, g))
    with pytest.raises(ValueError):
        fused_gate(torch.zeros(2, 7))
    with pytest.raises(TypeError):
        fused_gate(torch.zeros(2, 8, dtype=torch.float16))
