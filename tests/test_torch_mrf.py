"""The port's MRF stage functions against the JAX package's Pallas kernels.

``smart_vocoder_torch.kernels.mrf.mrf_stage`` / ``up_mrf_stage`` run their
plain PyTorch versions on CPU tensors; here they are held against
``fused_mrf_stage_packed`` / ``fused_up_mrf_stage`` in Pallas interpret mode
(the geometries of tests/test_kernels.py and tests/test_fast_decoder.py,
several tiles per sequence so the halos cross seams), in every precision mode,
and the decoder's plain stage against ``mrf_stage_reference``. The CUDA
kernels themselves are held against these plain versions on the card, by
tests/test_torch_cuda.py.

Tolerances:
- f32 and hi/lo (x2 / hifi) modes: 3e-4, the bound tests/test_kernels.py
  holds the Pallas kernels to against the jnp reference (f32 summation order;
  the hi/lo split reconstructs an f32 operand to ~2^-16).
- modes that round to bf16 (bf16, f32_storage): both sides round at the same
  points, but a different f32 summation order can flip one bf16 rounding,
  and the residual chains carry the flip on. The bound is stated against
  JAX's own error from bf16 at the same inputs (its bf16 result against its
  f32 result): the port must sit a small fraction of that away from JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.kernels import mrf as tmrf
from smart_vocoder_tpu.kernels import mrf as jmrf

KS, DIL = (3, 7, 11), (1, 3, 5)


def _branches(rng, c, scale=0.05):
    out = []
    for k in KS:
        out.append(tuple(rng.normal(0, scale, s).astype(np.float32)
                         for s in ((3, k, c, c), (3, c), (3, k, c, c), (3, c))))
    return out


def _jb(branches, dtype=jnp.float32):
    return [tuple(jnp.asarray(a, dtype) for a in br) for br in branches]


def _tb(branches):
    return [tuple(torch.from_numpy(a) for a in br) for br in branches]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


# ---------------------------------------------------------------- kernel 1
@pytest.mark.parametrize("c", [32, 64])
def test_mrf_stage_f32_matches_pallas(c):
    rng = np.random.default_rng(c)
    x = rng.normal(0, 0.3, (2, 512, c)).astype(np.float32)
    br = _branches(rng, c)
    want = jmrf.fused_mrf_stage_packed(jnp.asarray(x), _jb(br), KS, DIL, tile=32,
                                       interpret=True)
    got = tmrf.mrf_stage(torch.from_numpy(x), _tb(br), KS, DIL)
    assert got.dtype == torch.float32 and got.shape == (2, 512, c)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


def _stage3_inputs(ks=KS, dil=DIL, scale=0.1):
    rng = np.random.default_rng(11)
    c, t = 64, 256
    x = _bf16(rng.normal(0, 0.5, (2, t, c)))
    br = [tuple(_bf16(rng.normal(0, scale, s)) for s in
                ((len(dil), k, c, c), (len(dil), c), (len(dil), k, c, c), (len(dil), c)))
          for k in ks]
    return x, br


def test_mrf_stage_x2_matches_pallas():
    x, br = _stage3_inputs()
    want = jmrf.fused_mrf_stage_packed(jnp.asarray(x, jnp.bfloat16), _jb(br), KS, DIL,
                                       tile=32, interpret=True, x2=True)
    got = tmrf.mrf_stage(torch.from_numpy(x).bfloat16(), _tb(br), KS, DIL, x2=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("f32_storage", [False, True], ids=["bf16", "f32_storage"])
def test_mrf_stage_rounding_points_match_pallas(f32_storage):
    """One residual pair: the port rounds where the Pallas kernel rounds, so
    only a rare summation-order flip of one bf16 rounding separates them
    (measured 0.01% of elements; a misplaced rounding moves most of them).
    f32 storage outputs f32, where summation order alone moves the last bits:
    a difference counts above 1e-5."""
    x, br = _stage3_inputs(ks=(3,), dil=(1,))
    want = jmrf.fused_mrf_stage_packed(jnp.asarray(x, jnp.bfloat16), _jb(br), (3,), (1,),
                                       tile=32, interpret=True, f32_storage=f32_storage)
    got = tmrf.mrf_stage(torch.from_numpy(x).bfloat16(), _tb(br), (3,), (1,),
                         f32_storage=f32_storage)
    diff = np.abs(_np(got) - _np(want))
    assert (diff > (1e-5 if f32_storage else 0.0)).mean() < 0.01


@pytest.mark.parametrize("f32_storage", [False, True], ids=["bf16", "f32_storage"])
def test_mrf_stage_rounding_modes_match_pallas(f32_storage):
    """The full stage: the flips of one bf16 rounding spread along the 18-conv
    chains but stay at the ulp level. Weights at 0.02 keep the chains' gain
    below 1 so they do not grow either. Bound: the mean deviation from JAX is
    under half (bf16) or a tenth (f32 storage, whose flips are confined to
    conv operands) of JAX's own deviation from its f32 result; f32 storage is
    also held to 3e-4."""
    x, br = _stage3_inputs(scale=0.02)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jmrf.fused_mrf_stage_packed(xj, _jb(br), KS, DIL, tile=32, interpret=True,
                                       f32_storage=f32_storage)
    exact = jmrf.fused_mrf_stage_packed(jnp.asarray(x), _jb(br), KS, DIL, tile=32,
                                        interpret=True)
    got = tmrf.mrf_stage(torch.from_numpy(x).bfloat16(), _tb(br), KS, DIL,
                         f32_storage=f32_storage)
    assert got.dtype == (torch.float32 if f32_storage else torch.bfloat16)
    jax_err = np.abs(_np(want) - _np(exact)).mean()
    port_err = np.abs(_np(got) - _np(want)).mean()
    assert port_err < (0.1 if f32_storage else 0.5) * jax_err, (port_err, jax_err)
    if f32_storage:
        np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


# ---------------------------------------------------------------- kernel 2
def _stage4_inputs(rng, cin=64, cout=32, tu=256, round_weights=False, ks=KS, dil=DIL):
    r = _bf16 if round_weights else (lambda a: a)
    up_w = r(rng.normal(0, 0.1, (cin, cout, 4)).astype(np.float32))
    up_b = r(rng.normal(0, 0.1, (cout,)).astype(np.float32))
    n = len(dil)
    br = [tuple(r(rng.normal(0, 0.1, s).astype(np.float32))
                for s in ((n, k, cout, cout), (n, cout), (n, k, cout, cout), (n, cout)))
          for k in ks]
    post = r(rng.normal(0, 0.1, (1, cout, 7)).astype(np.float32))
    u = rng.normal(0, 0.5, (2, tu, cin)).astype(np.float32)
    return u, up_w, up_b, br, post


def _up_args(u, up_w, up_b, br, post, lib, ks=KS, dil=DIL):
    if lib is jmrf:
        return (u, jnp.asarray(up_w), jnp.asarray(up_b), 4, 2, 1, _jb(br), ks, dil)
    return (u, torch.from_numpy(up_w), torch.from_numpy(up_b), 4, 2, 1, _tb(br), ks, dil)


@pytest.mark.parametrize("with_post", [True, False], ids=["post", "no_post"])
def test_up_mrf_stage_f32_matches_pallas(with_post):
    """Multi-tile seams with the conv_post tail folded in (the additive
    branch + post halo of test_fold_post_multi_tile_seams)."""
    u, up_w, up_b, br, post = _stage4_inputs(np.random.default_rng(7))
    want = jmrf.fused_up_mrf_stage(
        *_up_args(jnp.asarray(u), up_w, up_b, br, post, jmrf), tile=32, interpret=True,
        post_weight=jnp.asarray(post) if with_post else None)
    got = tmrf.up_mrf_stage(*_up_args(torch.from_numpy(u), up_w, up_b, br, post, tmrf),
                            post_weight=torch.from_numpy(post) if with_post else None)
    assert got.shape == want.shape == (2, 512, 1 if with_post else 32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


def test_up_mrf_stage_hifi_matches_pallas():
    u, up_w, up_b, br, post = _stage4_inputs(np.random.default_rng(11), tu=128)
    want = jmrf.fused_up_mrf_stage(*_up_args(jnp.asarray(u), up_w, up_b, br, post, jmrf),
                                   tile=32, interpret=True, post_weight=jnp.asarray(post),
                                   hifi=True)
    got = tmrf.up_mrf_stage(*_up_args(torch.from_numpy(u), up_w, up_b, br, post, tmrf),
                            post_weight=torch.from_numpy(post), hifi=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


@pytest.mark.parametrize("geometry", ["one_pair", "stage_with_post"])
def test_up_mrf_stage_bf16_matches_pallas(geometry):
    """bf16 mode. One residual pair without the tail: the rounding points
    match (under 1% of samples differ, a summation-order flip each). The full
    stage with the tail: the flips spread through the chains and into
    conv_post's bf16 output, so the bound is the mean deviation from JAX
    under three quarters of JAX's own bf16-versus-f32 deviation (measured
    0.53)."""
    one = geometry == "one_pair"
    ks, dil = ((3,), (1,)) if one else (KS, DIL)
    u, up_w, up_b, br, post = _stage4_inputs(np.random.default_rng(5), tu=128,
                                             round_weights=True, ks=ks, dil=dil)
    u = _bf16(u)
    pw = None if one else post
    want = jmrf.fused_up_mrf_stage(
        *_up_args(jnp.asarray(u, jnp.bfloat16), up_w, up_b, br, post, jmrf, ks, dil),
        tile=32, interpret=True, post_weight=None if one else jnp.asarray(post))
    got = tmrf.up_mrf_stage(
        *_up_args(torch.from_numpy(u).bfloat16(), up_w, up_b, br, post, tmrf, ks, dil),
        post_weight=None if one else torch.from_numpy(post))
    assert got.dtype == torch.bfloat16
    if one:
        assert (_np(got) != _np(want)).mean() < 0.01
        return
    exact = jmrf.fused_up_mrf_stage(*_up_args(jnp.asarray(u), up_w, up_b, br, post, jmrf),
                                    tile=32, interpret=True, post_weight=jnp.asarray(pw))
    jax_err = np.abs(_np(want) - _np(exact)).mean()
    port_err = np.abs(_np(got) - _np(want)).mean()
    assert port_err < 0.75 * jax_err, (port_err, jax_err)


# ------------------------------------------------- the decoder's plain stage
@pytest.mark.parametrize("mode", ["f32", "mixed_f32", "bf16"])
def test_mrf_stage_reference_matches_jax(mode):
    rng = np.random.default_rng(3)
    c = 32
    x = rng.normal(0, 0.5, (2, 96, c)).astype(np.float32)
    br = _branches(rng, c, scale=0.1)
    if mode != "f32":
        br = [tuple(_bf16(a) for a in b) for b in br]
    dt = jnp.bfloat16 if mode == "bf16" else jnp.float32
    want = jmrf.mrf_stage_reference(jnp.asarray(x, dt), _jb(br, dt), KS, DIL,
                                    mixed_f32=mode == "mixed_f32")
    xt = torch.from_numpy(x)
    tbr = _tb(br)
    if mode == "bf16":
        xt = xt.bfloat16()
        tbr = [tuple(a.bfloat16() for a in b) for b in tbr]
    got = tmrf.mrf_stage_reference(xt, tbr, KS, DIL, mixed_f32=mode == "mixed_f32")
    assert got.dtype == (torch.bfloat16 if mode == "bf16" else torch.float32)
    if mode == "bf16":
        exact = jmrf.mrf_stage_reference(jnp.asarray(_bf16(x)), _jb(br), KS, DIL)
        jax_err = np.abs(_np(want) - _np(exact))
        port_err = np.abs(_np(got) - _np(want))
        assert port_err.mean() < 0.5 * jax_err.mean(), (port_err.mean(), jax_err.mean())
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=3e-4, atol=3e-4)


def test_wrappers_reject_what_the_kernels_do_not_take():
    rng = np.random.default_rng(0)
    br = _tb(_branches(rng, 32))
    with pytest.raises(TypeError):
        tmrf.mrf_stage(torch.zeros(1, 64, 32, dtype=torch.float16), br, KS, DIL)
    with pytest.raises(ValueError):
        tmrf.mrf_stage(torch.zeros(1, 64, 16), br, KS, DIL)  # channels != weights
    with pytest.raises(TypeError):
        tmrf.mrf_stage_unpacked(torch.zeros(1, 64, 32, dtype=torch.float16), br, KS, DIL)
    with pytest.raises(ValueError):
        tmrf.mrf_stage_unpacked(torch.zeros(1, 64, 16), br, KS, DIL)
    with pytest.raises(ValueError):  # one kernel size per branch
        tmrf.mrf_stage_unpacked(torch.zeros(1, 64, 32), br, KS[:2], DIL)
    with pytest.raises(ValueError):  # output length would not be Tu * stride
        tmrf.up_mrf_stage(torch.zeros(1, 32, 64), torch.zeros(64, 32, 5), torch.zeros(32),
                          5, 2, 1, br, KS, DIL)
