"""The unpacked MRF stage and the ``pallas_stage2`` decoder route against JAX.

- ``mrf_stage_unpacked`` (its plain version on a CPU tensor) against
  ``fused_mrf_stage`` in Pallas interpret mode at C = 128, in tiles of 64
  rows, so the 60-row halo crosses several seams.
- ``decoder_apply(pallas_stage2=True)`` against the JAX function on a small
  config that still takes the route: stage 1 at 128 channels with a length
  that is a multiple of 512 (the unpacked kernel), stage 2 at 64 channels
  folded into the up stage without the tail, stage 3 at 32 channels with it;
  one branch (k = 3) keeps it cheap.
- ``decoder_apply(pallas_stage2=False)`` computes, bit for bit, the stage
  routing the decoder had before the option existed.

Tolerances as in tests/test_torch_mrf.py: f32 3e-4 (summation order; the
decoder 5e-4, the bound of tests/test_fast_decoder.py); bf16 one residual
pair under 1% of the elements differing; a full bf16 stage or decoder within
half of JAX's own bf16-versus-f32 deviation on the same inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smart_vocoder_torch.kernels.decoder as tdec
from smart_vocoder_torch.kernels import mrf as tmrf
from smart_vocoder_torch.nn import fold_weight_norm as torch_fold
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.kernels import decoder as jdec
from smart_vocoder_tpu.kernels import mrf as jmrf
from smart_vocoder_tpu.models import synthesizer as jsyn
from smart_vocoder_tpu.nn import fold_weight_norm as jax_fold
from test_torch_package import random_params

KS, DIL = (3, 7, 11), (1, 3, 5)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------- the unpacked stage
def _stage_inputs(ks, dil, c=128, t=256, scale=0.02):
    rng = np.random.default_rng(c + len(ks))
    x = _bf16(rng.normal(0, 0.5, (2, t, c)))
    br = [tuple(_bf16(rng.normal(0, scale, s)) for s in
                ((len(dil), k, c, c), (len(dil), c), (len(dil), k, c, c), (len(dil), c)))
          for k in ks]
    return x, br


def _jax_stage(x, br, ks, dil, dtype):
    return _f(jmrf.fused_mrf_stage(jnp.asarray(x, dtype),
                                   [tuple(jnp.asarray(a) for a in b) for b in br], ks, dil,
                                   tile=64, interpret=True))


def _port_stage(x, br, ks, dil, dtype):
    got = tmrf.mrf_stage_unpacked(torch.from_numpy(x).to(dtype),
                                  [tuple(torch.from_numpy(a) for a in b) for b in br], ks, dil)
    assert got.dtype == dtype and got.shape == x.shape
    return _f(got)


def test_mrf_stage_unpacked_f32_matches_pallas():
    x, br = _stage_inputs(KS, DIL)
    np.testing.assert_allclose(_port_stage(x, br, KS, DIL, torch.float32),
                               _jax_stage(x, br, KS, DIL, jnp.float32), rtol=3e-4, atol=3e-4)


def test_mrf_stage_unpacked_bf16_rounding_points_match_pallas():
    x, br = _stage_inputs((3,), (1,), scale=0.1)
    got = _port_stage(x, br, (3,), (1,), torch.bfloat16)
    want = _jax_stage(x, br, (3,), (1,), jnp.bfloat16)
    assert (got != want).mean() < 0.01


def test_mrf_stage_unpacked_bf16_matches_pallas():
    x, br = _stage_inputs(KS, DIL)
    want = _jax_stage(x, br, KS, DIL, jnp.bfloat16)
    exact = _jax_stage(x, br, KS, DIL, jnp.float32)
    got = _port_stage(x, br, KS, DIL, torch.bfloat16)
    jax_err, port_err = np.abs(want - exact).mean(), np.abs(got - want).mean()
    assert port_err < 0.5 * jax_err, (port_err, jax_err)


# --------------------------------------------------- the pallas_stage2 route
STAGE2_ARGS = ("1", (3,), ((1, 3, 5),), (2, 2, 2), 256, (4, 4, 4))


@pytest.fixture(scope="module")
def stage2_setup():
    """Folded decoder weights of the small stage-2 config and a latent of
    256 frames (stage 1 runs 512 rows, a multiple of 512)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 0.5, (1, 256, 16)).astype(np.float32)
    gen = jsyn.Generator(16, *STAGE2_ARGS)
    shapes = jax.eval_shape(lambda k: gen.init(k, jnp.asarray(x))["params"], jax.random.key(0))
    params = jax.tree.map(np.asarray, jax_fold(random_params(shapes, 6)))
    return params, state_dict_from_jax_params(params), x


def _decode(setup, lib, dtype):
    params, state, x = setup
    if lib == "jax":
        jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        return _f(jdec.decoder_apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x),
                                     jdec.DecoderConfig(*STAGE2_ARGS), use_pallas=True,
                                     interpret=True, dtype=jdt, pallas_stage2=True))
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return _f(tdec.decoder_apply(state, torch.from_numpy(x), tdec.DecoderConfig(*STAGE2_ARGS),
                                 dtype=tdt, pallas_stage2=True))


def test_stage2_route_takes_the_kernels(stage2_setup, monkeypatch):
    calls = []
    for name in ("mrf_stage_unpacked", "up_mrf_stage", "mrf_stage"):
        real = getattr(tdec, name)
        monkeypatch.setattr(tdec, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append((_n, tuple(a[0].shape), kw.get("post_weight") is not None)) or
            _r(*a, **kw)))
    _decode(stage2_setup, "port", "bf16")
    assert calls == [("mrf_stage_unpacked", (1, 512, 128), False),
                     ("up_mrf_stage", (1, 512, 128), False),
                     ("up_mrf_stage", (1, 1024, 64), True)]


def test_stage2_route_f32_matches_jax(stage2_setup):
    got, want = _decode(stage2_setup, "port", "f32"), _decode(stage2_setup, "jax", "f32")
    assert got.shape == want.shape == (1, 2048, 1)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_stage2_route_bf16_matches_jax(stage2_setup):
    want = _decode(stage2_setup, "jax", "bf16")
    exact = _decode(stage2_setup, "jax", "f32")
    got = _decode(stage2_setup, "port", "bf16")
    jax_err, port_err = np.abs(want - exact).mean(), np.abs(got - want).mean()
    assert port_err < 0.5 * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("dtype,hifi", [("f32", 0), ("bf16", 0), ("bf16", 2)])
def test_stage2_route_with_packed_weights_gives_the_same_bits(stage2_setup, dtype, hifi):
    """``pack_decoder(pallas_stage2=True)`` packs the stage that takes the
    unpacked kernel (bf16 tiles where the stage runs in bf16), and
    ``decoder_apply(packed=)`` gives the bits it gives without them."""
    _, state, x = stage2_setup
    cfg = tdec.DecoderConfig(*STAGE2_ARGS)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    packed = tdec.pack_decoder(state, cfg, tdt, hifi, pallas_stage2=True)
    kinds = [type(kernel).__name__ for _, kernel in packed]
    assert kinds[0] == ("PackedMRF" if dtype == "bf16" else "NoneType")
    xt = torch.from_numpy(x)
    got = tdec.decoder_apply(state, xt, cfg, dtype=tdt, hifi_tail=hifi, pallas_stage2=True,
                             packed=packed)
    want = tdec.decoder_apply(state, xt, cfg, dtype=tdt, hifi_tail=hifi, pallas_stage2=True)
    assert got.shape == (1, 2048, 1) and torch.equal(got, want)


# ------------------------------------------ pallas_stage2=False is unchanged
def _routing_before_stage2(p, x, cfg, dtype, hifi):
    """The stage routing of decoder_apply before ``pallas_stage2``: the last
    stage (64 -> 32) on up_mrf_stage with the tail, the one before it on
    mrf_stage, the rest on cuDNN convolutions."""
    ks, dil = tuple(cfg.resblock_kernel_sizes), tuple(cfg.resblock_dilation_sizes[0])
    early = hifi >= 2
    y = tdec._conv1d(x.transpose(1, 2), p["conv_pre.weight"], p["conv_pre.bias"], 3, dtype,
                     out_f32=early)
    n = len(cfg.upsample_rates)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        br = tdec._stage_branches(p, i, len(ks), len(dil), dtype)
        if i == n - 1:
            return tmrf.up_mrf_stage(y.transpose(1, 2), p[f"ups.{i}.weight"], p[f"ups.{i}.bias"],
                                     k, u, (k - u) // 2, br, ks, dil,
                                     post_weight=p["conv_post.weight"], hifi=hifi >= 1)
        y = tdec._conv_transpose1d(tmrf.leaky_native(y), p[f"ups.{i}.weight"],
                                   p[f"ups.{i}.bias"], u, (k - u) // 2, dtype, out_f32=early)
        if i == n - 2:
            y = tmrf.mrf_stage(y.transpose(1, 2).to(dtype), br, ks, dil, f32_storage=hifi >= 1,
                               x2=hifi >= 3).transpose(1, 2)
        else:
            y = tmrf.mrf_stage_reference(y.transpose(1, 2), br, ks, dil,
                                         mixed_f32=early).transpose(1, 2)


@pytest.mark.parametrize("dtype,hifi", [("f32", 0), ("bf16", 0), ("bf16", 2)])
def test_without_stage2_the_decoder_is_unchanged(dtype, hifi):
    """On the 128/64/32 config of the slice tests, whose routing the option
    would change, the default route is bit-identical to the routing above."""
    args = ("1", (3, 7, 11), ((1, 3, 5),) * 3, (4, 2, 2), 256, (8, 4, 4))
    rng = np.random.default_rng(8)
    gen = jsyn.Generator(16, *args)
    x = rng.normal(0, 0.5, (2, 10, 16)).astype(np.float32)
    shapes = jax.eval_shape(lambda k: gen.init(k, jnp.asarray(x))["params"], jax.random.key(0))
    p = torch_fold(state_dict_from_jax_params(random_params(shapes, 9)))
    cfg = tdec.DecoderConfig(*args)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    xt = torch.from_numpy(x)
    got = tdec.decoder_apply(p, xt, cfg, dtype=tdt, hifi_tail=hifi)
    want = _routing_before_stage2(p, xt, cfg, tdt, hifi)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)
    if dtype == "bf16":  # the option does reroute this config (stage 2 folds up)
        rerouted = tdec.decoder_apply(p, xt, cfg, dtype=tdt, hifi_tail=hifi, pallas_stage2=True)
        assert not torch.equal(got, rerouted)
