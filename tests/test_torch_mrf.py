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


# ------------------------------------------- the packed-MRF variants' options
def _chain_without_masking(x, branches, mode):
    """The ``nomask`` function stated directly: the branch chains as valid
    convolutions over x extended by zeros, nothing re-zeroed in between, so a
    conv's bias leaks into the padding and back within one radius of the ends.
    x (B, T, C) f32 -> f32 (B, T, C)."""
    import torch.nn.functional as F

    t = x.shape[1]
    acc = 0
    for (w1, b1, w2, b2), k in zip(branches, KS):
        r2 = (k - 1) // 2
        rb = sum(r2 * d + r2 for d in DIL)
        xb = F.pad(x.transpose(1, 2), (rb, rb))
        for j, d in enumerate(DIL):
            h = tmrf._store(F.conv1d(tmrf._operand(xb, mode), w1[j].permute(2, 1, 0), b1[j],
                                     dilation=d), mode)
            y = tmrf._store(F.conv1d(tmrf._operand(h, mode), w2[j].permute(2, 1, 0), b2[j]),
                            mode)
            cut = r2 * d + r2
            xb = tmrf._store(y + xb[..., cut:-cut], mode)
        assert xb.shape[-1] == t
        acc = acc + xb
    return (acc / len(branches)).transpose(1, 2)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_mrf_stage_without_edge_masking(mode):
    """``mask_edges=False`` against the direct statement above; beyond one
    stage radius from the ends it is the masked stage, within it it is not."""
    rng = np.random.default_rng(21)
    c, t = 32, 300
    x = torch.from_numpy(rng.normal(0, 0.5, (2, t, c)).astype(np.float32))
    br = _tb(_branches(rng, c))
    if mode == "bf16":
        x = x.bfloat16()
        br = [tuple(a.bfloat16().float() for a in b) for b in br]
    got = tmrf.mrf_stage(x, br, KS, DIL, mask_edges=False)
    want = _chain_without_masking(x.float(), br, tmrf.BF16 if mode == "bf16" else tmrf.F32)
    assert got.dtype == x.dtype and got.shape == (2, t, c)
    if mode == "f32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)
    else:  # same rounding points: only summation-order flips of one rounding
        assert (_np(got) != _np(want.bfloat16())).mean() < 0.01
    masked = tmrf.mrf_stage(x, br, KS, DIL)
    r = tmrf.stage_radius(KS, DIL)
    if mode == "f32":
        np.testing.assert_allclose(_np(got)[:, r:-r], _np(masked)[:, r:-r], rtol=1e-5, atol=1e-5)
    else:
        assert (_np(got)[:, r:-r] != _np(masked)[:, r:-r]).mean() < 0.01
    assert np.abs(_np(got)[:, :r] - _np(masked)[:, :r]).max() > 1e-3


def test_mrf_stage_bf16_output_of_f32_storage_matches_pallas():
    """``out_dtype=bfloat16`` under ``f32_storage`` (the ``f32acc`` variant) is
    ``fused_mrf_stage_packed(f32_storage=True)`` cast to bf16: the f32 results
    are held to 3e-4 of each other above and sit ~1e-5 apart, so after the cast
    under 1% of values differ, by one bf16 ulp (or by that 3e-4 near zero,
    where an ulp is smaller than the f32 difference)."""
    x, br = _stage3_inputs(scale=0.02)
    want = jmrf.fused_mrf_stage_packed(jnp.asarray(x, jnp.bfloat16), _jb(br), KS, DIL, tile=32,
                                       interpret=True, f32_storage=True).astype(jnp.bfloat16)
    got = tmrf.mrf_stage(torch.from_numpy(x).bfloat16(), _tb(br), KS, DIL, f32_storage=True,
                         out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    diff = np.abs(_np(got) - _np(want))
    assert (diff > 0).mean() < 0.01
    assert (diff <= np.maximum(np.abs(_np(want)) * 2.0 ** -7, 3e-4)).all()
    both = tmrf.mrf_stage(torch.from_numpy(x).bfloat16(), _tb(br), KS, DIL, f32_storage=True,
                          out_dtype=torch.bfloat16, mask_edges=False)
    r = tmrf.stage_radius(KS, DIL)
    assert both.dtype == torch.bfloat16
    assert (_np(both)[:, r:-r] != _np(got)[:, r:-r]).mean() < 0.01


def test_mrf_stage_rejects_an_output_type_its_mode_does_not_have():
    x, br = _stage3_inputs()
    with pytest.raises(ValueError):  # bf16 output is an option of f32_storage only
        tmrf.mrf_stage(torch.from_numpy(x), _tb(br), KS, DIL, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tmrf.mrf_stage(torch.from_numpy(x).bfloat16(), _tb(br), KS, DIL,
                       out_dtype=torch.float32)
    out = tmrf.mrf_stage(torch.from_numpy(x).bfloat16(), _tb(br), KS, DIL, f32_storage=True,
                         out_dtype=torch.float32)
    assert out.dtype == torch.float32


def test_variants_tool_runs_on_the_cpu():
    """The variants entry point at a tiny size: the four timed variants, the
    three that share a function with one of them, and their central checksums."""
    from smart_vocoder_torch.tools import exp_mrf_variants

    res = exp_mrf_variants.main(stage=4, iters=1, device="cpu", batch=1, length=300)
    assert sorted(res) == ["all_f32", "base", "f32acc", "nomask"]
    assert exp_mrf_variants.SAME_FUNCTION == {"leaky2": "base", "nopad": "base", "all": "nomask"}
    assert res["base"]["chk"] != res["nomask"]["chk"]
    assert abs(res["base"]["chk_central"] - res["nomask"]["chk_central"]) < 0.5
    assert abs(res["f32acc"]["chk_central"] - res["base"]["chk_central"]) < 2.0
    assert exp_mrf_variants.SHAPES[3] == (128000, 64) and exp_mrf_variants.B == 32
    only = exp_mrf_variants.main(stage=4, iters=1, names=["all", "nomask"], device="cpu",
                                 batch=1, length=200)
    assert list(only) == ["nomask"]
    with pytest.raises(ValueError):
        exp_mrf_variants.main(stage=4, iters=1, names=["faster"], device="cpu", batch=1,
                              length=200)


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


# ------------------------------- the tensor-core kernels' host side (CPU-testable)
def test_split_hi_lo_reconstructs_and_bounds_the_two_pass_conv():
    """The F32-mode kernels multiply a hi and a lo bf16 plane of each f32
    operand against the bf16-valued weight. hi + lo is x to within 2^-16 |x|
    (lo is the bf16 rounding of a remainder below 2^-7 |x|), both planes are
    bf16 values, and so the two-pass conv sits within 2^-15 of the f32 conv,
    relative to the conv of the absolute values. That is the reason the
    kernels are held to 1e-3 in this mode: activations are O(1)."""
    import torch.nn.functional as F

    rng = np.random.default_rng(4)
    mag = 2.0 ** rng.integers(-20, 5, (2, 64, 300))
    x = torch.from_numpy((rng.normal(0, 1, mag.shape) * mag).astype(np.float32))
    hi, lo = tmrf.split_hi_lo(x)
    assert torch.equal(hi, hi.bfloat16().float()) and torch.equal(lo, lo.bfloat16().float())
    assert torch.all((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -16 * x.abs())
    assert torch.all(hi.abs() <= x.abs())  # truncation, not rounding
    w = torch.from_numpy(rng.normal(0, 0.1, (64, 64, 7)).astype(np.float32)).bfloat16().float()
    two_pass = F.conv1d(hi, w, padding=3) + F.conv1d(lo, w, padding=3)
    one_pass = F.conv1d(x, w, padding=3)
    scale = F.conv1d(x.abs(), w.abs(), padding=3)
    assert torch.all((two_pass - one_pass).abs() <= 2.0 ** -15 * scale)


@pytest.mark.parametrize("mode", [tmrf.BF16, tmrf.F32_STORAGE, tmrf.F32])
@pytest.mark.parametrize("c", tmrf.MRF_CHANNELS)
def test_mrf_stage_tile_fits_the_block(c, mode):
    radius = tmrf.stage_radius(KS, DIL)
    tile = tmrf.mrf_stage_tile(c, mode, radius)
    rows = tile + 2 * radius
    assert rows <= tmrf.MMA_MAX_ROWS
    assert tmrf.mma_smem_bytes(c, c, rows, tile, 1, 2 if mode == tmrf.F32 else 1) \
        <= tmrf.SMEM_LIMIT
    assert tile == (64 if (c, mode) == (64, tmrf.F32) else 128)
    with pytest.raises(ValueError):  # no tile leaves room for a 130-row halo
        tmrf.mrf_stage_tile(c, mode, 130)


@pytest.mark.parametrize("k_post", [0, 7])
@pytest.mark.parametrize("mode", [tmrf.BF16, tmrf.F32])
@pytest.mark.parametrize("channels", tmrf.UP_CHANNELS)
def test_up_mrf_stage_tile_fits_the_block(channels, mode, k_post):
    cin, c = channels
    p_post = max(0, (k_post - 1) // 2)
    halo = tmrf.stage_radius(KS, DIL) + p_post
    tile = tmrf.up_mrf_stage_tile(cin, c, mode, halo, p_post, 4, 2)
    rows = tile + 2 * halo
    assert rows <= tmrf.MMA_MAX_ROWS
    assert tmrf.mma_smem_bytes(c, tmrf.UP_TILE_ROWS, rows, tile + 2 * p_post, 2,
                               2 if mode == tmrf.F32 else 1) <= tmrf.SMEM_LIMIT
    # the u tile fits in the two operand buffers it aliases
    assert ((rows + 4) // 2 + 2) * (cin + tmrf.MMA_PAD) <= 2 * rows * (c + tmrf.MMA_PAD)
    assert tile == {(64, 32): 128, (128, 64): 32 if mode == tmrf.F32 else 64}[channels]


def _row_major(flat, n, k, c, wgmma=None):
    """Packed tiles back as (n, K, C) [Cin][Cout]: for ``wgmma`` (by default
    at C = 64) out of the core-matrix layout [C / 8][K / 8][8 columns][8 rows]."""
    if not (c == tmrf.WGMMA_CHANNELS if wgmma is None else wgmma):
        return flat.reshape(n, k, c)
    return flat.reshape(n, c // 8, k // 8, 8, 8).permute(0, 2, 4, 1, 3).reshape(n, k, c)


@pytest.mark.parametrize("d", [1, 3, 5])
@pytest.mark.parametrize("k", [3, 7, 11])
@pytest.mark.parametrize("c", tmrf.UNPACKED_CHANNELS)
def test_unpacked_tile_fits_the_block(c, k, d):
    """The unpacked stage's tile: every pair's buffers and ring fit in a
    block, and conv1's rows (tile + 2h) fit its warpgroups (four; two at
    C = 256, whose one 256-column pass needs 128 accumulators a thread)."""
    tile = tmrf.unpacked_tile(c, (k,), (d,))
    h = (k - 1) // 2
    geo = tmrf.pair_geometry(c)
    assert geo == ((256, 3) if c == 256 else (512, 4))
    assert tile + 2 * h <= geo.threads // 2 <= tmrf.MMA_MAX_ROWS
    assert tmrf.unpacked_smem_bytes(c, tile, h, d) <= tmrf.SMEM_LIMIT
    assert tile == (240 if c <= 128 else 64)
    # the serving stage's tile holds every one of its pairs
    stage = tmrf.unpacked_tile(c, KS, DIL)
    assert stage <= tile and tmrf.unpacked_smem_bytes(c, stage, h, d) <= tmrf.SMEM_LIMIT
    assert stage == (64 if c == 256 else 240)


@pytest.mark.parametrize("c", [64, 128, 256])
def test_unpacked_packed_weights_round_trip(c):
    """From C = 64 a conv's tiles are 64 input channels by C, [tap][Cin / 64],
    in ``wgmma``'s core matrices; convs in the order [branch][pair][conv1,
    conv2]."""
    rng = np.random.default_rng(c)
    ks = (3, 5)
    br = [tuple(torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32))
                for s in ((2, k, c, c), (2, c), (2, k, c, c), (2, c))) for k in ks]
    packed = tmrf.pack_mrf_weights(br)
    assert packed.dtype == torch.bfloat16 and packed.numel() == 2 * 2 * sum(ks) * c * c
    at = 0
    for (w1, _, w2, _), k in zip(br, ks):
        for j in range(2):
            for w in (w1[j], w2[j]):
                size = k * c * c
                tiles = _row_major(packed[at:at + size].float(), size // (64 * c), 64, c, True)
                assert torch.equal(tiles.reshape(k, c, c), w.bfloat16().float())
                at += size
    # element (ci, co) of tap t of the first conv, by hand
    t, ci, co = 1, c // 2 + 6, c - 3
    tile = t * (c // 64) + ci // 64
    off = tile * 64 * c + (co // 8) * 512 + (ci % 64 // 8) * 64 + (co % 8) * 8 + ci % 8
    assert packed[off] == br[0][0][0, t, ci, co].bfloat16()


@pytest.mark.parametrize("n", [128, 64])
def test_ab_pair_pass_split_build(n, tmp_path):
    """The pass-width tool's split build: it finds what it replaces in a copy
    of ``mrf_pair.cuh``, and its weight tiles [pass][tap][Cin / 64] of 64 x n
    round-trip back to the conv."""
    from smart_vocoder_torch.kernels import _build
    from smart_vocoder_torch.tools import ab_pair_pass

    (tmp_path / "mrf_pair.cuh").write_text((_build.SRC_DIR / "mrf_pair.cuh").read_text())
    ab_pair_pass._split_sources(n, tmp_path)
    text = (tmp_path / "mrf_pair.cuh").read_text()
    assert f"kPassN = {n};" in text and text.count("struct PairGeometry") == 1
    assert "ring_start<G::TN, G::KT," in text and "ring_start<C," not in text
    c, k = 256, 3
    w = torch.from_numpy(np.random.default_rng(n).normal(0, 0.1, (k, c, c)).astype(np.float32))
    tiles = ab_pair_pass._split_layout(n)["_conv_tiles"](w).reshape(-1)
    back = _row_major(tiles, k * c * c // (64 * n), 64, n, True)
    back = back.reshape(c // n, k, c // 64, 64, n).permute(1, 2, 3, 0, 4)
    assert torch.equal(back.reshape(k, c, c), w)


def test_packed_weights_round_trip():
    """bf16 tiles in the order of use: [branch][pair][conv1, conv2][tap] for
    the MRF convs, [tap in polyphase order][Cin / 64] for the upsample; each
    tile [Cin][Cout], row-major at C = 32 and in ``wgmma``'s K-major core
    matrices at C = 64."""
    for c in tmrf.MRF_CHANNELS:
        _check_round_trip(c)


def _check_round_trip(c):
    rng = np.random.default_rng(8)
    br = _tb(_branches(rng, c))
    packed = tmrf.pack_mrf_weights(br)
    assert packed.dtype == torch.bfloat16 and packed.ndim == 1 and packed.is_contiguous()
    assert packed.numel() == 2 * 3 * sum(KS) * c * c
    tiles = _row_major(packed.float(), 2 * 3 * sum(KS), c, c)
    at = 0
    for (w1, _, w2, _), k in zip(br, KS):  # per branch: pairs of (conv1, conv2), tap-major
        convs = tiles[at:at + 2 * 3 * k].reshape(3, 2, k, c, c)
        assert torch.equal(convs[:, 0], w1.bfloat16().float())
        assert torch.equal(convs[:, 1], w2.bfloat16().float())
        at += 2 * 3 * k
    # the first tile is tap 0 of conv1 of pair 0, the next k tiles later conv2's tap 0
    assert torch.equal(tiles[0], br[0][0][0, 0].bfloat16().float())
    assert torch.equal(tiles[KS[0]], br[0][2][0, 0].bfloat16().float())
    if c == tmrf.WGMMA_CHANNELS:  # element (k, n) of a tile, in bf16 elements
        k_, n_ = 19, 42
        at = (n_ // 8) * 512 + (k_ // 8) * 64 + (n_ % 8) * 8 + k_ % 8
        assert packed[c * c + at] == br[0][0][0, 1, k_, n_].bfloat16()
    up_w = torch.from_numpy(rng.normal(0, 0.1, (2 * c, c, 4)).astype(np.float32))
    order = tmrf.up_tap_order(4, 2, 1)
    assert order == [1, 3, 0, 2]
    n_up = 4 * 2 * c // tmrf.UP_TILE_ROWS
    tiles = _row_major(tmrf.pack_up_weights(up_w, 2, 1).float(), n_up, tmrf.UP_TILE_ROWS, c)
    for i, t in enumerate(order):
        assert torch.equal(tiles.reshape(4, 2 * c, c)[i], up_w[:, :, t].bfloat16().float())


@pytest.mark.parametrize("geometry", [(4, 2, 1), (16, 8, 4), (3, 1, 1), (7, 3, 2)])
def test_up_tap_order_is_the_polyphase_form_of_the_transposed_conv(geometry):
    """Output rows n = s*j + phase are the sum over that phase's taps t of
    u[j + (phase + p - t) / s] @ W[t]: what the kernel's upsample computes."""
    import torch.nn.functional as F

    k, s, p = geometry
    rng = np.random.default_rng(k)
    u = torch.from_numpy(rng.normal(0, 1, (1, 6, 37)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (6, 5, k)).astype(np.float32))
    want = F.conv_transpose1d(u, w, stride=s, padding=p)[0].t()  # (Tu*s, Cout)
    order = tmrf.up_tap_order(k, s, p)
    assert sorted(order) == list(range(k))
    tu = u.shape[2]
    got = torch.zeros_like(want)
    taps = iter(order)
    for phase in range(s):
        for _ in range(len(range((phase + p) % s, k, s))):
            t = next(taps)
            assert (phase + p - t) % s == 0
            shift = (phase + p - t) // s
            for j in range(tu):
                if 0 <= j + shift < tu:
                    got[s * j + phase] += u[0, :, j + shift] @ w[:, :, t]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_weights_are_packed_once_per_weight_set():
    """The wrappers take the weights packed once by the caller
    (``pack_mrf_stage``, ``pack_up_mrf_stage``) and compute the same bits as
    when they pack on each call; packed weights that do not fit the call, or
    bf16 tiles where the weights stay f32, are refused."""
    rng = np.random.default_rng(9)
    c = 32
    br = _tb(_branches(rng, c))
    x = torch.from_numpy(rng.normal(0, 0.5, (1, 40, c)).astype(np.float32))
    packed = tmrf.pack_mrf_stage(br)
    assert packed.w.dtype == torch.bfloat16 and packed.bias.dtype == torch.float32
    assert packed.bias.shape == (3 * 2 * 3 * c,)
    assert torch.equal(packed.bias, packed.bias.bfloat16().float())
    assert torch.equal(packed.bias[:3 * c], br[0][1].reshape(-1).bfloat16().float())
    xb = x.bfloat16()
    assert torch.equal(tmrf.mrf_stage(xb, br, KS, DIL, f32_storage=True, packed=packed),
                       tmrf.mrf_stage(xb, br, KS, DIL, f32_storage=True))
    with pytest.raises(ValueError):  # an f32 x keeps f32 weights
        tmrf.mrf_stage(x, br, KS, DIL, packed=packed)
    with pytest.raises(ValueError):  # packed for three branches, given two
        tmrf.mrf_stage(xb, br[:2], KS[:2], DIL, packed=packed)

    up_w = torch.from_numpy(rng.normal(0, 0.1, (2 * c, c, 4)).astype(np.float32))
    up_b = torch.from_numpy(rng.normal(0, 0.1, (c,)).astype(np.float32))
    post = torch.from_numpy(rng.normal(0, 0.1, (1, c, 7)).astype(np.float32))
    u = torch.from_numpy(rng.normal(0, 0.5, (1, 20, 2 * c)).astype(np.float32))
    up = tmrf.pack_up_mrf_stage(up_w, up_b, 2, 1, br, post)
    assert up.w.numel() == 4 * 2 * c * c + packed.w.numel() and up.w.dtype == torch.bfloat16
    assert torch.equal(up.w[4 * 2 * c * c:], packed.w) and torch.equal(up.bias, packed.bias)
    assert torch.equal(up.up_bias, up_b.bfloat16().float())
    assert torch.equal(up.post_weight, post[0].t().bfloat16().float())  # (k_post, Cout)
    args = (up_w, up_b, 4, 2, 1, br, KS, DIL)
    assert torch.equal(tmrf.up_mrf_stage(u, *args, post_weight=post, hifi=True, packed=up),
                       tmrf.up_mrf_stage(u, *args, post_weight=post, hifi=True))
    with pytest.raises(ValueError):  # an f32 u without hifi keeps f32 weights
        tmrf.up_mrf_stage(u, *args, post_weight=post, packed=up)
    with pytest.raises(ValueError):  # packed with the tail, called without
        tmrf.up_mrf_stage(u, *args, hifi=True, packed=up)
    no_tail = tmrf.pack_up_mrf_stage(up_w, up_b, 2, 1, br)
    assert no_tail.post_weight.shape == (1,)
    assert torch.equal(tmrf.up_mrf_stage(u.bfloat16(), *args, packed=no_tail),
                       tmrf.up_mrf_stage(u.bfloat16(), *args))


@pytest.mark.parametrize("c", [32, 128])
def test_unpacked_stage_takes_weights_packed_once(c):
    """``mrf_stage_unpacked(packed=)`` with ``pack_mrf_stage``'s weights
    computes what it computes without them; packed weights for other
    branches, or for an f32 x (which keeps f32 weights), are refused."""
    rng = np.random.default_rng(c + 2)
    br = _tb(_branches(rng, c))
    x = torch.from_numpy(rng.normal(0, 0.5, (1, 40, c)).astype(np.float32))
    packed = tmrf.pack_mrf_stage(br)
    assert torch.equal(tmrf.mrf_stage_unpacked(x.bfloat16(), br, KS, DIL, packed=packed),
                       tmrf.mrf_stage_unpacked(x.bfloat16(), br, KS, DIL))
    with pytest.raises(ValueError):  # an f32 x keeps f32 weights
        tmrf.mrf_stage_unpacked(x, br, KS, DIL, packed=packed)
    with pytest.raises(ValueError):  # packed for three branches, given two
        tmrf.mrf_stage_unpacked(x.bfloat16(), br[:2], KS[:2], DIL, packed=packed)
    with pytest.raises(ValueError):  # packed for one pair more
        tmrf.mrf_stage_unpacked(x.bfloat16(), [tuple(a[:2] for a in b) for b in br], KS,
                                DIL[:2], packed=packed)


def _decoder_params(rng, cfg, inter=16):
    """Folded decoder weights of ``cfg`` in torch's layouts, from ``rng``."""
    def t(*shape, scale=0.1):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32))

    ch = cfg.upsample_initial_channel
    p = {"conv_pre.weight": t(ch, inter, 7), "conv_pre.bias": t(ch)}
    for i, k in enumerate(cfg.upsample_kernel_sizes):
        p[f"ups.{i}.weight"], p[f"ups.{i}.bias"] = t(ch, ch // 2, k), t(ch // 2)
        ch //= 2
        for j, kb in enumerate(cfg.resblock_kernel_sizes):
            for kind in ("convs1", "convs2"):
                for n in range(3):
                    pre = f"resblocks.{i * len(cfg.resblock_kernel_sizes) + j}.{kind}.{n}"
                    p[f"{pre}.weight"], p[f"{pre}.bias"] = t(ch, ch, kb, scale=0.03), t(ch)
    p["conv_post.weight"] = t(1, ch, 7)
    return p


DECODER_CASES = [("f32", 0), ("bf16", 0), ("bf16", 1), ("bf16", 2), ("bf16", 3)]


def _small_decoder():
    """The 128 / 64 / 32-channel config: the stage of 64 runs ``mrf_stage``,
    or folds up under ``pallas_stage2``; the last runs ``up_mrf_stage``."""
    from smart_vocoder_torch.kernels import decoder as tdec

    cfg = tdec.DecoderConfig("1", KS, (DIL,) * 3, (4, 2, 2), 256, (8, 4, 4))
    rng = np.random.default_rng(10)
    x = torch.from_numpy(rng.normal(0, 0.5, (1, 12, 16)).astype(np.float32))
    return tdec, cfg, _decoder_params(rng, cfg), x


def test_decoder_stacks_a_stage_s_branches_once():
    """``pack_decoder`` stacks every stage's branches as ``_stage_branches``
    does, once per weight set, and lays out the weights of the stages that run
    a tensor-core kernel with bf16-valued weights."""
    tdec, cfg, p, _ = _small_decoder()
    for dtype, hifi in DECODER_CASES:
        for stage2 in (False, True):
            tdt = torch.float32 if dtype == "f32" else torch.bfloat16
            packed = tdec.pack_decoder(p, cfg, tdt, hifi, stage2)
            assert len(packed) == 3
            for i, (branches, _) in enumerate(packed):
                fresh = tdec._stage_branches(p, i, 3, 3, tdt)
                assert [tuple(a.shape) for a in branches[1]] == [
                    (3, 7, c, c) if n % 2 == 0 else (3, c)
                    for n, c in enumerate([128 >> i] * 4)]
                assert all(a.dtype == tdt and torch.equal(a, b)
                           for x_, y_ in zip(branches, fresh) for a, b in zip(x_, y_))
            kinds = [type(kernel).__name__ for _, kernel in packed]
            bf16 = dtype == "bf16"
            # folded up, the stage of 64 takes f32 activations at hifi >= 2; the
            # stage of 128 takes the unpacked kernel under pallas_stage2
            middle = ("PackedUpMRF" if hifi < 2 else "NoneType") if stage2 else "PackedMRF"
            assert kinds == ["PackedMRF" if bf16 and stage2 else "NoneType",
                             middle if bf16 else "NoneType",
                             "PackedUpMRF" if bf16 or hifi else "NoneType"]


@pytest.mark.parametrize("stage2", [False, True])
@pytest.mark.parametrize("dtype,hifi", DECODER_CASES)
def test_decoder_apply_with_packed_weights_gives_the_same_bits(dtype, hifi, stage2):
    tdec, cfg, p, x = _small_decoder()
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    packed = tdec.pack_decoder(p, cfg, tdt, hifi, stage2)
    got = tdec.decoder_apply(p, x, cfg, dtype=tdt, hifi_tail=hifi, pallas_stage2=stage2,
                             packed=packed)
    want = tdec.decoder_apply(p, x, cfg, dtype=tdt, hifi_tail=hifi, pallas_stage2=stage2)
    assert got.shape == (1, 12 * 16, 1) and torch.equal(got, want)
