"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``nvcc`` (the kernels build for
sm_90a at first use) and skips elsewhere. The file imports no JAX, so it runs
where only PyTorch is installed (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs are small and ragged (T not a multiple of any tile), so the halos
cross tile seams and the sequence ends inside a tile. Tolerances:
- F32 modes (f32, x2, hifi): 3e-4 -- f32 summation order only, with the plain
  version's cuDNN convolutions held to full f32 (TF32 off).
- bf16-rounding modes: one residual pair must round at the same points
  (under 1% of values differ, each by a summation-order flip of one
  rounding); the full stage must stay under half the distance from the F32
  result that bf16 itself costs.
"""

import numpy as np
import pytest
import torch

from smart_vocoder_torch.kernels import mrf as tmrf

KS, DIL = (3, 7, 11), (1, 3, 5)


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels build with nvcc for sm_90a")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _branches(rng, c, ks, dil, scale, dtype):
    n = len(dil)
    return [tuple(torch.from_numpy(rng.normal(0, scale, s).astype(np.float32))
                  .to(dtype).float().cuda()
                  for s in ((n, k, c, c), (n, c), (n, k, c, c), (n, c))) for k in ks]


def _check_rounding_mode(got, want, exact, one_pair):
    got, want, exact = got.float(), want.float(), exact.float()
    if one_pair:
        frac = ((got - want).abs() > 1e-5).float().mean().item()
        assert frac < 0.01, frac
    else:
        err = (got - want).abs().mean().item()
        ref = (want - exact).abs().mean().item()
        assert err < 0.5 * ref, (err, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("mode", ["f32", "x2", "bf16", "f32_storage"])
@pytest.mark.parametrize("one_pair", [False, True], ids=["stage", "one_pair"])
def test_mrf_stage_kernel_matches_plain(c, mode, one_pair):
    rng = np.random.default_rng(c)
    ks, dil = ((3,), (1,)) if one_pair else (KS, DIL)
    dtype = torch.float32 if mode == "f32" else torch.bfloat16
    br = _branches(rng, c, ks, dil, 0.02, dtype)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 1000, c)).astype(np.float32))
    x = x.to(dtype).cuda()
    kw = {"f32_storage": mode == "f32_storage", "x2": mode == "x2"}
    before = tmrf.LAUNCHES["mrf_stage"]
    got = tmrf.mrf_stage(x, br, ks, dil, **kw)
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES["mrf_stage"] == before + 1
    m = tmrf._mrf_mode(x.dtype, **kw)
    want = tmrf.mrf_stage_plain(x, br, ks, dil, m)
    assert got.dtype == want.dtype and got.shape == want.shape
    if m == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        _check_rounding_mode(got, want, tmrf.mrf_stage_plain(x, br, ks, dil, tmrf.F32),
                             one_pair)


@pytest.mark.cuda
@pytest.mark.parametrize("post", [True, False], ids=["post", "no_post"])
@pytest.mark.parametrize("mode", ["f32", "hifi", "bf16"])
@pytest.mark.parametrize("one_pair", [False, True], ids=["stage", "one_pair"])
def test_up_mrf_stage_kernel_matches_plain(post, mode, one_pair):
    rng = np.random.default_rng(7)
    ks, dil = ((3,), (1,)) if one_pair else (KS, DIL)
    cin, cout, tu = 64, 32, 777
    wdt = torch.float32 if mode == "f32" else torch.bfloat16

    def w(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32)).to(wdt).float().cuda()

    up_w, up_b, post_w = w(cin, cout, 4), w(cout), w(1, cout, 7)
    br = _branches(rng, cout, ks, dil, 0.03, wdt)
    u = torch.from_numpy(rng.normal(0, 0.5, (2, tu, cin)).astype(np.float32)).cuda()
    if mode == "bf16":
        u = u.bfloat16()
    pw = post_w if post else None
    before = tmrf.LAUNCHES["up_mrf_stage"]
    got = tmrf.up_mrf_stage(u, up_w, up_b, 4, 2, 1, br, ks, dil, post_weight=pw,
                            hifi=mode == "hifi")
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES["up_mrf_stage"] == before + 1
    m = tmrf.BF16 if mode == "bf16" else tmrf.F32
    want = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, ks, dil, m, pw)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 2 * tu, 1 if post else cout)
    if m == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        exact = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, ks, dil, tmrf.F32, pw)
        _check_rounding_mode(got, want, exact, one_pair)
