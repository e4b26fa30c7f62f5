"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card with ``nvcc`` (the kernels build for
sm_90a at first use) and skips elsewhere. The file imports no JAX, so it runs
where only PyTorch is installed (``tests/conftest.py`` imports JAX, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Inputs are small and ragged (T not a multiple of any tile), so the halos
cross tile seams and the sequence ends inside a tile; the WN stack also has a
partial mask and a partial last chunk of layers. Tolerances:
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
from smart_vocoder_torch.kernels.wn_stack import (
    pack_wn_stack,
    wn_chunk,
    wn_chunk_plain,
    wn_stack,
    wn_stack_plain,
)

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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("one_pair", [False, True], ids=["stage", "one_pair"])
def test_mrf_stage_unpacked_kernel_matches_plain(c, dtype, one_pair):
    rng = np.random.default_rng(c + 1)
    ks, dil = ((3,), (1,)) if one_pair else (KS, DIL)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    br = _branches(rng, c, ks, dil, 0.02, tdt)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 777, c)).astype(np.float32)).to(tdt).cuda()
    before = tmrf.LAUNCHES["mrf_stage_unpacked"]
    got = tmrf.mrf_stage_unpacked(x, br, ks, dil)
    torch.cuda.synchronize()
    # one kernel per residual pair of each branch
    assert tmrf.LAUNCHES["mrf_stage_unpacked"] == before + len(ks) * len(dil)
    mode = tmrf.F32 if dtype == "f32" else tmrf.BF16
    want = tmrf.mrf_stage_plain(x, br, ks, dil, mode)
    assert got.dtype == want.dtype == tdt and got.shape == want.shape
    if mode == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        _check_rounding_mode(got, want, tmrf.mrf_stage_plain(x, br, ks, dil, tmrf.F32),
                             one_pair)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("one_pair", [False, True], ids=["stage", "one_pair"])
def test_up_mrf_stage_128_to_64_kernel_matches_plain(mode, one_pair):
    """Stage 3 folded up under pallas_stage2: (128 -> 64), no tail."""
    rng = np.random.default_rng(9)
    ks, dil = ((3,), (1,)) if one_pair else (KS, DIL)
    cin, cout, tu = 128, 64, 389
    wdt = torch.float32 if mode == "f32" else torch.bfloat16

    def w(*shape):
        return torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32)).to(wdt).float().cuda()

    up_w, up_b = w(cin, cout, 4), w(cout)
    br = _branches(rng, cout, ks, dil, 0.03, wdt)
    u = torch.from_numpy(rng.normal(0, 0.5, (2, tu, cin)).astype(np.float32)).to(wdt).cuda()
    before = tmrf.LAUNCHES["up_mrf_stage"]
    got = tmrf.up_mrf_stage(u, up_w, up_b, 4, 2, 1, br, ks, dil)
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES["up_mrf_stage"] == before + 1
    m = tmrf.BF16 if mode == "bf16" else tmrf.F32
    want = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, ks, dil, m)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 2 * tu, cout)
    if m == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        exact = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, ks, dil, tmrf.F32)
        _check_rounding_mode(got, want, exact, one_pair)


def _wn_layers(rng, n, h, wdt):
    out = []
    for i in range(n):
        rs = h if i == n - 1 else 2 * h
        b_in, b_rs = 1 / np.sqrt(5 * h), 1 / np.sqrt(h)
        out.append(tuple(torch.from_numpy(rng.uniform(-b, b, s).astype(np.float32))
                         .to(wdt).float().cuda()
                         for b, s in ((b_in, (2 * h, h, 5)), (b_in, (2 * h,)),
                                      (b_rs, (rs, h, 1)), (b_rs, (rs,)))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n_layers", [6, 1], ids=["two_chunks", "one_layer"])
def test_wn_stack_kernel_matches_plain(dtype, n_layers):
    """Six layers at layers_per_call=4: a full and a partial chunk. One
    layer is held to identical rounding (bf16: under 1% of values differ)."""
    rng = np.random.default_rng(n_layers)
    h, t = 192, 778
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    layers = _wn_layers(rng, n_layers, h, tdt)
    mask = (torch.arange(t)[None, :] < torch.tensor([t, 501])[:, None]).float()[..., None].cuda()
    x = (torch.from_numpy(rng.normal(0, 1, (2, t, h)).astype(np.float32)).cuda() * mask).to(tdt)
    before = tmrf.LAUNCHES["wn_stack"]
    got = wn_stack(x, mask, layers, h, layers_per_call=4)
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES["wn_stack"] == before + (n_layers + 3) // 4
    want = wn_stack_plain(x, mask, layers, h, layers_per_call=4)
    assert got.dtype == want.dtype == tdt and got.shape == want.shape
    assert torch.all(got[1, 501:] == 0)
    if dtype == "f32":
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        exact = wn_stack_plain(x.float(), mask, layers, h, layers_per_call=4)
        _check_rounding_mode(got, want, exact, n_layers == 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wn_stack_packed_weights_and_single_launches(dtype):
    """Weights packed once give the same bits as packing per call, and one
    launch on its own (``wn_chunk``, given a running skip sum) matches its
    plain version on the same input."""
    rng = np.random.default_rng(11)
    h, t = 192, 334
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    layers = _wn_layers(rng, 6, h, tdt)
    mask = (torch.arange(t)[None, :] < torch.tensor([t, 207])[:, None]).float()[..., None].cuda()
    x = (torch.from_numpy(rng.normal(0, 1, (2, t, h)).astype(np.float32)).cuda() * mask).to(tdt)
    packed = pack_wn_stack(layers, h, tdt, 4, x.device)
    torch.testing.assert_close(wn_stack(x, mask, layers, h, 4, packed),
                               wn_stack(x, mask, layers, h, 4), rtol=0, atol=0)
    skip = (torch.from_numpy(rng.normal(0, 0.5, (2, t, h)).astype(np.float32)).cuda()
            * mask).to(tdt)
    before = tmrf.LAUNCHES["wn_stack"]
    got = wn_chunk(x, mask, layers[4:], h, skip, True, packed[1])
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES["wn_stack"] == before + 1
    want = wn_chunk_plain(x, mask, layers[4:], h, skip, True)
    exact = wn_chunk_plain(x.float(), mask, layers[4:], h, skip.float(), True)
    for g, w, e in zip(got, want, exact):
        assert g.dtype == w.dtype == tdt and g.shape == w.shape
        if dtype == "f32":
            torch.testing.assert_close(g, w, rtol=3e-4, atol=3e-4)
        else:
            _check_rounding_mode(g, w, e, False)


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_are_not_built_for():
    rng = np.random.default_rng(0)
    br = _branches(rng, 48, KS, DIL, 0.02, torch.float32)
    with pytest.raises(ValueError):
        tmrf.mrf_stage_unpacked(torch.zeros(1, 64, 48, device="cuda"), br, KS, DIL)
    br = _branches(rng, 48, KS, DIL, 0.02, torch.float32)
    with pytest.raises(ValueError):  # (96, 48) is not an instantiated up stage
        tmrf.up_mrf_stage(torch.zeros(1, 32, 96, device="cuda"),
                          torch.zeros(96, 48, 4, device="cuda"), torch.zeros(48, device="cuda"),
                          4, 2, 1, br, KS, DIL)
    layers = _wn_layers(rng, 2, 128, torch.float32)
    with pytest.raises(ValueError):  # hidden 128 is not an instantiated width
        wn_stack(torch.zeros(1, 64, 128, device="cuda"), torch.ones(1, 64, 1, device="cuda"),
                 layers, 128)
    layers = _wn_layers(rng, 2, 192, torch.float32)
    with pytest.raises(ValueError):  # weights packed for another dtype
        wn_stack(torch.zeros(1, 64, 192, device="cuda", dtype=torch.bfloat16),
                 torch.ones(1, 64, 1, device="cuda"), layers, 192,
                 packed=pack_wn_stack(layers, 192, torch.float32, device="cuda"))
