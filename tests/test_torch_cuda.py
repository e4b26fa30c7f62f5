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
  version's cuDNN convolutions held to full f32 (TF32 off). "f32" (true-f32
  weights) runs the two stages' FMA kernels; x2 and hifi run the tensor-core
  kernels on hi + lo bf16 planes, which reconstruct an operand to 2^-16.
- bf16-rounding modes: one residual pair must round at the same points
  (under 1% of values differ, each by a summation-order flip of one
  rounding); the full stage must stay under half the distance from the F32
  result that bf16 itself costs.
- the branch backward: the leaky derivative jumps at 0, so on separate
  replays one value within rounding noise of 0 (about 2 in 1e7 are) moves a
  gradient entry by a whole term. So the kernel's replay is held to the plain
  replay, and its gradients to the plain backward on that same replay. f32:
  replay within 1e-4 and gradients within 1e-3 of their largest entry (f32
  summation order, which the blocks' atomic adds change from run to run);
  bf16: the same cost rule as the forward stages.
- the gate: f32 within 1e-6, bf16 within one ulp of the output.
"""

import numpy as np
import pytest
import torch

from smart_vocoder_torch.kernels import mrf as tmrf
from smart_vocoder_torch.kernels.gate import fused_gate, fused_gate_plain
from smart_vocoder_torch.kernels.mrf_train import (
    branch_replay_plain,
    mrf_branch_bwd,
    mrf_branch_bwd_plain,
    mrf_stage_train,
)
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


def _check_f32(got, want, tol):
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol * want.abs().max().item()


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
    name = "mrf_stage_fma" if mode == "f32" else "mrf_stage"  # f32 weights: the FMA body
    before = dict(tmrf.LAUNCHES)
    got = tmrf.mrf_stage(x, br, ks, dil, **kw)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in tmrf.LAUNCHES.items() if v != before[k]} == {name: 1}
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
    name = "up_mrf_stage_fma" if mode == "f32" else "up_mrf_stage"
    before = dict(tmrf.LAUNCHES)
    got = tmrf.up_mrf_stage(u, up_w, up_b, 4, 2, 1, br, ks, dil, post_weight=pw,
                            hifi=mode == "hifi")
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in tmrf.LAUNCHES.items() if v != before[k]} == {name: 1}
    m = tmrf.BF16 if mode == "bf16" else tmrf.F32
    want = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, ks, dil, m, pw)
    assert got.dtype == want.dtype and got.shape == want.shape == (2, 2 * tu, 1 if post else cout)
    if m == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        exact = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, ks, dil, tmrf.F32, pw)
        _check_rounding_mode(got, want, exact, one_pair)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [777, 1, 63, 65])
@pytest.mark.parametrize("mode", ["x2", "bf16", "f32_storage"])
def test_mrf_stage_kernel_at_lengths_off_the_mma_tiles(t, mode):
    """Lengths that are no multiple of the 16-row MMA tile or of the time
    tile: the last warp tile is ragged and the sequence ends inside it."""
    rng = np.random.default_rng(t)
    c = 64
    br = _branches(rng, c, KS, DIL, 0.02, torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 0.5, (3, t, c)).astype(np.float32)).bfloat16().cuda()
    kw = {"f32_storage": mode == "f32_storage", "x2": mode == "x2"}
    got = tmrf.mrf_stage(x, br, KS, DIL, **kw)
    torch.cuda.synchronize()
    m = tmrf._mrf_mode(x.dtype, **kw)
    want = tmrf.mrf_stage_plain(x, br, KS, DIL, m)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, t, c)
    if m == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        _check_rounding_mode(got, want, tmrf.mrf_stage_plain(x, br, KS, DIL, tmrf.F32), False)


@pytest.mark.cuda
@pytest.mark.parametrize("tu", [1, 63, 65])
@pytest.mark.parametrize("mode", ["hifi", "bf16"])
def test_up_mrf_stage_kernel_at_lengths_off_the_mma_tiles(tu, mode):
    rng = np.random.default_rng(tu)
    cin, cout = 64, 32

    def w(*shape):
        return (torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))
                .bfloat16().float().cuda())

    up_w, up_b, post_w = w(cin, cout, 4), w(cout), w(1, cout, 7)
    br = _branches(rng, cout, KS, DIL, 0.03, torch.bfloat16)
    u = torch.from_numpy(rng.normal(0, 0.5, (3, tu, cin)).astype(np.float32)).cuda()
    if mode == "bf16":
        u = u.bfloat16()
    got = tmrf.up_mrf_stage(u, up_w, up_b, 4, 2, 1, br, KS, DIL, post_weight=post_w,
                            hifi=mode == "hifi")
    torch.cuda.synchronize()
    m = tmrf.BF16 if mode == "bf16" else tmrf.F32
    want = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, KS, DIL, m, post_w)
    assert got.dtype == want.dtype and got.shape == want.shape == (3, 2 * tu, 1)
    if m == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        exact = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, KS, DIL, tmrf.F32, post_w)
        _check_rounding_mode(got, want, exact, False)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64])
def test_mrf_weights_packed_once_give_the_same_bits(c):
    """``pack_mrf_stage`` / ``pack_up_mrf_stage`` once, against packing on each
    call, at both channel counts (``mma.sync`` tiles at 32, ``wgmma`` tiles
    at 64); packed bf16 tiles are refused where the weights stay f32."""
    rng = np.random.default_rng(c + 1)
    br = _branches(rng, c, KS, DIL, 0.02, torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 500, c)).astype(np.float32)).bfloat16().cuda()
    packed = tmrf.pack_mrf_stage(br, x.device)
    for kw in ({}, {"f32_storage": True}, {"x2": True}, {"mask_edges": False}):
        assert torch.equal(tmrf.mrf_stage(x, br, KS, DIL, packed=packed, **kw),
                           tmrf.mrf_stage(x, br, KS, DIL, **kw))
    with pytest.raises(ValueError):
        tmrf.mrf_stage(x.float(), br, KS, DIL, packed=packed)
    with pytest.raises(ValueError):  # packed on the card, x on the CPU
        tmrf.mrf_stage(x.cpu(), br, KS, DIL, packed=packed)

    def w(*shape):
        return (torch.from_numpy(rng.normal(0, 0.05, shape).astype(np.float32))
                .bfloat16().float().cuda())

    up_w, up_b = w(2 * c, c, 4), w(c)
    post_w = w(1, c, 7) if c == 32 else None
    u = torch.from_numpy(rng.normal(0, 0.5, (2, 250, 2 * c)).astype(np.float32)).cuda()
    up = tmrf.pack_up_mrf_stage(up_w, up_b, 2, 1, br, post_w, u.device)
    for uu, hifi in ((u, True), (u.bfloat16(), False)):
        assert torch.equal(
            tmrf.up_mrf_stage(uu, up_w, up_b, 4, 2, 1, br, KS, DIL, post_weight=post_w,
                              hifi=hifi, packed=up),
            tmrf.up_mrf_stage(uu, up_w, up_b, 4, 2, 1, br, KS, DIL, post_weight=post_w,
                              hifi=hifi))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mrf_stage", "up_mrf_stage"])
def test_hi_lo_mode_across_magnitudes(kernel):
    """The hi/lo modes (x2, hifi) with inputs from 2^-20 to 2^4, one batch row
    per magnitude. Without biases the stage is positively homogeneous, so each
    row's result scales with its input and is held to 3e-4 of its own largest
    entry: a split that lost its lo plane (2^-8 relative) or flushed small
    values would show in the rows it touches."""
    rng = np.random.default_rng(6)
    exps = (-20, -16, -12, -8, -4, 0, 4)
    scale = torch.tensor([2.0 ** e for e in exps])[:, None, None]
    if kernel == "mrf_stage":
        c = 64
        br = [tuple(torch.zeros_like(a) if a.ndim == 2 else a for a in b)
              for b in _branches(rng, c, KS, DIL, 0.02, torch.bfloat16)]
        base = torch.from_numpy(rng.normal(0, 0.5, (len(exps), 300, c)).astype(np.float32))
        x = (base.bfloat16().float() * scale).bfloat16().cuda()  # exact: powers of two
        got = tmrf.mrf_stage(x, br, KS, DIL, x2=True)
        want = tmrf.mrf_stage_plain(x, br, KS, DIL, tmrf.F32)
    else:
        cin, cout = 64, 32
        br = [tuple(torch.zeros_like(a) if a.ndim == 2 else a for a in b)
              for b in _branches(rng, cout, KS, DIL, 0.03, torch.bfloat16)]
        up_w = (torch.from_numpy(rng.normal(0, 0.1, (cin, cout, 4)).astype(np.float32))
                .bfloat16().float().cuda())
        up_b = torch.zeros(cout, device="cuda")
        u = (torch.from_numpy(rng.normal(0, 0.5, (len(exps), 150, cin)).astype(np.float32))
             * scale).cuda()
        got = tmrf.up_mrf_stage(u, up_w, up_b, 4, 2, 1, br, KS, DIL, hifi=True)
        want = tmrf.up_mrf_stage_plain(u, up_w, up_b, 2, 1, br, KS, DIL, tmrf.F32)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    for i in range(len(exps)):
        top = want[i].abs().max().item()
        assert top > 0 and (got[i] - want[i]).abs().max().item() <= 3e-4 * top, (exps[i], top)


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
    # bf16 on the tensor cores; f32 weights on the FMA body
    name = "mrf_stage_unpacked_fma" if dtype == "f32" else "mrf_stage_unpacked"
    before = dict(tmrf.LAUNCHES)
    got = tmrf.mrf_stage_unpacked(x, br, ks, dil)
    torch.cuda.synchronize()
    # one kernel per residual pair of each branch
    assert {k: v - before[k] for k, v in tmrf.LAUNCHES.items() if v != before[k]} == {
        name: len(ks) * len(dil)}
    mode = tmrf.F32 if dtype == "f32" else tmrf.BF16
    want = tmrf.mrf_stage_plain(x, br, ks, dil, mode)
    assert got.dtype == want.dtype == tdt and got.shape == want.shape
    if mode == tmrf.F32:
        torch.testing.assert_close(got, want, rtol=3e-4, atol=3e-4)
    else:
        _check_rounding_mode(got, want, tmrf.mrf_stage_plain(x, br, ks, dil, tmrf.F32),
                             one_pair)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [1, 63, 65, 777, "tile"])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_mrf_stage_unpacked_kernel_at_lengths_off_the_mma_tiles(c, t, b):
    """bf16 on the tensor cores at lengths below, across and on the GEMMs'
    64-row tiles and the time tile (two whole time tiles), against the plain
    version; weights packed once give the same bits."""
    rng = np.random.default_rng(c + b)
    if t == "tile":
        t = 2 * tmrf.unpacked_tile(c, KS, DIL)
    br = _branches(rng, c, KS, DIL, 0.02, torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 0.5, (b, t, c)).astype(np.float32)).bfloat16().cuda()
    got = tmrf.mrf_stage_unpacked(x, br, KS, DIL)
    assert torch.equal(got, tmrf.mrf_stage_unpacked(x, br, KS, DIL,
                                                    packed=tmrf.pack_mrf_stage(br, x.device)))
    want = tmrf.mrf_stage_plain(x, br, KS, DIL, tmrf.BF16)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    exact = tmrf.mrf_stage_plain(x, br, KS, DIL, tmrf.F32)
    got, want, exact = got.float(), want.float(), exact.float()
    # chip_smoke.py's bf16 comparison: the max within what bf16 costs against
    # the f32 result, or one bf16 ulp of the largest output (one flip); the
    # mean under half the mean cost wherever there are rows enough to average
    err, ref = (got - want).abs(), (want - exact).abs()
    ulp = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
    assert err.max().item() <= max(ref.max().item(), ulp)
    assert t < 64 or err.mean().item() < 0.5 * ref.mean().item()


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
    name = "up_mrf_stage_fma" if mode == "f32" else "up_mrf_stage"
    before = tmrf.LAUNCHES[name]
    got = tmrf.up_mrf_stage(u, up_w, up_b, 4, 2, 1, br, ks, dil)
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES[name] == before + 1
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
    name = "wn_stack_fma" if dtype == "f32" else "wn_stack"  # f32 weights: the FMA body
    before = dict(tmrf.LAUNCHES)
    got = wn_stack(x, mask, layers, h, layers_per_call=4)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in tmrf.LAUNCHES.items() if v != before[k]} == {
        name: (n_layers + 3) // 4}
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
    name = "wn_stack_fma" if dtype == "f32" else "wn_stack"
    before = tmrf.LAUNCHES[name]
    got = wn_chunk(x, mask, layers[4:], h, skip, True, packed[1])
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES[name] == before + 1
    assert torch.equal(torch.stack(got), torch.stack(wn_chunk(x, mask, layers[4:], h, skip,
                                                                True)))
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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64])
@pytest.mark.parametrize("variant", ["nomask", "f32acc", "all_f32"])
def test_mrf_stage_variant_options_match_plain(c, variant):
    """The packed-MRF variants' options: no edge masking, and the bf16 output
    of f32 storage; T ragged, so the unmasked right edge lies inside a tile."""
    rng = np.random.default_rng(c + 3)
    br = _branches(rng, c, KS, DIL, 0.02, torch.bfloat16)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 1000, c)).astype(np.float32)).bfloat16().cuda()
    mask_edges = variant == "f32acc"
    f32s = variant != "nomask"
    kw = {"mask_edges": mask_edges, "f32_storage": f32s,
          "out_dtype": torch.bfloat16 if f32s else None}
    before = dict(tmrf.LAUNCHES)
    got = tmrf.mrf_stage(x, br, KS, DIL, **kw)
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES["mrf_stage_variant"] == before["mrf_stage_variant"] + 1
    assert tmrf.LAUNCHES["mrf_stage"] == before["mrf_stage"]
    mode = tmrf.F32_STORAGE if f32s else tmrf.BF16
    want = tmrf.mrf_stage_plain(x, br, KS, DIL, mode, mask_edges, True)
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    _check_rounding_mode(got, want, tmrf.mrf_stage_plain(x, br, KS, DIL, tmrf.F32, mask_edges),
                         False)
    if not mask_edges:  # the interior is the masked stage's, bit for bit
        base = tmrf.mrf_stage(x, br, KS, DIL, f32_storage=f32s,
                              out_dtype=torch.bfloat16 if f32s else None)
        r = tmrf.stage_radius(KS, DIL)
        assert torch.equal(got[:, r:-r], base[:, r:-r])
        assert not torch.equal(got[:, :r], base[:, :r])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("g_kind", ["none", "full", "broadcast"])
@pytest.mark.parametrize("shape", [(3, 777, 130), (32, 1000, 384)])
def test_fused_gate_kernel_matches_plain(dtype, g_kind, shape):
    rng = np.random.default_rng(5)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    x = torch.from_numpy(rng.normal(0, 2, shape).astype(np.float32)).to(tdt).cuda()
    gshape = {"none": None, "full": shape, "broadcast": (shape[0], 1, shape[2])}[g_kind]
    g = (None if gshape is None else
         torch.from_numpy(rng.normal(0, 1, gshape).astype(np.float32)).to(tdt).cuda())
    before = tmrf.LAUNCHES["fused_gate"]
    got = fused_gate(x, g)
    torch.cuda.synchronize()
    assert tmrf.LAUNCHES["fused_gate"] == before + 1
    want = fused_gate_plain(x, g)
    assert got.dtype == tdt and got.shape == want.shape == shape[:-1] + (shape[-1] // 2,)
    diff = (got.float() - want.float()).abs()
    if dtype == "f32":
        assert diff.max().item() <= 1e-6
    else:
        assert bool((diff <= want.float().abs().clamp_min(2.0 ** -126) * 2.0 ** -7).all())


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", KS)
def test_mrf_branch_bwd_kernel_matches_plain(c, dtype, k):
    """T = 777 straddles every tile the wrapper can pick (32 to 256 rows) and
    ends inside one, so halo rows meet at seams: a row counted twice in dw, or
    a missing edge mask, shows here."""
    rng = np.random.default_rng(c + k)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    branch = _branches(rng, c, (k,), DIL, 0.02, tdt)[0]
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 777, c)).astype(np.float32)).to(tdt).cuda()
    g = torch.from_numpy(rng.normal(0, 1, (2, 777, c)).astype(np.float32)).to(tdt).cuda()
    before = tmrf.LAUNCHES["mrf_branch_bwd"]
    dx, dws, replay = mrf_branch_bwd(x, g, branch, k, DIL, with_replay=True)
    torch.cuda.synchronize()
    # a replay and a backward kernel per residual pair
    assert tmrf.LAUNCHES["mrf_branch_bwd"] == before + 2 * len(DIL)
    assert dx.dtype == tdt and dx.shape == x.shape
    flat = [v for vs in replay for v in vs]
    want_flat = [v for vs in branch_replay_plain(x, branch, k, DIL) for v in vs]
    wdx, wdws = mrf_branch_bwd_plain(x, g, branch, k, DIL, replay)
    if dtype == "bf16":
        exact_flat = [v for vs in branch_replay_plain(x.float(), branch, k, DIL) for v in vs]
        edx, edws = mrf_branch_bwd_plain(x.float(), g.float(), branch, k, DIL,
                                         [[v.float() for v in vs] for vs in replay])
    for i, (a, w) in enumerate(zip(flat, want_flat)):
        assert a.dtype == tdt
        if dtype == "f32":
            _check_f32(a, w, 1e-4)
        elif i > 0:  # x_0 is x itself
            _check_rounding_mode(a, w, exact_flat[i], False)
    for i, (a, w) in enumerate(zip((dx, *dws), (wdx, *wdws))):
        assert i == 0 or a.dtype == torch.float32
        if dtype == "f32":
            _check_f32(a, w, 1e-3)
        else:
            _check_rounding_mode(a, w, (edx, *edws)[i], False)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mrf_stage_train_function_on_the_card(dtype):
    """value and gradients through the Function: forward the unpacked kernel,
    backward the branch kernels; f32 against torch.autograd of the plain stage."""
    rng = np.random.default_rng(2)
    c, tdt = 64, torch.float32 if dtype == "f32" else torch.bfloat16
    br = [tuple(a.requires_grad_() for a in b) for b in _branches(rng, c, KS, DIL, 0.02, tdt)]
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 300, c)).astype(np.float32)).to(tdt).cuda()
    x.requires_grad_()
    before = dict(tmrf.LAUNCHES)
    out = mrf_stage_train(x, br, KS, DIL)
    out.float().abs().mean().backward()
    torch.cuda.synchronize()
    fwd = "mrf_stage_unpacked_fma" if dtype == "f32" else "mrf_stage_unpacked"
    assert tmrf.LAUNCHES[fwd] == before[fwd] + 9
    assert tmrf.LAUNCHES["mrf_branch_bwd"] == before["mrf_branch_bwd"] + 18
    got = [x.grad] + [a.grad for b in br for a in b]
    assert all(g is not None and torch.isfinite(g).all() for g in got)
    assert x.grad.dtype == tdt and br[0][0].grad.dtype == torch.float32
    if dtype == "f32":
        x2 = x.detach().clone().requires_grad_()
        br2 = [tuple(a.detach().clone().requires_grad_() for a in b) for b in br]
        tmrf.mrf_stage_plain(x2, br2, KS, DIL, tmrf.F32).abs().mean().backward()
        want = [x2.grad] + [a.grad for b in br2 for a in b]
        # separate replays: a value within f32 noise of 0 may take the other arm of
        # the leaky derivative on one side, so the body is held, not the maximum
        for a, w in zip(got, want):
            diff, top = (a - w).abs(), w.abs().max().item()
            assert diff.mean().item() <= 1e-4 * top
            assert (diff > 1e-3 * top).float().mean().item() <= 1e-2


@pytest.mark.cuda
def test_new_wrappers_reject_what_their_kernels_do_not_take():
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError):  # odd last dimension
        fused_gate(torch.zeros(2, 8, 7, device="cuda"))
    with pytest.raises(ValueError):  # not contiguous
        fused_gate(torch.zeros(2, 8, 8, device="cuda")[..., ::2])
    branch = _branches(rng, 48, (3,), DIL, 0.02, torch.float32)[0]
    with pytest.raises(ValueError):  # 48 channels are not instantiated
        mrf_branch_bwd(torch.zeros(1, 64, 48, device="cuda"), torch.zeros(1, 64, 48, device="cuda"),
                       branch, 3, DIL)
    br = _branches(rng, 64, KS, DIL, 0.02, torch.float32)
    with pytest.raises(ValueError):  # a bf16 output is an option of f32_storage only
        tmrf.mrf_stage(torch.zeros(1, 64, 64, device="cuda"), br, KS, DIL,
                       out_dtype=torch.bfloat16)
