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
  bf16 (the tensor-core backward): the same cost rule as the forward stages.
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


def _branch_bwd_case(rng, c, k, t, tdt):
    """Inputs of one branch backward and the kernel's result with its replay;
    checks that the launches went to the route of ``tdt`` alone: a bf16 x the
    tensor-core kernels (a replay and a dx step per residual pair, one
    weight-gradient launch), an f32 x the FMA body (two per pair)."""
    branch = _branches(rng, c, (k,), DIL, 0.02, tdt)[0]
    x = torch.from_numpy(rng.normal(0, 0.5, (2, t, c)).astype(np.float32)).to(tdt).cuda()
    g = torch.from_numpy(rng.normal(0, 1, (2, t, c)).astype(np.float32)).to(tdt).cuda()
    before = dict(tmrf.LAUNCHES)
    dx, dws, replay = mrf_branch_bwd(x, g, branch, k, DIL, with_replay=True)
    torch.cuda.synchronize()
    want = ({"mrf_branch_bwd": 2 * len(DIL) + 1} if tdt == torch.bfloat16
            else {"mrf_branch_bwd_fma": 2 * len(DIL)})
    assert {n: v - before[n] for n, v in tmrf.LAUNCHES.items() if v != before[n]} == want
    assert dx.dtype == tdt and dx.shape == x.shape
    return branch, x, g, dx, dws, replay


@pytest.mark.cuda
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", KS)
def test_mrf_branch_bwd_kernel_matches_plain(c, dtype, k):
    """T = 777 straddles every tile the wrapper can pick (32 to 240 rows) and
    ends inside one, so halo rows meet at seams: a row counted twice in dw, or
    a missing edge mask, shows here."""
    rng = np.random.default_rng(c + k)
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    branch, x, g, dx, dws, replay = _branch_bwd_case(rng, c, k, 777, tdt)
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
@pytest.mark.parametrize("t", [1, 63, 777, "tiles"])
@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("k", KS)
def test_mrf_branch_bwd_bf16_at_lengths_off_the_tiles(c, k, t):
    """The tensor-core backward at lengths below, across and over the tiles
    (two dx tiles, the second ragged), on its own replay: the replay against
    the plain replay and the gradients against the plain backward on it, as
    chip_smoke.py compares bf16 (the max within what bf16 costs against the f32
    result or one bf16 ulp of the largest entry; the mean under half the mean
    cost wherever there are rows enough to average)."""
    from smart_vocoder_torch.kernels.mrf_train import branch_bwd_tile

    rng = np.random.default_rng(3 * c + k)
    if t == "tiles":
        t = 2 * branch_bwd_tile(c, k, DIL) - 5
    branch, x, g, dx, dws, replay = _branch_bwd_case(rng, c, k, t, torch.bfloat16)
    want_replay = branch_replay_plain(x, branch, k, DIL)
    exact_replay = branch_replay_plain(x.float(), branch, k, DIL)
    wdx, wdws = mrf_branch_bwd_plain(x, g, branch, k, DIL, replay)
    edx, edws = mrf_branch_bwd_plain(x.float(), g.float(), branch, k, DIL,
                                     [[v.float() for v in vs] for vs in replay])
    pairs = [(a, w, e) for vs, ws, es in zip(replay, want_replay, exact_replay)
             for a, w, e in zip(vs, ws, es)][1:]  # x_0 is x itself
    pairs += list(zip((dx, *dws), (wdx, *wdws), (edx, *edws)))
    for got, want, exact in pairs:
        got, want, exact = got.float(), want.float(), exact.float()
        assert torch.isfinite(got).all()
        err, ref = (got - want).abs(), (want - exact).abs()
        top = want.abs().max().item()
        ulp = 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0
        assert err.max().item() <= max(ref.max().item(), ulp)
        assert t < 64 or err.mean().item() < 0.5 * ref.mean().item()


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
    # forward: a kernel per residual pair; backward per branch: bf16 a replay and a
    # dx step per pair and one weight-gradient launch, f32 two FMA kernels per pair
    want = ({"mrf_stage_unpacked_fma": 9, "mrf_branch_bwd_fma": 18} if dtype == "f32"
            else {"mrf_stage_unpacked": 9, "mrf_branch_bwd": 21})
    assert {n: v - before[n] for n, v in tmrf.LAUNCHES.items() if v != before[n]} == want
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


@pytest.mark.cuda
def test_positional_noise_on_the_card_matches_the_cpu():
    """``ops.noise.positional_eps`` on the card: the Philox words equal the
    CPU's bit for bit; the normals (float64 log/cos/sin rounded once to
    float32) within 1e-6."""
    from smart_vocoder_torch.ops.noise import philox4x32, positional_eps

    frame = torch.arange(5000, dtype=torch.int64)[:, None] + 2 ** 32 - 2500
    block = torch.arange(48, dtype=torch.int64)[None, :]
    key = [torch.tensor(12345), torch.tensor(2 ** 31 + 7)]
    cpu = philox4x32([frame & 0xFFFFFFFF, frame >> 32, block, torch.tensor(0)], key)
    card = philox4x32([(frame & 0xFFFFFFFF).cuda(), (frame >> 32).cuda(), block.cuda(),
                       torch.tensor(0, device="cuda")], [k.cuda() for k in key])
    for a, b in zip(cpu, card):
        assert torch.equal(a, b.cpu())
    seeds, starts = [0, 2 ** 40 + 3, -5], [0, 2 ** 33, 17]
    got = positional_eps(seeds, starts, 3000, 192, "cuda")
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert (got.cpu() - positional_eps(seeds, starts, 3000, 192)).abs().max().item() <= 1e-6


@pytest.mark.cuda
def test_train_step_on_the_card_matches_the_cpu():
    """One f32 train step at a tiny config (tests/test_torch_train_step.py's)
    on the card and on the CPU from the same weights and draws: every scalar
    metric within rel 1e-4 (cuDNN against oneDNN, TF32 off). A bf16 step on
    the card is finite and no kernel of the port launches."""
    import copy

    from smart_vocoder_torch.config import HParams, validate
    from smart_vocoder_torch.kernels import LAUNCHES, reset_launch_counts
    from smart_vocoder_torch.tools.bench_train import synthetic_batch
    from smart_vocoder_torch.training import init_train_state, make_train_step

    cfg = {
        "train": dict(learning_rate=2e-4, betas=[0.8, 0.99], eps=1e-9, batch_size=2,
                      fp16_run=False, lr_decay=0.999875, segment_size=2048, c_mel=45,
                      c_kl=1.0, seed=1234),
        "data": dict(max_wav_value=32768.0, sampling_rate=22050, filter_length=1024,
                     hop_length=256, win_length=1024, n_mel_channels=80, mel_fmin=0.0,
                     mel_fmax=None, n_speakers=4),
        "model": dict(inter_channels=32, hidden_channels=32, resblock="1",
                      resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
                      upsample_rates=[8, 8, 2, 2], upsample_initial_channel=64,
                      upsample_kernel_sizes=[16, 16, 4, 4], gin_channels=16,
                      use_spk_embed=True, enc_layers=2, flow_wn_layers=2,
                      disc_width_mult=0.125),
    }
    hps = validate(HParams(**cfg))
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    batch = synthetic_batch(hps, 2, 32, cpu)
    gen = torch.Generator().manual_seed(3)
    draws = {"eps_q": torch.randn((2, 32, 32), generator=gen),
             "ids_slice": torch.tensor([5, 20], dtype=torch.int32),
             "perm": torch.tensor([1, 3, 0, 2])}
    host = init_train_state(hps, seed=7, device=cpu)
    card = init_train_state(hps, device=dev, net_g=copy.deepcopy(host.net_g),
                            net_d=copy.deepcopy(host.net_d))
    _, want = make_train_step(hps, device=cpu)(host, batch, **draws)
    reset_launch_counts()
    _, got = make_train_step(hps, device=dev)(card, batch, **draws)
    for k, w in want.items():
        if w.ndim == 0:
            assert abs(got[k].item() - w.item()) <= 1e-4 * abs(w.item()), (k, got[k], w)
    hps.tpu.bf16_run = True
    bf16 = init_train_state(hps, device=dev, net_g=copy.deepcopy(host.net_g),
                            net_d=copy.deepcopy(host.net_d))
    _, m = make_train_step(hps, device=dev)(bf16, batch, torch.Generator(dev).manual_seed(1))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in m.values())
    assert not any(LAUNCHES.values()), dict(LAUNCHES)


@pytest.mark.cuda
def test_training_runtime_on_the_card(tmp_path):
    """The loader's pinned, non-blocking copy to the card gives the CPU's
    batches; the loop takes two steps on the card and a resumed run a third,
    with finite losses and the pair restored."""
    import copy
    import json
    import os

    from smart_vocoder_torch.config import HParams, validate
    from smart_vocoder_torch.data import AudioSpecDataset, BucketedLoader, BucketSampler
    from smart_vocoder_torch.tools.make_corpus import write_corpus
    from smart_vocoder_torch.training import loop as loop_lib
    from test_torch_distributed import CFG

    files = write_corpus(str(tmp_path / "corpus"), clips=8, min_frames=40, max_frames=68)
    cfg = copy.deepcopy(CFG)
    cfg["train"].update(eval_interval=2)
    cfg["data"].update(training_files=files, validation_files=files)
    cfg["model"]["use_spk_embed"] = False
    cfg["tpu"] = {"bucket_boundaries": [32, 50, 70], "eval_samples": 2, "keep_ckpts": 2}
    hps = validate(HParams(**cfg))
    hps.model_dir = str(tmp_path / "run")

    ds = AudioSpecDataset(files, hps.data)
    sampler = BucketSampler(ds.lengths, 2, [32, 50, 70])
    sampler.set_epoch(1)
    on_card = list(BucketedLoader(ds, sampler, device="cuda"))
    on_cpu = list(BucketedLoader(ds, sampler))
    assert len(on_card) == len(on_cpu) > 0
    for a, b in zip(on_card, on_cpu):
        assert a.spec.is_cuda and torch.equal(a.spec.cpu(), b.spec)
        assert torch.equal(a.wav.cpu(), b.wav) and torch.equal(a.spec_lengths.cpu(),
                                                               b.spec_lengths)

    loop_lib.run(hps, max_steps=2, device="cuda")
    loop_lib.run(hps, max_steps=3, device="cuda")
    with open(os.path.join(hps.model_dir, "train.log")) as f:
        log = f.read()
    assert "resumed from step 2" in log
    losses = [json.loads(line.split("\t")[-1]) for line in log.splitlines()
              if line.split("\t")[-1].startswith("[")]
    assert [row[5] for row in losses] == [0, 1, 2]
    assert all(np.isfinite(row[:5]).all() for row in losses)


@pytest.mark.cuda
def test_train_cli_under_torchrun_on_every_card(tmp_path):
    """The ``train`` CLI under ``torchrun``, one NCCL rank per card: 3 steps,
    then a second launch that every rank resumes from the chief's pair (the
    ranks agree on the resumed step) for 2 more; finite losses at each step.
    Needs two cards or more."""
    import json
    import os
    import subprocess
    import sys

    from test_torch_distributed import free_port, write_run_config

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two CUDA cards or more for NCCL across cards ({cards} here)")
    write_run_config(tmp_path)
    env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), OMP_NUM_THREADS="1")
    for steps in (3, 5):
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(cards),
             "--master_addr", "127.0.0.1", "--master_port", str(free_port()),
             "-m", "smart_vocoder_torch.train", "-c", "cfg.json", "-m", "nccl",
             "--max-steps", str(steps)], cwd=tmp_path, env=env, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    log = (tmp_path / "logs" / "nccl" / "train.log").read_text()
    assert f"torch.distributed nccl: rank 0 of {cards} on cuda:0" in log
    assert "resumed from step 3" in log
    losses = [json.loads(ln.split("\t")[-1]) for ln in log.splitlines()
              if ln.split("\t")[-1].startswith("[")]
    assert [row[5] for row in losses] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(row[:5]).all() for row in losses)


def _iitp_base_vocoders(**kw):
    """iitp_base at full width, seeded weights, bf16 hifi 2: a one-device
    ``Vocoder`` on ``cuda:0`` and one with ``kw`` (its ``devices``)."""
    import os

    from smart_vocoder_torch.config import load_config
    from smart_vocoder_torch.inference import Vocoder
    from smart_vocoder_torch.models import build_synthesizer
    from smart_vocoder_torch.utils.init import init_synthesizer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    hps = load_config(os.path.join(root, "configs", "iitp_base.json"))
    state = init_synthesizer(build_synthesizer(hps, weight_norm=True), 1234).state_dict()
    opts = dict(dtype=torch.bfloat16, hifi=2, buckets=(128,))
    return hps, Vocoder(hps, state, device="cuda:0", **opts), Vocoder(hps, state, **opts, **kw)


def _mel_batch(b, seed=0):
    rng = np.random.default_rng(seed)
    mel = (rng.normal(0, 1, (b, 100, 80)) * 2.0 - 4.0).astype(np.float32)
    return mel, rng.integers(60, 101, b)


def _mel_l1(hps, got, want):
    from smart_vocoder_torch.ops import MelConfig, mel_spectrogram

    cfg = MelConfig.from_hparams(hps)
    a, b = (mel_spectrogram(torch.from_numpy(np.concatenate(w))[None], cfg) for w in (got, want))
    return (a - b).abs().mean().item()


@pytest.mark.cuda
def test_vocoder_two_shards_on_one_card():
    """``Vocoder(devices=["cuda:0", "cuda:0"])`` at iitp_base, bf16 hifi 2,
    B = 5: each shard bit-equal to a one-device decode of its rows on the
    same card (the noise drawn for the whole batch, split with the rows), and
    each shard launched the two stage kernels."""
    from smart_vocoder_torch.kernels import LAUNCHES, reset_launch_counts
    from smart_vocoder_torch.parallel import split_rows

    _, one, two = _iitp_base_vocoders(devices=["cuda:0", "cuda:0"])
    try:
        mel, lengths = _mel_batch(5)
        eps = one.batch_eps(5, 5, 128).numpy()
        reset_launch_counts()
        got = two.mel_to_wav(mel, lengths, seed=5)
        counts = dict(LAUNCHES)
        assert counts["mrf_stage"] == counts["up_mrf_stage"] == 2, counts
        for r in split_rows(5, 2):
            for g, w in zip(got[r], one.mel_to_wav(mel[r], lengths[r], eps=eps[r])):
                assert np.isfinite(g).all()
                np.testing.assert_array_equal(g, w)
    finally:
        two.close()


@pytest.mark.cuda
def test_vocoder_over_every_card():
    """``Vocoder(devices=data_devices())``: each card holds its own replica,
    and each card's shard is within mel-L1 1e-3 of ``cuda:0``'s decode of the
    same rows (another card may pick other convolution algorithms). Needs two
    cards or more."""
    from smart_vocoder_torch.parallel import data_devices, split_rows

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two CUDA cards or more ({cards} here)")
    hps, one, many = _iitp_base_vocoders(devices=data_devices())
    try:
        for d, rep in many._replicas.items():
            assert all(p.device == d for p in rep.net.parameters())
            assert all(t.device == d for stage in rep.dec_packed if stage.kernel is not None
                       for t in stage.kernel)
        b = 2 * cards + 1
        mel, lengths = _mel_batch(b, seed=1)
        eps = one.batch_eps(3, b, 128).numpy()
        got = many.mel_to_wav(mel, lengths, seed=3)
        for r in split_rows(b, cards):
            want = one.mel_to_wav(mel[r], lengths[r], eps=eps[r])
            assert _mel_l1(hps, got[r], want) <= 1e-3
    finally:
        many.close()


@pytest.mark.cuda
def test_train_cli_starts_a_rank_per_card(tmp_path):
    """The ``train`` CLI without torchrun at ``tpu.data_parallel: -1``:
    one NCCL rank per card, 3 steps with finite losses. Needs two cards or
    more."""
    import json
    import os
    import subprocess
    import sys

    from test_torch_distributed import write_run_config

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two CUDA cards or more ({cards} here)")
    write_run_config(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "smart_vocoder_torch.train", "-c", "cfg.json", "-m", "dp",
         "--max-steps", "3"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    log = (tmp_path / "logs" / "dp" / "train.log").read_text()
    assert f"torch.distributed nccl: rank 0 of {cards} on cuda:0" in log
    losses = [json.loads(ln.split("\t")[-1]) for ln in log.splitlines()
              if ln.split("\t")[-1].startswith("[")]
    assert [row[5] for row in losses] == [0, 1, 2]
    assert all(np.isfinite(row[:5]).all() for row in losses)


@pytest.mark.cuda
def test_train_model_axis_on_cards(tmp_path):
    """The ``train`` CLI without torchrun at ``tpu.model_parallel: 2`` and
    ``data_parallel: -1`` (an even count of cards): one NCCL rank per card in
    model groups of two cards, 3 steps, then a second call that resumes the pair for 2 more;
    finite losses, and the pair holds AdamW's full-shaped moments. The tiny
    config at ``upsample_initial_channel: 128``, where the shard rule takes
    tensors of G and of D. Needs two cards or more."""
    import json
    import os
    import subprocess
    import sys

    from test_torch_distributed import write_run_config

    from smart_vocoder_torch.config import HParams, validate
    from smart_vocoder_torch.models import build_discriminator, build_synthesizer
    from smart_vocoder_torch.utils.torch_compat import load_torch_checkpoint

    cards = torch.cuda.device_count()
    if cards < 2:
        pytest.skip(f"needs two CUDA cards or more ({cards} here)")
    write_run_config(tmp_path)
    cfg = json.loads((tmp_path / "cfg.json").read_text())
    cfg["model"]["upsample_initial_channel"] = 128
    # -1 is every card over the model axis; an odd count of cards leaves one out
    cfg["tpu"].update(data_parallel=-1 if cards % 2 == 0 else cards // 2, model_parallel=2)
    (tmp_path / "cfg.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
               OMP_NUM_THREADS="1")
    for steps in (3, 5):
        proc = subprocess.run(
            [sys.executable, "-m", "smart_vocoder_torch.train", "-c", "cfg.json", "-m", "mp",
             "--max-steps", str(steps)], cwd=tmp_path, env=env, capture_output=True,
            text=True, timeout=600)
        assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    world = cards - cards % 2
    log = (tmp_path / "logs" / "mp" / "train.log").read_text()
    assert f"torch.distributed nccl: rank 0 of {world} on cuda:0" in log
    assert f"mesh: data {world // 2} x model 2 (rank 0: data index 0, model index 0)" in log
    assert "resumed from step 3" in log
    losses = [json.loads(ln.split("\t")[-1]) for ln in log.splitlines()
              if ln.split("\t")[-1].startswith("[")]
    assert [row[5] for row in losses] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(row[:5]).all() for row in losses)
    hps = validate(HParams(**cfg))
    for tag, net in (("G", build_synthesizer(hps)), ("D", build_discriminator(hps))):
        payload = load_torch_checkpoint(str(tmp_path / "logs" / "mp" / f"{tag}_5.pth"))
        assert [tuple(st["exp_avg"].shape) for _, st in sorted(
            payload["optimizer"]["state"].items())] == [tuple(p.shape) for p in net.parameters()]
