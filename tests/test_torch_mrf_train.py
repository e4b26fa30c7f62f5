"""The port's MRF stage with the hand-written backward against the JAX package's.

The same numpy inputs go through JAX ``mrf_stage_train(..., interpret=True)``
under ``jax.vjp`` (as tests/test_mrf_train.py runs it) and through the port's
``mrf_stage_train`` under ``torch.autograd``; on CPU tensors the port runs its
plain versions (``mrf_stage_plain``, ``mrf_branch_bwd_plain``), which the CUDA
kernels are held against on the card by tests/test_torch_cuda.py.

Tolerances (the JAX test's own):
- f32: value atol 2e-4 / rtol 1e-4; dx and the 12 weight gradients atol 2e-3
  / rtol 1e-3 (f32 summation order).
- bf16: the port's dx is no further from the f32 oracle than 1.5 x the JAX
  kernel's + 1e-3.
A tenth of x is set to exactly 0, where the leaky gradient must take the slope
on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.kernels import mrf as tmrf
from smart_vocoder_torch.kernels import mrf_train as ttrain
from smart_vocoder_torch.tools import ab_mrf_train
from smart_vocoder_tpu.kernels import mrf_train as jtrain
from smart_vocoder_tpu.kernels.mrf import mrf_stage_reference

KS, DILS = (3, 7, 11), (1, 3, 5)
C = 8
NAMES = ("w1", "b1", "w2", "b2")


def _inputs(seed, t, zeros=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, t, C)).astype(np.float32)
    if zeros:
        x[rng.random(x.shape) < 0.1] = 0.0
    branches = [tuple(rng.normal(0, s, shape).astype(np.float32)
                      for s, shape in ((0.3, (3, k, C, C)), (0.1, (3, C)),
                                       (0.3, (3, k, C, C)), (0.1, (3, C)))) for k in KS]
    g = rng.normal(0, 1, (2, t, C)).astype(np.float32)
    return x, branches, g


def _jb(branches, dtype=jnp.float32):
    return [tuple(jnp.asarray(a, dtype) for a in br) for br in branches]


def _port_vjp(x, branches, g, dtype=torch.float32):
    xt = torch.from_numpy(x).to(dtype).requires_grad_()
    br = [tuple(torch.from_numpy(a).to(dtype).requires_grad_() for a in b) for b in branches]
    out = ttrain.mrf_stage_train(xt, br, KS, DILS)
    out.backward(torch.from_numpy(g).to(dtype))
    return out.detach(), xt.grad, [tuple(a.grad for a in b) for b in br]


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.mark.parametrize("t,tile", [(40, 16), (64, 32), (37, 16), (53, 24)])
def test_value_and_grads_match_jax_kernel(t, tile):
    x, branches, g = _inputs(0, t)
    want_out, vjp = jax.vjp(
        lambda x, br: jtrain.mrf_stage_train(x, br, KS, DILS, tile, True),
        jnp.asarray(x), _jb(branches))
    want_dx, want_dbr = vjp(jnp.asarray(g))
    out, dx, dbr = _port_vjp(x, branches, g)
    assert out.dtype == dx.dtype == torch.float32 and dx.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=2e-3, rtol=1e-3)
    for got, want in zip(dbr, want_dbr):
        for a, b, name in zip(got, want, NAMES):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3, rtol=1e-3,
                                       err_msg=name)


def test_bf16_grads_as_close_as_the_jax_kernel():
    x, branches, g = _inputs(2, 48)
    _, ref_vjp = jax.vjp(lambda x, br: mrf_stage_reference(x, br, KS, DILS),
                         jnp.asarray(x), _jb(branches))
    ref_dx = np.asarray(ref_vjp(jnp.asarray(g))[0])
    _, vjp = jax.vjp(lambda x, br: jtrain.mrf_stage_train(x, br, KS, DILS, 16, True),
                     jnp.asarray(x, jnp.bfloat16), _jb(branches, jnp.bfloat16))
    jax_dx = np.asarray(vjp(jnp.asarray(g, jnp.bfloat16))[0].astype(jnp.float32))
    out, dx, dbr = _port_vjp(x, branches, g, torch.bfloat16)
    assert out.dtype == dx.dtype == dbr[0][0].dtype == torch.bfloat16
    err_port = np.abs(dx.float().numpy() - ref_dx).max()
    err_jax = np.abs(jax_dx - ref_dx).max()
    assert err_port <= 1.5 * err_jax + 1e-3, (err_port, err_jax)


@pytest.mark.parametrize("k", KS)
def test_plain_backward_matches_autograd_in_f32(k):
    """The written-out backward against torch.autograd of the plain stage,
    one branch, on inputs without exact zeros (where autograd's maximum splits
    the gradient and the backward takes the slope)."""
    x, branches, g = _inputs(5, 45, zeros=False)
    branch = tuple(torch.from_numpy(a) for a in branches[KS.index(k)])
    dx, dws = ttrain.mrf_branch_bwd(torch.from_numpy(x), torch.from_numpy(g), branch, k, DILS)
    xt = torch.from_numpy(x).requires_grad_()
    br = tuple(a.clone().requires_grad_() for a in branch)
    tmrf.mrf_stage_plain(xt, [br], (k,), DILS, tmrf.F32).backward(torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), xt.grad.numpy(), atol=2e-3, rtol=1e-3)
    for a, b, name in zip(dws, br, NAMES):
        np.testing.assert_allclose(a.numpy(), b.grad.numpy(), atol=2e-3, rtol=1e-3,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_returns_and_takes_a_replay(dtype):
    """``with_replay`` returns the chain the backward went through -- each
    pair's input and conv1 output, x_0 = x -- and the plain backward on a given
    replay is the plain backward itself when the replay is its own."""
    x, branches, g = _inputs(3, 29)
    xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    branch = tuple(torch.from_numpy(a) for a in branches[1])
    dx, dws, (xs, hs) = ttrain.mrf_branch_bwd(xt, gt, branch, 7, DILS, with_replay=True)
    want_xs, want_hs = ttrain.branch_replay_plain(xt, branch, 7, DILS)
    assert len(xs) == len(hs) == 3 and torch.equal(xs[0], xt)
    for a, b in zip(xs + hs, want_xs + want_hs):
        assert a.dtype == dtype and a.shape == xt.shape and torch.equal(a, b)
    dx2, dws2 = ttrain.mrf_branch_bwd_plain(xt, gt, branch, 7, DILS, replay=(xs, hs))
    assert torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))
    # the last pair's output is x_2 + c2(lrelu(h_2)): the stage with this one branch
    out = tmrf.mrf_stage_unpacked(xt, [branch], (7,), DILS).float()
    w2, b2 = branch[2][2].to(dtype).float(), branch[3][2].to(dtype).float()
    mode = tmrf.BF16 if dtype == torch.bfloat16 else tmrf.F32
    y = torch.nn.functional.conv1d(tmrf._leaky(hs[2].float().transpose(1, 2), 0.1, mode),
                                   w2.permute(2, 1, 0), b2, padding=3)
    last = tmrf._store(tmrf._store(y, mode) + xs[2].float().transpose(1, 2), mode)
    np.testing.assert_allclose(out.numpy(), last.transpose(1, 2).numpy(), atol=1e-5)


def test_zero_input_takes_the_slope():
    """At x == 0 the derivative of the leaky relu is its slope, not a split."""
    x = torch.zeros(1, 9, C)
    g = torch.ones(1, 9, C)
    w = torch.zeros(1, 3, C, C)
    w[0, 1] = torch.eye(C)  # identity convs, zero biases: h = lrelu(x) = 0 too
    zero = torch.zeros(1, C)
    dx, _ = ttrain.mrf_branch_bwd(x, g, (w, zero, w, zero), 3, (1,))
    np.testing.assert_allclose(dx.numpy(), 1 + tmrf.LRELU_SLOPE ** 2, rtol=1e-6)


def test_function_returns_none_where_no_gradient_is_needed():
    x, branches, g = _inputs(1, 32)
    xt = torch.from_numpy(x)
    br = [tuple(torch.from_numpy(a) for a in b) for b in branches]
    br[1] = (br[1][0].requires_grad_(), br[1][1], br[1][2], br[1][3].requires_grad_())
    out = ttrain.mrf_stage_train(xt, br, KS, DILS)
    out.backward(torch.from_numpy(g))
    assert xt.grad is None
    flat = [a for b in br for a in b]
    assert [a.grad is not None for a in flat] == [i in (4, 7) for i in range(12)]
    x2 = torch.from_numpy(x).requires_grad_()
    ttrain.mrf_stage_train(x2, [tuple(a.detach() for a in b) for b in br], KS, DILS).backward(
        torch.from_numpy(g))
    assert x2.grad is not None and all(a.grad is None for b in br[:1] for a in b)


@pytest.mark.parametrize("k", [3, 5, 7, 11])
def test_branch_bwd_halo_matches_jax(k):
    assert ttrain.branch_bwd_halo(k, DILS) == jtrain.branch_bwd_halo(k, DILS)
    assert ttrain.branch_bwd_halo(k, (1,)) == jtrain.branch_bwd_halo(k, (1,))


def test_backward_rejects_mismatched_cotangent_and_weights():
    x, branches, g = _inputs(1, 16)
    br = tuple(torch.from_numpy(a) for a in branches[0])
    with pytest.raises(ValueError):
        ttrain.mrf_branch_bwd(torch.from_numpy(x), torch.from_numpy(g)[:, :8], br, 3, DILS)
    with pytest.raises(ValueError):  # the k = 3 weights under k = 7
        ttrain.mrf_branch_bwd(torch.from_numpy(x), torch.from_numpy(g), br, 7, DILS)
    with pytest.raises(TypeError):
        ttrain.mrf_branch_bwd(torch.from_numpy(x).half(), torch.from_numpy(g), br, 3, DILS)


def test_ab_tool_runs_both_legs_on_the_cpu(monkeypatch):
    """The A/B entry point at a tiny size: in f32 its two legs -- the
    weight-normed ResBlock1 modules under autograd and ``mrf_stage_train`` on
    the weights folded under autograd -- give the same loss and gradients."""
    rows = ab_mrf_train.main(reps=1, iters=1, device="cpu", batch=1, seg_frames=1,
                             dtype=torch.float32)
    assert [(r["t"], r["ch"]) for r in rows] == [(8, 256), (64, 128), (128, 64), (256, 32)]
    for r in rows:
        assert abs(r["loss_kernel"] - r["loss_autograd"]) <= 1e-5
        assert r["dx_rel_max"] <= 1e-4 and r["dw_rel_max"] <= 1e-4
        assert r["launches"] == {}  # CPU tensors take the plain versions
    assert [s for s in ab_mrf_train.stage_shapes()] == [(0, 256, 256), (1, 2048, 128),
                                                       (2, 4096, 64), (3, 8192, 32)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ab_mrf_train.main(reps=1, iters=1)


def _split_backward(x, g, branch, k):
    """The CUDA backward's pieces in its order, on the plain replay: per pair
    from the last, conv2's weight gradients, the dx step, conv1's."""
    xs, hs = ttrain.branch_replay_plain(x, branch, k, DILS)
    w1, _, w2, _ = (tmrf._round_to(a, x.dtype) for a in branch)
    dy, grads = g, {}
    for j in reversed(range(len(DILS))):
        grads["dw2", j], grads["db2", j] = ttrain.conv_dw_plain(hs[j], dy, k, 1)
        dy, dh = ttrain.pair_dx_plain(dy, xs[j], hs[j], w1[j], w2[j], k, DILS[j])
        grads["dw1", j], grads["db1", j] = ttrain.conv_dw_plain(xs[j], dh, k, DILS[j])
    return dy, [torch.stack([grads[n, j] for j in range(len(DILS))])
                for n in ("dw1", "db1", "dw2", "db2")]


@pytest.mark.parametrize("t", [37, 12], ids=["ragged", "below_tile"])
@pytest.mark.parametrize("k", KS)
def test_split_backward_pieces_match_jax_kernel(k, t):
    """The plain pieces of the split backward -- the replay, each pair's dx
    step (``pair_dx_plain``) and the weight-gradient GEMM over the saved
    tensors (``conv_dw_plain``) -- composed as the kernels run them, against
    the JAX kernel's gradients (tile 16: T = 37 ends inside the third tile, and
    T = 12 lies within one). f32, the JAX test's tolerance: atol 2e-3, rtol
    1e-3 (summation order)."""
    x, branches, g = _inputs(6, t)
    branch = branches[KS.index(k)]
    want_dx, want = jtrain.mrf_branch_bwd(jnp.asarray(x), jnp.asarray(g),
                                          tuple(jnp.asarray(a) for a in branch), k, DILS,
                                          16, True)
    dx, got = _split_backward(torch.from_numpy(x), torch.from_numpy(g),
                              tuple(torch.from_numpy(a) for a in branch), k)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=2e-3, rtol=1e-3)
    for a, b, name in zip(got, want, NAMES):
        assert a.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_backward_is_the_plain_backward(dtype):
    """The pieces composed give the plain backward bit for bit, in both modes
    (bf16: each piece takes and returns bf16 values, so nothing is lost
    between them)."""
    x, branches, g = _inputs(7, 41)
    branch = tuple(torch.from_numpy(a) for a in branches[2])
    xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    dx, got = _split_backward(xt, gt, branch, 11)
    want_dx, want = ttrain.mrf_branch_bwd_plain(xt, gt, branch, 11, DILS)
    assert dx.dtype == dtype and torch.equal(dx, want_dx)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("c", [32, 64, 128, 256])
@pytest.mark.parametrize("k", KS)
def test_backward_tiles_and_shared_memory_mirror(c, k):
    """The dx step's tile and shared memory (``csrc/mrf_train.cu``) for every
    dilation: dy over tile + 2(hd + h) rows, dh over tile + 2hd, bf16 rows
    padded by 8, and the unpacked stage's ring; the tile is the largest
    candidate whose dq rows (tile + 2hd) the warpgroups cover and whose block
    fits. The replay keeps the forward's tile."""
    h, geo = (k - 1) // 2, tmrf.pair_geometry(c)
    ring = geo.stages * (64 if c >= 128 else c) * (c + 8) * 2
    tile = ttrain.branch_bwd_tile(c, k, DILS)

    def fits(tl, d):
        smem = ((tl + 2 * (h * d + h)) + (tl + 2 * h * d)) * (c + 8) * 2 + ring
        assert ttrain.branch_bwd_smem_bytes(c, tl, h, d) == smem
        return tl + 2 * h * d <= geo.threads // 2 and smem <= tmrf.SMEM_LIMIT

    for d in (1, 3, 5):
        assert fits(tile, d)
    larger = [tl for tl in tmrf.PAIR_TILES if tl > tile]
    assert all(not all(fits(tl, d) for d in DILS) for tl in larger)
    assert tile == (64 if c == 256 else 240 if k == 3 else 128)
    if (c, k) == (256, 11):
        assert ttrain.branch_bwd_smem_bytes(c, tile, h, 5) == 227_040


@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_weight_gradient_grid_covers_every_row_once(c):
    """The weight-gradient launch: four blocks fit on an SM (228 KB, 1 KB a block
    kept by the card), three at C = 32 with its longer chunks; the
    K ranges the blocks take (``split * chunks // splits`` ..) cover every
    chunk of the B * T rows once, each at least DW_MIN_CHUNKS long where the
    rows allow; and the blocks fill the card at the training shapes."""
    geo = ttrain.dw_geometry(c)
    per_sm = 228 * 1024 // (ttrain.dw_smem_bytes(c) + 1024)
    assert per_sm == (4 if c >= 64 else 3)
    assert ttrain.dw_smem_bytes(c) == (55_296 if c >= 64 else 61_440)
    rows = {256: 16 * 256, 128: 16 * 2048, 64: 16 * 4096, 32: 16 * 8192}[c]
    for k in KS:
        for r in (rows, 1, 777 * 2):
            splits = ttrain.dw_splits(r, c, k, 6)
            chunks = -(-r // geo.kc)
            ranges = [(s * chunks // splits, (s + 1) * chunks // splits) for s in range(splits)]
            covered = [q for lo, hi in ranges for q in range(lo, hi)]
            assert covered == list(range(chunks))
            assert chunks < ttrain.DW_MIN_CHUNKS or min(hi - lo for lo, hi in ranges) >= (
                ttrain.DW_MIN_CHUNKS)
        blocks = 6 * k * (c // geo.tm) ** 2 * ttrain.dw_splits(rows, c, k, 6)
        assert blocks >= per_sm * 132


def _unpack_tiles(flat, k, c):
    """:func:`pack_mrf_weights`' tiles of one conv back to (k, C, C)."""
    if c <= 64:
        tiles = flat.reshape(k, c, c)
        if c != tmrf.WGMMA_CHANNELS:
            return tiles
        return tiles.reshape(k, c // 8, c // 8, 8, 8).permute(0, 2, 4, 1, 3).reshape(k, c, c)
    tiles = flat.reshape(-1, c // 8, 8, 8, 8).permute(0, 2, 4, 1, 3).reshape(-1, 64, c)
    return tiles.reshape(k, c, c)


@pytest.mark.parametrize("c", [32, 64, 128, 256])
def test_flipped_weight_packing_round_trips(c):
    """The dx step's tiles [pair][flip(w2)^T, flip(w1)^T] unpack to
    ``w.flip(1).transpose(-1, -2)`` bit for bit, and the replay's tiles to the
    branch's own weights."""
    rng = np.random.default_rng(c)
    k, n = 3, 2
    branch = tuple(torch.from_numpy(rng.normal(0, 0.1, s).astype(np.float32)).bfloat16().float()
                   for s in ((n, k, c, c), (n, c), (n, k, c, c), (n, c)))
    wf, wb = ttrain.pack_branch_weights(branch)
    assert wf.dtype == wb.dtype == torch.bfloat16 and wf.numel() == wb.numel() == 2 * n * k * c * c
    conv = k * c * c
    for j in range(n):
        for i, (fwd, bwd) in enumerate(((branch[0], branch[2]), (branch[2], branch[0]))):
            got_f = _unpack_tiles(wf[(2 * j + i) * conv:(2 * j + i + 1) * conv], k, c)
            got_b = _unpack_tiles(wb[(2 * j + i) * conv:(2 * j + i + 1) * conv], k, c)
            assert torch.equal(got_f.float(), fwd[j])
            assert torch.equal(got_b.float(), bwd[j].flip(0).transpose(-1, -2))
