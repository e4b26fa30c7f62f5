"""The port's WN stack against the JAX package's Pallas WN kernel.

``smart_vocoder_torch.kernels.wn_stack.wn_stack`` runs its plain version on a
CPU tensor; here it is held against ``fused_wn_stack`` in Pallas interpret
mode at the width the kernel serves (H = 192), 3 layers with
``layers_per_call = 2`` (so the rounding of the skip sum at the end of a
chunk and across chunks is exercised), T = 64 in tiles of 8 packed rows
(several seams), a ragged mask. The CUDA kernel is held against the plain
version on the card by tests/test_torch_cuda.py.

Tolerances:
- f32: 4e-4, the bound tests/test_fast_encoder.py holds the Pallas WN path
  to against the module graph (f32 summation order).
- bf16: both sides round at the same points (gate output, residual update,
  chunk skip sums). One layer: under 1% of the elements differ (a
  summation-order flip of one rounding each; a misplaced rounding moves most
  of them). The full stack: the flips spread through the residual chain, so
  the bound is stated against JAX's own error from bf16 at the same inputs
  (its bf16 result against its f32 result): the port's mean deviation from
  JAX must stay under half of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.kernels._build import SMEM_LIMIT
from smart_vocoder_torch.kernels.mrf import MMA_MAX_ROWS
from smart_vocoder_torch.kernels.wn_stack import (
    pack_wn_stack,
    wn_chunk,
    wn_layers_from_state_dict,
    wn_stack,
    wn_stack_reference,
    wn_smem_bytes,
    wn_tile,
)
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.kernels import encoder as jenc
from smart_vocoder_tpu.kernels import wn_stack as jwn

H, T, LENGTHS = 192, 64, (64, 41)


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


def _layers(rng, n, scale=1.0):
    """Per-layer numpy (w_in, b_in, w_rs, b_rs), torch layout, at torch's
    init scale (uniform +-1/sqrt(fan_in)); the last layer is skip-only."""
    out = []
    for i in range(n):
        rs = H if i == n - 1 else 2 * H
        b_in, b_rs = 1 / np.sqrt(5 * H), 1 / np.sqrt(H)
        out.append(tuple(rng.uniform(-b, b, s).astype(np.float32) * scale for b, s in (
            (b_in, (2 * H, H, 5)), (b_in, (2 * H,)), (b_rs, (rs, H, 1)), (b_rs, (rs,)))))
    return out


def _inputs(seed, n_layers):
    rng = np.random.default_rng(seed)
    mask = (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)[..., None]
    x = rng.normal(0, 1, (2, T, H)).astype(np.float32) * mask
    return x, mask, _layers(rng, n_layers)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _jax(x, mask, layers, dtype, lpc=2):
    out = jwn.fused_wn_stack(jnp.asarray(x, dtype), jnp.asarray(mask),
                             [tuple(jnp.asarray(a) for a in lay) for lay in layers], H,
                             layers_per_call=lpc, tile=8, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _port(x, mask, layers, dtype, lpc=2):
    out = wn_stack(torch.from_numpy(x).to(dtype), torch.from_numpy(mask),
                       [tuple(torch.from_numpy(a) for a in lay) for lay in layers], H,
                       layers_per_call=lpc)
    assert out.dtype == dtype and out.shape == x.shape
    return out.float().numpy()


def test_wn_stack_f32_matches_pallas():
    x, mask, layers = _inputs(0, 3)
    want = _jax(x, mask, layers, jnp.float32)
    got = _port(x, mask, layers, torch.float32)
    np.testing.assert_allclose(got, want, rtol=4e-4, atol=4e-4)
    assert np.all(got[1, LENGTHS[1]:] == 0)  # the masked tail


def test_wn_stack_bf16_rounding_points_match_pallas():
    """One (skip-only) layer: gate rounding, skip rounding and the final mask."""
    x, mask, layers = _inputs(1, 1)
    x = _bf16(x)
    want = _jax(x, mask, layers, jnp.bfloat16)
    got = _port(x, mask, layers, torch.bfloat16)
    assert (got != want).mean() < 0.01


@pytest.mark.parametrize("lpc", [2, 4], ids=["two_chunks", "one_chunk"])
def test_wn_stack_bf16_matches_pallas(lpc):
    x, mask, layers = _inputs(2, 3)
    x = _bf16(x)
    want = _jax(x, mask, layers, jnp.bfloat16, lpc)
    exact = _jax(x, mask, [tuple(_bf16(a) for a in lay) for lay in layers], jnp.float32, lpc)
    got = _port(x, mask, layers, torch.bfloat16, lpc)
    jax_err = np.abs(want - exact).mean()
    port_err = np.abs(got - want).mean()
    assert port_err < 0.5 * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_wn_stack_reference_matches_xla(dtype):
    """The non-kernel WN stack (cuDNN form) against ``_wn_stack_xla``. In
    bf16, XLA's CPU convolutions round at points that per-op rounding does
    not reproduce (about half of the outputs differ by an ulp whatever the
    placement), so the bound is fidelity: the port sits no farther from the
    f32 result than JAX does, within 10% (measured 0.93 of JAX's distance)."""
    x, mask, layers = _inputs(3, 3)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    if dtype == "bf16":
        x = _bf16(x)
    want = jenc._wn_stack_xla(jnp.asarray(x, jdt), jnp.asarray(mask, jdt),
                              [tuple(jnp.asarray(a) for a in lay) for lay in layers], H, jdt)
    got = wn_stack_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(mask),
                                 [tuple(torch.from_numpy(a) for a in lay) for lay in layers], H)
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=4e-4, atol=4e-4)
    else:
        exact = np.asarray(jenc._wn_stack_xla(
            jnp.asarray(x), jnp.asarray(mask),
            [tuple(jnp.asarray(_bf16(a)) for a in lay) for lay in layers], H, jnp.float32))
        jax_err = np.abs(want - exact).mean()
        port_err = np.abs(got - exact).mean()
        assert port_err < 1.1 * jax_err, (port_err, jax_err)


def test_wn_layers_from_state_dict_matches_params():
    _, _, layers = _inputs(4, 3)
    tree = {}
    for i, (w_in, b_in, w_rs, b_rs) in enumerate(layers):
        tree[f"in_layers_{i}"] = {"weight": w_in, "bias": b_in}
        tree[f"res_skip_layers_{i}"] = {"weight": w_rs, "bias": b_rs}
    state = state_dict_from_jax_params({"enc_p": {"encoder": tree}})
    want = jwn.wn_layers_from_params(tree, 3)
    got = wn_layers_from_state_dict(state, "enc_p.encoder", 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_wn_stack_rejects_what_the_kernel_does_not_take():
    x, mask, layers = _inputs(5, 2)
    tl = [tuple(torch.from_numpy(a) for a in lay) for lay in layers]
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with pytest.raises(TypeError):
        wn_stack(xt.half(), mt, tl, H)
    with pytest.raises(ValueError):  # odd T: not the JAX contract
        wn_stack(xt[:, :63], mt[:, :63], tl, H)
    with pytest.raises(ValueError):  # mask not (B, T, 1)
        wn_stack(xt, mt[..., 0], tl, H)
    with pytest.raises(ValueError):  # hidden does not match the weights
        wn_stack(xt[..., :128], mt, tl, 128)


def _unpack_bf16(p, n_layers):
    """The bf16 chunk's tiles back as per-layer (w_in (5, H, 2H), w_rs (H, 2H))
    [in][out] in torch's column order, and its biases likewise: out of the
    ``wgmma`` core matrices, then the pass order [a 64 | b 64] per pass."""
    def tiles_back(flat, taps):
        t = flat.float().reshape(-1, 128 // 8, 64 // 8, 8, 8).permute(0, 2, 4, 1, 3)
        t = t.reshape(H // 64, taps, H // 64, 64, 128).permute(1, 2, 3, 0, 4)
        return t.reshape(taps, H, 2 * H)

    def unpair(v):  # [..., pass, (a | b), 64] -> [a | b]
        v = v.reshape(*v.shape[:-1], H // 64, 2, 64)
        return torch.cat([v[..., 0, :].flatten(-2), v[..., 1, :].flatten(-2)], -1)

    n_in = 5 * H * 2 * H
    out = []
    for i in range(n_layers):
        w_in = unpair(tiles_back(p.w[i, :n_in], 5))
        w_rs, b_rs = unpair(tiles_back(p.w[i, n_in:], 1)[0]), unpair(p.b_rs[i])
        if p.last_skip_only and i == n_layers - 1:  # [skip | zeros] -> [zeros | skip]
            w_rs, b_rs = (torch.cat([v[..., H:], v[..., :H]], -1) for v in (w_rs, b_rs))
        out.append((w_in, unpair(p.b_in[i]), w_rs, b_rs))
    return out


def test_packed_weights_compute_the_layers():
    """The kernels' weight layouts (``pack_wn_stack``), evaluated as the
    kernels read them -- a[t, o] = b_in[o] + sum over taps and inputs of
    x[t + tap - 2, i] * w_in[tap, i, o]; [res | skip] = acts @ w_rs + b_rs --
    give torch's convolutions. f32: per layer w_in (5, H, 2H) then w_rs
    (H, 2H); bf16: tiles of 64 x 128 whose pass p pairs tanh (res) columns
    64p.. with sigmoid (skip) columns H + 64p..; the skip-only last layer has
    a zero res half (bf16: zeros beside the skip columns)."""
    x, _, layers = _inputs(6, 3)
    xt = torch.from_numpy(x[:, :16])
    tl = [tuple(torch.from_numpy(a) for a in lay) for lay in layers]
    for dt in (torch.float32, torch.bfloat16):
        packed = pack_wn_stack(tl, H, dt, layers_per_call=2)
        assert [p.w.shape[0] for p in packed] == [2, 1]
        assert [p.last_skip_only for p in packed] == [False, True]
        assert all(p.dtype == dt and p.w.dtype == dt for p in packed)
        if dt == torch.float32:
            views = [[(p.w[i, :5 * H * 2 * H].reshape(5, H, 2 * H), p.b_in[i],
                       p.w[i, 5 * H * 2 * H:].reshape(H, 2 * H), p.b_rs[i])
                      for i in range(p.w.shape[0])] for p in packed]
        else:
            views = [_unpack_bf16(p, p.w.shape[0]) for p in packed]
        xr = xt.to(dt).float()
        for j, (w_in, b_in, w_rs, b_rs) in enumerate(tl):
            pw_in, pb_in, pw_rs, pb_rs = views[j // 2][j % 2]
            w_in, b_in, w_rs, b_rs = (a.to(dt).float() for a in (w_in, b_in, w_rs, b_rs))
            xp = torch.nn.functional.pad(xr, (0, 0, 2, 2))
            a = pb_in + sum(xp[:, tap:tap + 16] @ pw_in[tap] for tap in range(5))
            want = torch.nn.functional.conv1d(xr.transpose(1, 2), w_in, b_in, padding=2)
            torch.testing.assert_close(a, want.transpose(1, 2), rtol=1e-5, atol=1e-5)
            rs = xr @ pw_rs + pb_rs
            want = torch.nn.functional.conv1d(xr.transpose(1, 2), w_rs, b_rs).transpose(1, 2)
            if j == len(tl) - 1:
                assert torch.all(rs[..., :H] == 0)
                rs = rs[..., H:]
            torch.testing.assert_close(rs, want, rtol=1e-5, atol=1e-5)


def test_bf16_packed_layout_pairs_each_gate():
    """Column 64p + c of a bf16 pass tile holds tanh column 64p + c, and
    column 64p + 64 + c its sigmoid partner H + 64p + c (the epilogue forms
    the gate from one thread's two accumulators); likewise res and skip."""
    _, _, layers = _inputs(12, 2)
    tl = [tuple(torch.from_numpy(a) for a in lay) for lay in layers]
    p = pack_wn_stack(tl, H, torch.bfloat16, layers_per_call=2)[0]
    w_in = tl[0][0].bfloat16()  # (2H, H, 5)
    tile_elems, n_in = 64 * 128, 5 * H * 2 * H
    for pas, tap, kc, ci, c in ((0, 0, 0, 3, 5), (1, 4, 2, 63, 60), (2, 2, 1, 17, 0)):
        tile = (pas * 5 + tap) * (H // 64) + kc
        for half, out in ((0, 64 * pas + c), (1, H + 64 * pas + c)):
            col = half * 64 + c
            at = tile * tile_elems + (col // 8) * 512 + (ci // 8) * 64 + (col % 8) * 8 + ci % 8
            assert p.w[0, at] == w_in[out, kc * 64 + ci, tap]
        assert p.b_in[0, 128 * pas + c] == tl[0][1][64 * pas + c].bfloat16().float()
        assert p.b_in[0, 128 * pas + 64 + c] == tl[0][1][H + 64 * pas + c].bfloat16().float()
    w_rs = tl[1][2].bfloat16()  # skip-only: (H, H, 1)
    at = n_in + (1 * (H // 64) + 2) * tile_elems  # pass 1, chunk 2: skip 64..127 | zeros
    tile = p.w[1, at:at + tile_elems]
    assert torch.all(tile[8 * 512:] == 0)
    assert tile[(5 // 8) * 512 + (9 // 8) * 64 + (5 % 8) * 8 + 9 % 8] == w_rs[64 + 5, 128 + 9, 0]


@pytest.mark.parametrize("n_layers", [1, 2, 3, 4])
def test_wn_tile_fits_the_block(n_layers):
    """The tensor-core kernel's tile at H = 192: its buffers and ring fit in
    a block, and the first layer's rows fit the four warpgroups."""
    tile = wn_tile(H, n_layers)
    assert tile + 4 * n_layers - 4 <= MMA_MAX_ROWS
    assert wn_smem_bytes(H, tile, n_layers) <= SMEM_LIMIT
    assert tile == (96 if n_layers <= 2 else 64)


def test_wn_stack_rejects_packed_weights_that_do_not_match():
    x, mask, layers = _inputs(7, 3)
    tl = [tuple(torch.from_numpy(a) for a in lay) for lay in layers]
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    with pytest.raises(ValueError):  # packed for bf16, given f32
        wn_stack(xt, mt, tl, H, 2, packed=pack_wn_stack(tl, H, torch.bfloat16, 2))
    with pytest.raises(ValueError):  # packed in chunks of 1, run in chunks of 2
        wn_stack(xt, mt, tl, H, 2, packed=pack_wn_stack(tl, H, torch.float32, 1))
    ok = wn_stack(xt, mt, tl, H, 2, packed=pack_wn_stack(tl, H, torch.float32, 2))
    torch.testing.assert_close(ok, wn_stack(xt, mt, tl, H, 2), rtol=0, atol=0)


def test_single_launches_compose_to_the_stack():
    """``wn_chunk`` (one launch; its plain version here) chained over the
    chunks, each given the running skip sum, is the stack, bit for bit."""
    x, mask, layers = _inputs(8, 3)
    x = _bf16(x)
    tl = [tuple(torch.from_numpy(a) for a in lay) for lay in layers]
    xt, mt = torch.from_numpy(x).bfloat16(), torch.from_numpy(mask)
    state, skip = xt, torch.zeros_like(xt)
    for n, chunk in enumerate((tl[:2], tl[2:])):
        state, skip = wn_chunk(state, mt, chunk, H, skip, final=n == 1)
        assert state.dtype == skip.dtype == torch.bfloat16
    assert torch.equal(skip, wn_stack(xt, mt, tl, H, layers_per_call=2))
