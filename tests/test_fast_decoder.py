"""Fast functional decoder (kernels/decoder.py) parity vs the flax Generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smart_vocoder_tpu.kernels.decoder import DecoderConfig, decoder_apply
from smart_vocoder_tpu.models import Generator
from smart_vocoder_tpu.nn import fold_weight_norm


@pytest.fixture(scope="module")
def gen_setup():
    cfg = DecoderConfig(
        resblock="1", resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5),) * 3,
        upsample_rates=(8, 8, 2, 2), upsample_initial_channel=64,
        upsample_kernel_sizes=(16, 16, 4, 4),
    )
    mod = Generator(
        32, cfg.resblock, cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes,
        cfg.upsample_rates, cfg.upsample_initial_channel, cfg.upsample_kernel_sizes,
        channel_pack=False,
    )
    x = jax.random.normal(jax.random.key(0), (2, 16, 32)) * 0.5
    params = mod.init(jax.random.key(1), x)["params"]
    want = mod.apply({"params": params}, x)
    folded = fold_weight_norm(params)
    return cfg, folded, x, want


class TestFastDecoder:
    def test_xla_path_matches_module(self, gen_setup):
        cfg, folded, x, want = gen_setup
        got = decoder_apply(folded, x, cfg, dtype=jnp.float32)
        assert got.shape == want.shape == (2, 16 * 256, 1)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-4, atol=1e-4)

    def test_pallas_path_matches_module(self, gen_setup):
        cfg, folded, x, want = gen_setup
        got = decoder_apply(folded, x, cfg, use_pallas=True, interpret=True,
                            dtype=jnp.float32)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=3e-4, atol=3e-4)


class TestVocoderPallas:
    def test_vocoder_use_pallas_matches(self, tmp_path):
        import json, os
        from test_inference_api import tiny_vocoder
        from smart_vocoder_tpu.config import load_config
        from smart_vocoder_tpu.inference import Vocoder
        from smart_vocoder_tpu.models import build_synthesizer

        # resblock-1 tiny config (the fast path's family)
        hps, params = tiny_vocoder(tmp_path)
        hps.model.resblock = "1"
        hps.model.resblock_kernel_sizes = [3, 7]
        hps.model.resblock_dilation_sizes = [[1, 3, 5], [1, 3, 5]]
        net = build_synthesizer(hps)
        t = 64
        mel0 = jnp.zeros((1, t, 80))
        spec0 = jnp.zeros((1, t, 513))
        lens0 = jnp.full((1,), t, jnp.int32)
        params = net.init(jax.random.key(0), mel0, lens0, spec0, lens0,
                          jax.random.key(1))["params"]
        mel = np.random.default_rng(0).normal(-4, 2, (1, 64, 80)).astype(np.float32)
        a = Vocoder(hps, params, dtype=jnp.float32, buckets=(64,), use_pallas=False)
        b = Vocoder(hps, params, dtype=jnp.float32, buckets=(64,), use_pallas=True)
        wa = a.mel_to_wav(mel, seed=3)[0]
        wb = b.mel_to_wav(mel, seed=3)[0]
        np.testing.assert_allclose(wb, wa, atol=5e-4)

    def test_vocoder_hifi_knob(self, tmp_path):
        """The serving-fidelity tail is reachable (and ON by default) through
        the public Vocoder API, not just bench.py's private closure (advisor
        round-3 medium finding)."""
        from test_inference_api import tiny_vocoder
        from smart_vocoder_tpu.inference import Vocoder
        from smart_vocoder_tpu.models import build_synthesizer

        hps, _ = tiny_vocoder(tmp_path)
        hps.model.resblock = "1"
        hps.model.resblock_kernel_sizes = [3, 7]
        hps.model.resblock_dilation_sizes = [[1, 3, 5], [1, 3, 5]]
        net = build_synthesizer(hps)
        t = 64
        mel0 = jnp.zeros((1, t, 80))
        spec0 = jnp.zeros((1, t, 513))
        lens0 = jnp.full((1,), t, jnp.int32)
        params = net.init(jax.random.key(0), mel0, lens0, spec0, lens0,
                          jax.random.key(1))["params"]

        voc = Vocoder(hps, params, dtype=jnp.bfloat16, buckets=(64,),
                      use_pallas=True)
        assert voc.hifi, "bf16+pallas Vocoder must default to the benched hifi config"
        # knob off -> max-throughput path; f32 -> hifi is a no-op, coerced off
        assert not Vocoder(hps, params, dtype=jnp.bfloat16, buckets=(64,),
                           use_pallas=True, hifi=False).hifi
        assert not Vocoder(hps, params, dtype=jnp.float32, buckets=(64,),
                           use_pallas=True).hifi

        mel = np.random.default_rng(0).normal(-4, 2, (1, 64, 80)).astype(np.float32)
        wav = voc.mel_to_wav(mel, seed=3)[0]  # interpret-mode Pallas on CPU
        assert wav.shape == (64 * hps.data.hop_length,)
        assert np.isfinite(wav).all() and np.abs(wav).max() <= 1.0


def test_fold_post_multi_tile_seams():
    """fused_up_mrf_stage with the conv_post tail folded in, forced to n_tiles>1
    (small tile override) so conv_post consumes halo rows across tile seams.
    Guards the additive branch+post radius computation (kernels/mrf.py): with a
    max()-based radius, block-edge zero padding would leak into conv_post at
    every tile*pack samples."""
    from smart_vocoder_tpu.kernels.decoder import _conv1d, _conv_transpose_polyphase
    from smart_vocoder_tpu.kernels.mrf import fused_up_mrf_stage, mrf_stage_reference

    rng = np.random.default_rng(7)
    cin, cout, k, s, pad = 64, 32, 4, 2, 1
    ks, dil = (3, 7, 11), (1, 3, 5)
    tu = 256  # ps = pack/s = 2 -> tp = 128; tile=32 -> 4 tiles

    def r(*shape, scale=0.1):
        return jnp.asarray(rng.normal(0, scale, shape), jnp.float32)

    up_w = r(cin, cout, k)          # torch ConvTranspose layout (Cin, Cout, k)
    up_b = r(cout)
    branches = [
        (jnp.stack([r(kk, cout, cout) for _ in dil]), jnp.stack([r(cout) for _ in dil]),
         jnp.stack([r(kk, cout, cout) for _ in dil]), jnp.stack([r(cout) for _ in dil]))
        for kk in ks
    ]
    post_w = r(1, cout, 7)          # conv_post torch layout (1, Cout, k)
    x = r(2, tu, cin, scale=0.5)

    got = fused_up_mrf_stage(
        x, up_w, up_b, k, s, pad, branches, ks, dil,
        tile=32, interpret=True, post_weight=post_w,
    )

    y = jax.nn.leaky_relu(x, 0.1)
    y = _conv_transpose_polyphase(y, up_w, up_b, k, s, pad, jnp.float32)
    y = mrf_stage_reference(y, branches, ks, dil)
    y = jax.nn.leaky_relu(y)  # 0.01 slope, matching the kernel tail
    y = _conv1d(y, post_w, None, 3, jnp.float32)
    want = jnp.tanh(y)

    assert got.shape == want.shape == (2, tu * s, 1)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_hifi_kernels_parity():
    """Serving-fidelity kernel modes: fused_up_mrf_stage(hifi=True) (f32
    activations, 2-pass bf16 matmuls, f32 out) and
    fused_mrf_stage_packed(f32_storage=True) both match the f32 reference
    computed with bf16-rounded weights to ~1e-3 -- i.e. the only remaining
    deviation is the (negligible-by-design) weight rounding."""
    from smart_vocoder_tpu.kernels.decoder import _conv1d, _conv_transpose_polyphase
    from smart_vocoder_tpu.kernels.mrf import (
        fused_mrf_stage_packed,
        fused_up_mrf_stage,
        mrf_stage_reference,
    )

    rng = np.random.default_rng(11)
    ks, dil = (3, 7, 11), (1, 3, 5)

    def r(*shape, scale=0.1):
        return jnp.asarray(rng.normal(0, scale, shape), jnp.float32)

    def rw(*shape, scale=0.1):  # weights pre-rounded to bf16 (as hifi uses them)
        return r(*shape, scale=scale).astype(jnp.bfloat16).astype(jnp.float32)

    # --- fused_up hifi (stage4 geometry: p=4, s=2) -------------------------
    cin, cout, k, s, pad, tu = 64, 32, 4, 2, 1, 128
    up_w, up_b = rw(cin, cout, k), rw(cout)
    branches = [
        (jnp.stack([rw(kk, cout, cout) for _ in dil]), jnp.stack([rw(cout) for _ in dil]),
         jnp.stack([rw(kk, cout, cout) for _ in dil]), jnp.stack([rw(cout) for _ in dil]))
        for kk in ks
    ]
    post_w = rw(1, cout, 7)
    x = r(2, tu, cin, scale=0.5)

    got = fused_up_mrf_stage(
        x, up_w, up_b, k, s, pad, branches, ks, dil,
        tile=32, interpret=True, post_weight=post_w, hifi=True,
    )
    assert got.dtype == jnp.float32

    y = jax.nn.leaky_relu(x, 0.1)
    y = _conv_transpose_polyphase(y, up_w, up_b, k, s, pad, jnp.float32)
    y = mrf_stage_reference(y, branches, ks, dil)
    y = jax.nn.leaky_relu(y)
    y = _conv1d(y, post_w, None, 3, jnp.float32)
    want = jnp.tanh(y)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-3, atol=2e-3)

    # --- packed stage f32_storage (stage3 geometry: p=2) -------------------
    # Exact per-op parity with a rounding mirror is impossible here: the
    # packed conv's f32 accumulation order differs from lax.conv's, so bf16
    # roundings can flip one ulp per conv, which the 6-deep residual chains
    # amplify (debugged round 3: single conv pair = exactly 1 ulp). Assert
    # the properties that matter instead: bounded deviation from the f32
    # oracle, and STRICT improvement over the plain bf16 kernel.
    c, t = 64, 256
    branches3 = [
        (jnp.stack([rw(kk, c, c) for _ in dil]), jnp.stack([rw(c) for _ in dil]),
         jnp.stack([rw(kk, c, c) for _ in dil]), jnp.stack([rw(c) for _ in dil]))
        for kk in ks
    ]
    x3 = r(2, t, c, scale=0.5).astype(jnp.bfloat16)
    got3 = fused_mrf_stage_packed(x3, branches3, ks, dil, tile=32,
                                  interpret=True, f32_storage=True)
    assert got3.dtype == jnp.float32
    got3_bf16 = fused_mrf_stage_packed(x3, branches3, ks, dil, tile=32,
                                       interpret=True, f32_storage=False)
    want3 = mrf_stage_reference(x3.astype(jnp.float32), branches3, ks, dil)

    err_hifi = np.abs(np.asarray(got3) - np.asarray(want3))
    err_bf16 = np.abs(np.asarray(got3_bf16, np.float32) - np.asarray(want3))
    # gross-bug bound: halo/packing bugs produce O(signal)~5 errors; the
    # legitimate amplified-ulp deviation measures ~0.14 on this config
    assert err_hifi.max() < 0.5, err_hifi.max()
    # strict improvement: at this random-weight config the shared matmul-input
    # rounding dominates, so the storage fix wins ~1.4x here (measured
    # 0.0233 vs 0.0322); on the real model the split is ~50/50 (bisect R3/R4)
    assert err_hifi.mean() < 0.85 * err_bf16.mean(), (
        err_hifi.mean(), err_bf16.mean())

    # --- packed stage x2 (hifi level 2: stage3 two-pass matmuls) -----------
    # With f32 storage AND hi/lo-split matmul operands the only remaining
    # rounding is the (pre-applied) weight rounding, so the kernel should
    # sit ~at the f32 oracle -- far below the storage-only mode's deviation.
    got3_x2 = fused_mrf_stage_packed(x3, branches3, ks, dil, tile=32,
                                     interpret=True, x2=True)
    assert got3_x2.dtype == jnp.float32
    err_x2 = np.abs(np.asarray(got3_x2) - np.asarray(want3))
    assert err_x2.mean() < 0.2 * err_hifi.mean(), (
        err_x2.mean(), err_hifi.mean())


def test_conv_transpose_packed_matches_polyphase():
    """The packed-domain transposed conv (measured-and-rejected for serving
    routing, kept as a building block) is bit-compatible with the polyphase
    lowering on the ups_3 geometry."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from smart_vocoder_tpu.kernels.decoder import (
        _conv_transpose_packed,
        _conv_transpose_polyphase,
    )

    cin, cout, k, s, pad, pack = 64, 32, 4, 2, 1, 4
    w = jax.random.normal(jax.random.key(0), (cin, cout, k), jnp.float32) * 0.1
    b = jax.random.normal(jax.random.key(1), (cout,), jnp.float32) * 0.1
    x = jax.random.normal(jax.random.key(2), (2, 96, cin), jnp.float32)
    want = _conv_transpose_polyphase(x, w, b, k, s, pad, jnp.float32)
    got = _conv_transpose_packed(x, w, b, k, s, pad, pack, jnp.float32)
    assert got.shape == want.shape == (2, 192, cout)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_hifi_level3_early_f32(gen_setup):
    """hifi level 3: the early-decoder f32-storage island (f32 activations,
    single-bf16 MXU operands in conv_pre / polyphase ups / XLA MRF stages)
    strictly improves on the plain bf16 path, and the mixed-mode XLA MRF
    stage sits between the bf16 and f32 references."""
    from smart_vocoder_tpu.kernels.mrf import mrf_stage_reference

    # -- unit: mrf_stage_reference(mixed_f32) ------------------------------
    rng = np.random.default_rng(7)
    ks, dil, c, t = (3, 7, 11), (1, 3, 5), 32, 64

    def rw(*shape, scale=0.1):  # weights pre-rounded to bf16
        return jnp.asarray(rng.normal(0, scale, shape), jnp.float32) \
            .astype(jnp.bfloat16).astype(jnp.float32)

    branches = [
        (jnp.stack([rw(kk, c, c) for _ in dil]), jnp.stack([rw(c) for _ in dil]),
         jnp.stack([rw(kk, c, c) for _ in dil]), jnp.stack([rw(c) for _ in dil]))
        for kk in ks
    ]
    x = jnp.asarray(rng.normal(0, 0.5, (2, t, c)), jnp.float32)
    want = mrf_stage_reference(x, branches, ks, dil)
    got_mixed = mrf_stage_reference(x, branches, ks, dil, mixed_f32=True)
    assert got_mixed.dtype == jnp.float32
    bf16_branches = [tuple(a.astype(jnp.bfloat16) for a in br) for br in branches]
    got_bf16 = mrf_stage_reference(x.astype(jnp.bfloat16), bf16_branches, ks, dil)
    err_mixed = np.abs(np.asarray(got_mixed) - np.asarray(want)).mean()
    err_bf16 = np.abs(np.asarray(got_bf16, np.float32) - np.asarray(want)).mean()
    assert err_mixed < 0.85 * err_bf16, (err_mixed, err_bf16)

    # -- end-to-end: decoder_apply(hifi_tail=3) ----------------------------
    cfg, folded, xin, want_dec = gen_setup
    for pallas in (False, True):
        got_l3 = decoder_apply(folded, xin, cfg, use_pallas=pallas,
                               interpret=pallas, dtype=jnp.bfloat16, hifi_tail=3)
        got_l0 = decoder_apply(folded, xin, cfg, use_pallas=pallas,
                               interpret=pallas, dtype=jnp.bfloat16, hifi_tail=0)
        e3 = np.abs(np.asarray(got_l3, np.float32) - np.asarray(want_dec)).mean()
        e0 = np.abs(np.asarray(got_l0, np.float32) - np.asarray(want_dec)).mean()
        assert got_l3.shape == want_dec.shape
        assert e3 < e0, (pallas, e3, e0)


@pytest.mark.parametrize("hifi", [0, 1, 2, 3])
def test_port_hifi2_routes_early_mrf_stages_to_the_f32_storage_kernel(hifi, monkeypatch):
    """The port's ``decoder_apply`` on the 256 / 128 / 64 / 32-channel
    stages of iitp_base: at hifi >= 2 stages 1-2 run their MRF on
    ``mrf_stage_unpacked(f32_storage=True)`` (the unpacked kernel's
    F32_STORAGE mode on the card) and no ``mixed_f32`` plain stage is left;
    hifi 0 and 1, and ``pallas_stage2`` at every level, keep their routes.
    The output matches the former ``mixed_f32`` route to 1e-6 (the two compute
    one function: bf16 operands, f32 sums; on the CPU both run the same
    convolutions, so they agree to the bit)."""
    import torch

    from smart_vocoder_torch.kernels import decoder as tdec

    cfg = tdec.DecoderConfig("1", (3, 7, 11), ((1, 3, 5),) * 3, (2, 2, 2, 2), 512, (4, 4, 4, 4))
    rng = np.random.default_rng(hifi)
    ch, p = 512, {"conv_pre.weight": torch.from_numpy(rng.normal(0, 0.1, (512, 8, 7))).float(),
                  "conv_pre.bias": torch.from_numpy(rng.normal(0, 0.1, 512)).float()}
    for i in range(4):
        p[f"ups.{i}.weight"] = torch.from_numpy(rng.normal(0, 0.05, (ch, ch // 2, 4))).float()
        p[f"ups.{i}.bias"] = torch.from_numpy(rng.normal(0, 0.1, ch // 2)).float()
        ch //= 2
        for j, kb in enumerate(cfg.resblock_kernel_sizes):
            for kind in ("convs1", "convs2"):
                for n in range(3):
                    pre = f"resblocks.{i * 3 + j}.{kind}.{n}"
                    p[f"{pre}.weight"] = torch.from_numpy(
                        rng.normal(0, 0.02, (ch, ch, kb))).float()
                    p[f"{pre}.bias"] = torch.from_numpy(rng.normal(0, 0.1, ch)).float()
    p["conv_post.weight"] = torch.from_numpy(rng.normal(0, 0.1, (1, ch, 7))).float()
    x = torch.from_numpy(rng.normal(0, 0.5, (2, 5, 8))).float()

    calls = []
    for name in ("mrf_stage_unpacked", "mrf_stage_reference", "mrf_stage", "up_mrf_stage"):
        real = getattr(tdec, name)
        monkeypatch.setattr(tdec, name, lambda *a, _n=name, _r=real, **kw: (
            calls.append((_n, a[0].shape[-1] if _n == "up_mrf_stage" else a[0].shape[2],
                          kw.get("f32_storage", False) or kw.get("mixed_f32", False)))
            or _r(*a, **kw)))

    def decode(stage2=False):
        calls.clear()
        packed = tdec.pack_decoder(p, cfg, torch.bfloat16, hifi, stage2)
        return tdec.decoder_apply(p, x, cfg, dtype=torch.bfloat16, hifi_tail=hifi,
                                  pallas_stage2=stage2, packed=packed), list(calls)

    got, route = decode()
    tail = [("mrf_stage", 64, hifi >= 1), ("up_mrf_stage", 64, False)]
    if hifi >= 2:
        assert route == [("mrf_stage_unpacked", 256, True), ("mrf_stage_unpacked", 128, True),
                         *tail]
        monkeypatch.setattr(tdec, "_f32s_route", lambda *a: False)
        former, former_route = decode()
        assert former_route == [("mrf_stage_reference", 256, True),
                                ("mrf_stage_reference", 128, True), *tail]
        assert got.dtype == former.dtype and got.shape == (2, 5 * 16, 1)
        torch.testing.assert_close(got, former, rtol=0, atol=1e-6)
    else:
        assert route == [("mrf_stage_reference", 256, False),
                         ("mrf_stage_reference", 128, False), *tail]
    # pallas_stage2: lengths off 512 keep the plain stage (mixed_f32 at hifi >= 2)
    _, route = decode(stage2=True)
    assert route[:2] == [("mrf_stage_reference", 256, hifi >= 2),
                         ("mrf_stage_reference", 128, hifi >= 2)]
