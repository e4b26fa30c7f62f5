"""The port's functional prior and flow against the JAX package's.

``smart_vocoder_torch.kernels.encoder`` (``enc_p_apply``,
``flow_reverse_apply``, ``prior_flow_apply``) with every WN stack on
``wn_stack`` (its plain version on a CPU tensor) is held against the JAX
functions with ``use_pallas=True, interpret=True`` at the WN kernel's width
(hidden 192), and ``Vocoder(use_wn_kernels=True)`` against JAX
``Vocoder(use_pallas_wn=True)`` on the small config of
tests/test_fast_encoder.py with the prior noise passed in.

Tolerances:
- f32: 4e-4, the bound of tests/test_fast_encoder.py (the Pallas WN path
  against the module graph); the Vocoder at 5e-4, the bound of its
  ``test_vocoder_pallas_wn_path_matches_module``.
- bf16: both sides round at the same points, and a summation-order flip of
  one rounding spreads along the WN and flow chains; the port's mean
  deviation from JAX must stay under half of JAX's own bf16-versus-f32
  deviation on the same inputs.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import smart_vocoder_torch.inference as tinf
from smart_vocoder_torch.inference import Vocoder as TorchVocoder
from smart_vocoder_torch.kernels import encoder as tenc
from smart_vocoder_torch.utils.torch_compat import state_dict_from_jax_params
from smart_vocoder_tpu.inference import Vocoder as JaxVocoder
from smart_vocoder_tpu.kernels import encoder as jenc
from smart_vocoder_tpu.models.synthesizer import MelEncoder, ResidualCouplingBlock
from test_torch_package import TINY_CFG, jax_synth_params, random_params, tiny_hparams

HIDDEN, INTER, T, LENGTHS, N_LAYERS = 192, 16, 32, (32, 21), 3


@pytest.fixture(autouse=True)
def _highest_precision():
    with jax.default_matmul_precision("highest"):
        yield


@pytest.fixture(scope="module")
def setup():
    """Folded enc_p and flow params (numpy) at hidden 192, 3 WN layers, and
    their state dict; mel, mask and prior noise."""
    rng = np.random.default_rng(0)
    mel = rng.normal(-4, 2, (2, T, 80)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array(LENGTHS)[:, None]).astype(np.float32)[..., None]
    eps = rng.normal(0, 1, (2, T, INTER)).astype(np.float32)
    enc = MelEncoder(INTER, HIDDEN, n_layers=N_LAYERS, weight_norm=False)
    flow = ResidualCouplingBlock(INTER, HIDDEN, 5, 1, n_layers=N_LAYERS, weight_norm=False)
    enc_shapes = jax.eval_shape(lambda k: enc.init(k, jnp.asarray(mel),
                                                   jnp.asarray(LENGTHS))["params"],
                                jax.random.key(0))
    flow_shapes = jax.eval_shape(lambda k: flow.init(k, jnp.asarray(eps),
                                                     jnp.asarray(mask))["params"],
                                 jax.random.key(1))
    params = {"enc_p": random_params(enc_shapes, 1), "flow": random_params(flow_shapes, 2)}
    return params, state_dict_from_jax_params(params), mel, mask, eps


def _jtree(params):
    return jax.tree.map(jnp.asarray, params)


def _f(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _run(setup, which, dtype):
    """(port, JAX) outputs of one functional stage; bf16 inputs are bf16 values."""
    params, state, mel, mask, eps = setup
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jp, jm = _jtree(params), jnp.asarray(mask)
    tm = torch.from_numpy(mask)
    if which == "enc_p":
        want = jenc.enc_p_apply(jp["enc_p"], jnp.asarray(mel), jm, N_LAYERS, HIDDEN,
                                use_pallas=True, interpret=True, dtype=jdt)
        got = tenc.enc_p_apply(state, torch.from_numpy(mel), tm, N_LAYERS, HIDDEN, dtype=tdt)
        return [_f(g) for g in got], [_f(w) for w in want]
    if which == "flow":
        z = _bf16(eps * 0.5) * mask
        want = jenc.flow_reverse_apply(jp["flow"], jnp.asarray(z, jdt), jm, 4, N_LAYERS,
                                       HIDDEN, use_pallas=True, interpret=True, dtype=jdt)
        got = tenc.flow_reverse_apply(state, torch.from_numpy(z).to(tdt), tm, 4, N_LAYERS,
                                      HIDDEN, dtype=tdt)
        return [_f(got)], [_f(want)]
    want = jenc.prior_flow_apply(jp, jnp.asarray(mel), jm, jnp.asarray(eps), 0.667,
                                 N_LAYERS, 4, N_LAYERS, HIDDEN, use_pallas=True, interpret=True,
                                 dtype=jdt)
    got = tenc.prior_flow_apply(state, torch.from_numpy(mel), tm, torch.from_numpy(eps), 0.667,
                                N_LAYERS, 4, N_LAYERS, HIDDEN, dtype=tdt)
    assert got.dtype == tdt
    return [_f(got)], [_f(want)]


@pytest.mark.parametrize("which", ["enc_p", "flow", "prior_flow"])
def test_functional_prior_f32_matches_jax(setup, which):
    got, want = _run(setup, which, "f32")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=4e-4, atol=4e-4)


@pytest.mark.parametrize("which", ["enc_p", "flow", "prior_flow"])
def test_functional_prior_bf16_matches_jax(setup, which):
    got, want = _run(setup, which, "bf16")
    _, exact = _run(setup, which, "f32")
    for g, w, e in zip(got, want, exact):
        jax_err = np.abs(w - e).mean()
        port_err = np.abs(g - w).mean()
        assert port_err < 0.5 * jax_err, (port_err, jax_err)


def test_non_kernel_route_matches_kernel_route_f32(setup):
    """``use_kernel=False`` (the cuDNN WN stack) computes the same f32 prior."""
    params, state, mel, mask, eps = setup
    args = (state, torch.from_numpy(mel), torch.from_numpy(mask), torch.from_numpy(eps), 0.667,
            N_LAYERS, 4, N_LAYERS, HIDDEN)
    a = tenc.prior_flow_apply(*args, use_kernel=True, dtype=torch.float32)
    b = tenc.prior_flow_apply(*args, use_kernel=False, dtype=torch.float32)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=4e-4, atol=4e-4)


# ------------------------------------------------------------------ Vocoder
WN_CFG = copy.deepcopy(TINY_CFG)
WN_CFG["data"]["hop_length"] = 256
WN_CFG["model"].update(  # tests/test_fast_encoder.py:99-106
    inter_channels=192, hidden_channels=192, resblock_kernel_sizes=[3],
    resblock_dilation_sizes=[[1, 3, 5]], upsample_rates=[8, 8, 2, 2],
    upsample_initial_channel=32, upsample_kernel_sizes=[16, 16, 4, 4])
WN_CFG.pop("tpu")


def test_vocoder_wn_kernel_path_matches_jax():
    jhps, thps = tiny_hparams(WN_CFG)
    params = jax_synth_params(jhps, seed=4, t=64)
    rng = np.random.default_rng(2)
    mel = rng.normal(-4, 2, size=(1, 48, 80)).astype(np.float32)
    eps = rng.normal(size=(1, 48, 192)).astype(np.float32)
    jv = JaxVocoder(jhps, _jtree(params), dtype=jnp.float32, buckets=(64,), use_pallas_wn=True)
    tv = TorchVocoder(thps, state_dict_from_jax_params(params), dtype=torch.float32,
                      buckets=(64,), use_wn_kernels=True, device="cpu")
    assert jv.use_pallas_wn and tv.use_wn_kernels and not tv.use_kernels
    assert sorted(tv.wn_packed) == ["enc_p.encoder"] + [f"flow.flows.{i}.enc" for i in (0, 2, 4, 6)]
    want = jv.mel_to_wav(mel, np.array([48]), eps=eps)[0]
    got = tv.mel_to_wav(mel, np.array([48]), eps=eps)[0]
    assert got.shape == want.shape == (48 * 256,)
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def _count_prior_calls(monkeypatch):
    calls = []
    real = tinf.prior_flow_apply

    def spy(*a, **kw):
        calls.append(kw["dtype"])
        return real(*a, **kw)

    monkeypatch.setattr(tinf, "prior_flow_apply", spy)
    return calls


def test_wn_kernel_routing_flags():
    """``use_wn_kernels`` needs ``fold`` and hidden % 64 == 0 (the JAX
    rule, inference.py:63-68); it defaults to ``tpu.use_pallas_wn``."""
    _, thps = tiny_hparams(WN_CFG)
    sd = state_dict_from_jax_params(jax_synth_params(tiny_hparams(WN_CFG)[0], t=64))
    assert not TorchVocoder(thps, sd, fold=False, use_wn_kernels=True,
                            device="cpu").use_wn_kernels
    assert not TorchVocoder(thps, sd, device="cpu").use_wn_kernels
    cfg = copy.deepcopy(WN_CFG)
    cfg["tpu"] = {"use_pallas_wn": True}
    assert TorchVocoder(tiny_hparams(cfg)[1], sd, device="cpu").use_wn_kernels
    jhps, thps = tiny_hparams()  # hidden 16
    sd = state_dict_from_jax_params(jax_synth_params(jhps))
    assert not TorchVocoder(thps, sd, use_wn_kernels=True, device="cpu").use_wn_kernels


def test_conditioned_request_takes_the_module_graph(monkeypatch):
    """With a speaker id the WN stacks are conditioned, which the kernel
    does not serve: the prior runs on the module graph, as in JAX."""
    cfg = copy.deepcopy(TINY_CFG)
    cfg["data"]["n_speakers"] = 3
    cfg["model"].update(gin_channels=8, use_spk_embed=True, hidden_channels=64)
    jhps, thps = tiny_hparams(cfg)
    sd = state_dict_from_jax_params(jax_synth_params(jhps))
    voc = TorchVocoder(thps, sd, dtype=torch.float32, buckets=(32,), use_wn_kernels=True,
                       device="cpu")
    assert voc.use_wn_kernels
    calls = _count_prior_calls(monkeypatch)
    mel = np.random.default_rng(0).normal(-4, 2, (1, 20, 80)).astype(np.float32)
    with_sid = voc.mel_to_wav(mel, sid=np.array([2]))[0]
    assert calls == []
    voc.mel_to_wav(mel)
    assert calls == [torch.float32]
    assert np.isfinite(with_sid).all()


def test_bf16_wn_path_at_hifi_2_runs_the_prior_in_bf16(monkeypatch):
    """At hifi 2 the module-graph prior would be f32; the WN path runs it in
    bf16, as the JAX path does (inference.py:211)."""
    cfg = copy.deepcopy(TINY_CFG)
    cfg["model"]["hidden_channels"] = 64
    jhps, thps = tiny_hparams(cfg)
    sd = state_dict_from_jax_params(jax_synth_params(jhps))
    voc = TorchVocoder(thps, sd, dtype=torch.bfloat16, buckets=(32,), hifi=2,
                       use_wn_kernels=True, device="cpu")
    assert voc.use_kernels and voc.use_wn_kernels and voc.hifi == 2
    calls = _count_prior_calls(monkeypatch)
    mel = np.random.default_rng(1).normal(-4, 2, (2, 24, 80)).astype(np.float32)
    wavs = voc.mel_to_wav(mel, np.array([24, 17]))
    assert calls == [torch.bfloat16]
    assert [w.shape for w in wavs] == [(24 * 16,), (17 * 16,)]
    assert all(np.isfinite(w).all() for w in wavs)
