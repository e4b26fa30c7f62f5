"""The port's discriminators and spectral-norm conv against the JAX package's.

Weights come from the JAX module's tree of shapes (``jax.eval_shape``) filled
with seeded values (``test_torch_package.random_params``) and cross through
``discriminator_state_dict_from_jax``. Inputs are seeded numpy waveforms of
1003 samples, which no period divides, so every period discriminator
reflect-pads. Logits and every feature map agree in f32 within rtol 1e-4 /
atol 1e-5 (the JAX feature maps are NHWC / NTC, the port's NCHW / NCT); the
D loss's gradients within rtol 1e-4 / atol 1e-5 of each gradient's largest
entry.

The spectral-norm conv is held, as tests/test_spectral_norm.py:14-47 holds
the JAX one, against ``torch.nn.utils.spectral_norm`` over 5 training
forwards (outputs and ``u``), and against the JAX conv's mutable apply; in
eval mode it leaves ``u`` alone and computes what JAX's read-only apply
computes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch import losses as torch_losses
from smart_vocoder_torch.models import (
    DiscriminatorP,
    DiscriminatorS,
    MultiPeriodDiscriminator,
    build_discriminator,
)
from smart_vocoder_torch.nn import Conv1d
from smart_vocoder_torch.utils.init import init_discriminator
from smart_vocoder_torch.utils.torch_compat import discriminator_state_dict_from_jax
from smart_vocoder_tpu import losses as jax_losses
from smart_vocoder_tpu.models import discriminator as jax_disc
from smart_vocoder_tpu.nn import NormConv1d
from test_torch_package import random_params, tiny_hparams
from test_torch_streaming import one_thread  # noqa: F401 (fixture)

T = 1003  # 1003 % p != 0 for p in (2, 3, 5, 7, 11): every period reflect-pads
WIDTH = 0.125
RTOL, ATOL = 1e-4, 1e-5


def _wav(seed, b=2, t=T):
    return np.random.default_rng(seed).uniform(-0.6, 0.6, (b, t, 1)).astype(np.float32)


def _jax_variables(module, *inputs, seed=0):
    """Seeded values in the tree of the JAX module's variables."""
    shapes = jax.eval_shape(lambda k: module.init(k, *inputs), jax.random.key(0))
    return {name: random_params(tree, seed + i) for i, (name, tree) in
            enumerate(sorted(shapes.items()))}


def _port(net, variables):
    sd = discriminator_state_dict_from_jax(variables["params"], variables.get("spectral"))
    missing, unexpected = net.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    return net


def _t(a):
    return torch.from_numpy(np.array(a))


def _fmap_to_jax(f):
    """The port's channel-first map in the JAX package's channel-last layout."""
    return f.permute(0, *range(2, f.ndim), 1).detach().numpy()


def _apply(module, variables, *inputs, mutable=False):
    with jax.default_matmul_precision("highest"):
        if mutable:
            return module.apply(variables, *inputs, mutable=["spectral"])
        return module.apply(variables, *inputs)


def _check_outputs(got_logits, got_fmaps, want_logits, want_fmaps):
    np.testing.assert_allclose(got_logits.detach().numpy(), np.asarray(want_logits),
                               rtol=RTOL, atol=ATOL)
    assert len(got_fmaps) == len(want_fmaps)
    for g, w in zip(got_fmaps, want_fmaps):
        assert _fmap_to_jax(g).shape == w.shape
        np.testing.assert_allclose(_fmap_to_jax(g), np.asarray(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("period", [2, 3, 5, 7, 11])
def test_discriminator_p_matches_jax(period):
    y = _wav(period)
    jmod = jax_disc.DiscriminatorP(period, width_mult=WIDTH)
    variables = _jax_variables(jmod, jnp.asarray(y), seed=period)
    want_logits, want_fmaps = _apply(jmod, variables, jnp.asarray(y))
    net = _port(DiscriminatorP(period, width_mult=WIDTH), variables)
    with torch.no_grad():
        logits, fmaps = net(_t(y).transpose(1, 2))
    _check_outputs(logits, fmaps, want_logits, want_fmaps)


def test_discriminator_s_matches_jax():
    y = _wav(20)
    jmod = jax_disc.DiscriminatorS(width_mult=WIDTH)
    variables = _jax_variables(jmod, jnp.asarray(y), seed=20)
    want_logits, want_fmaps = _apply(jmod, variables, jnp.asarray(y))
    net = _port(DiscriminatorS(width_mult=WIDTH), variables)
    assert [c.groups for c in net.convs] == [1, 4, 8, 32, 128, 1]  # gcd-reduced at 1/8 width
    with torch.no_grad():
        logits, fmaps = net(_t(y).transpose(1, 2))
    _check_outputs(logits, fmaps, want_logits, want_fmaps)


@pytest.fixture(scope="module")
def mpd():
    y, y_hat = _wav(30), _wav(31)
    jmod = jax_disc.MultiPeriodDiscriminator(width_mult=WIDTH)
    variables = _jax_variables(jmod, jnp.asarray(y), jnp.asarray(y_hat), seed=30)
    net = _port(MultiPeriodDiscriminator(width_mult=WIDTH), variables)
    return jmod, variables, net, y, y_hat


def test_multi_period_discriminator_matches_jax(mpd):
    jmod, variables, net, y, y_hat = mpd
    want = _apply(jmod, variables, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = net(_t(y).transpose(1, 2), _t(y_hat).transpose(1, 2))
    assert len(got[0]) == 6
    for i in range(6):
        _check_outputs(got[0][i], got[2][i], want[0][i], want[2][i])  # real
        _check_outputs(got[1][i], got[3][i], want[1][i], want[3][i])  # generated


def test_discriminator_grads_match_jax(mpd):
    jmod, variables, net, y, y_hat = mpd

    def loss_fn(params):
        y_d_r, y_d_g, _, _ = jmod.apply({"params": params}, jnp.asarray(y), jnp.asarray(y_hat))
        return jax_losses.discriminator_loss(y_d_r, y_d_g)[0]

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.value_and_grad(loss_fn)(
            jax.tree.map(jnp.asarray, variables["params"]))
    want = discriminator_state_dict_from_jax(jax.tree.map(np.asarray, want_grads))
    net.zero_grad(set_to_none=True)
    y_d_r, y_d_g, _, _ = net(_t(y).transpose(1, 2), _t(y_hat).transpose(1, 2))
    loss = torch_losses.discriminator_loss(y_d_r, y_d_g)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = {k: p.grad for k, p in net.named_parameters()}
    assert set(grads) == set(want)
    for k, g in grads.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL * np.abs(w).max(),
                                   err_msg=k)


def test_bridge_and_reference_names():
    """Strict loads both ways of norm; the keys are the reference D_*.pth's."""
    y = jnp.zeros((1, 256, 1))
    for sn in (False, True):
        jmod = jax_disc.MultiPeriodDiscriminator(use_spectral_norm=sn, width_mult=WIDTH)
        variables = _jax_variables(jmod, y, y, seed=40)
        net = _port(MultiPeriodDiscriminator(use_spectral_norm=sn, width_mult=WIDTH), variables)
        keys = set(net.state_dict())
        if sn:
            assert {"discriminators.1.convs.0.weight_orig",
                    "discriminators.1.convs.0.weight_u",
                    "discriminators.0.conv_post.weight_u"} <= keys
            assert not any(k.endswith("weight_v") for k in keys)
        else:
            assert {"discriminators.1.convs.0.weight_v", "discriminators.1.convs.0.weight_g",
                    "discriminators.0.convs.5.bias", "discriminators.5.conv_post.weight_g"} <= keys


def test_build_and_init_discriminator():
    """``build_discriminator`` reads use_spectral_norm and disc_width_mult; the
    seeded init is reproducible, with g = ||v|| as torch's wrapper starts."""
    _, hps = tiny_hparams()
    hps.model["disc_width_mult"] = WIDTH
    nets = [init_discriminator(build_discriminator(hps), 7) for _ in range(2)]
    assert len(nets[0].discriminators) == 6 and not nets[0].use_spectral_norm
    assert nets[0].discriminators[1].convs[0].weight_v.shape == (4, 1, 5, 1)
    for (k, a), (_, b) in zip(nets[0].state_dict().items(), nets[1].state_dict().items()):
        assert torch.equal(a, b), k
    conv = nets[0].discriminators[0].convs[1]
    norm = conv.weight_v.pow(2).sum(dim=(1, 2), keepdim=True).sqrt()
    torch.testing.assert_close(conv.weight_g, norm)
    hps.model["use_spectral_norm"] = True
    sn = init_discriminator(build_discriminator(hps), 7)
    assert sn.use_spectral_norm and sn.discriminators[2].convs[3].weight_u.shape == (128,)


def _sn_pair(seed):
    """A torch spectral-norm conv and the port's, on the same weights and u."""
    torch.manual_seed(seed)
    ref = torch.nn.utils.spectral_norm(torch.nn.Conv1d(8, 16, 5, padding=2))
    ours = Conv1d(8, 16, 5, padding=2, spectral_norm=True)
    with torch.no_grad():
        ours.weight_orig.copy_(ref.weight_orig)
        ours.bias.copy_(ref.bias)
        ours.weight_u.copy_(ref.weight_u)
    return ref, ours


def test_spectral_norm_trajectory_matches_torch_and_jax():
    """5 training forwards: outputs and u track torch's hook step by step (the
    estimate is far from converged, so a missed or extra iteration shows),
    and JAX's conv applied with mutable=['spectral']."""
    ref, ours = _sn_pair(0)
    x = torch.randn(2, 8, 32)
    jmod = NormConv1d(16, 5, padding=2, weight_norm=False, spectral_norm=True)
    params = {"weight_orig": jnp.asarray(ours.weight_orig.detach().numpy().copy()),
              "bias": jnp.asarray(ours.bias.detach().numpy().copy())}
    spectral = {"weight_u": jnp.asarray(ours.weight_u.numpy().copy())}
    xj = jnp.asarray(x.numpy().transpose(0, 2, 1))
    ref.train()
    ours.train()
    for step in range(5):
        want = ref(x).detach().numpy()
        got = ours(x).detach().numpy()
        jgot, mutated = _apply(jmod, {"params": params, "spectral": spectral}, xj, mutable=True)
        spectral = mutated["spectral"]
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(ours.weight_u.numpy(), ref.weight_u.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {step} u")
        np.testing.assert_allclose(got, np.asarray(jgot).transpose(0, 2, 1), rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {step} vs JAX")
        np.testing.assert_allclose(ours.weight_u.numpy(), np.asarray(spectral["weight_u"]),
                                   rtol=1e-5, atol=1e-6, err_msg=f"step {step} u vs JAX")


def test_spectral_norm_eval_leaves_u_alone():
    _, ours = _sn_pair(1)
    x = torch.randn(2, 8, 32)
    u0 = ours.weight_u.clone()
    jmod = NormConv1d(16, 5, padding=2, weight_norm=False, spectral_norm=True)
    variables = {"params": {"weight_orig": jnp.asarray(ours.weight_orig.detach().numpy()),
                            "bias": jnp.asarray(ours.bias.detach().numpy())},
                 "spectral": {"weight_u": jnp.asarray(u0.numpy())}}
    want = np.asarray(_apply(jmod, variables, jnp.asarray(x.numpy().transpose(0, 2, 1))))
    ours.eval()
    for _ in range(3):
        with torch.no_grad():
            got = ours(x).numpy()
        assert torch.equal(ours.weight_u, u0)
        np.testing.assert_allclose(got, want.transpose(0, 2, 1), rtol=1e-5, atol=1e-5)


def test_spectral_norm_mpd_matches_jax():
    """Under spectral norm the ensemble runs real and generated apart: each
    forward advances u, twice per call, as JAX's mutable apply does."""
    y, y_hat = _wav(50), _wav(51)
    jmod = jax_disc.MultiPeriodDiscriminator(use_spectral_norm=True, width_mult=WIDTH)
    variables = _jax_variables(jmod, jnp.asarray(y), jnp.asarray(y_hat), seed=50)
    net = _port(MultiPeriodDiscriminator(use_spectral_norm=True, width_mult=WIDTH), variables)
    for call in range(2):
        want, mutated = _apply(jmod, variables, jnp.asarray(y), jnp.asarray(y_hat),
                               mutable=True)
        variables = {"params": variables["params"], "spectral": mutated["spectral"]}
        with torch.no_grad():
            got = net(_t(y).transpose(1, 2), _t(y_hat).transpose(1, 2))
        for i in range(6):
            _check_outputs(got[0][i], got[2][i], want[0][i], want[2][i])
            _check_outputs(got[1][i], got[3][i], want[1][i], want[3][i])
        u_want = discriminator_state_dict_from_jax({}, jax.tree.map(np.asarray,
                                                                    mutated["spectral"]))
        for k, u in u_want.items():
            np.testing.assert_allclose(net.state_dict()[k].numpy(), u.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=f"call {call} {k}")
