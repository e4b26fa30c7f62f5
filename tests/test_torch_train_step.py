"""The port's GAN train step against the JAX package's, in f32 on the CPU.

The config is tests/test_train_step.py:21-64's tiny one (64 decoder
channels, 2-layer encoders and flow, the discriminators at 1/8 width,
segment 2048 samples), speaker-conditioned, B = 2 x 32 frames. Both sides
start from the weights of JAX's ``init_train_state`` (jitted; the zero
coupling ``post`` included), bridged into the port. JAX's draws are
reproduced here from each step's key, split as the JAX step and module
split it (step.py:137, synthesizer.py:292): ``eps_q = normal(rng_post, (B,
T, inter))``, ``u = uniform(rng_slice, (B,))`` -> the slice starts, and
``perm = permutation(rng_nda, 4)``; the port gets them passed in.

- Every metric of step 1 is within rel 1e-4 of JAX's, of steps 2-3 within
  rel 1e-3 (the images within 1e-4 / 1e-3 of their largest entry).
- After step 1, >= 99.9 % of parameter elements are within 1e-6 of JAX's and
  all within 2 lr + 1e-6: the first AdamW step moves each element by about
  +-lr, so a gradient within f32 noise of 0 may take the other sign.

The port alone: D's parameters after the step are those of its own update
(the G phase changes none and leaves no gradient); the clamp changes the
update but not the logged norm (as tests/test_train_step.py:189 holds JAX);
every parameter moves in two steps; the mel loss falls over 10 steps on one
batch; the step's default device is the card; and ``tools.bench_train`` runs
at this size on the CPU; the port's copy of the FLOP model counts what the
JAX package's does.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smart_vocoder_torch.config import HParams as TorchHParams
from smart_vocoder_torch.config import validate as torch_validate
from smart_vocoder_torch.models import build_discriminator
from smart_vocoder_torch.models import build_synthesizer as torch_build
from smart_vocoder_torch.training import Batch, init_train_state, make_train_step
from smart_vocoder_torch.utils.torch_compat import (
    discriminator_state_dict_from_jax,
    state_dict_from_jax_params,
)
from smart_vocoder_tpu.config import HParams as JaxHParams
from smart_vocoder_tpu.config import validate as jax_validate
from smart_vocoder_tpu.models import MultiPeriodDiscriminator as JaxMPD
from smart_vocoder_tpu.models import build_synthesizer as jax_build
from smart_vocoder_tpu.ops import stft_magnitude
from smart_vocoder_tpu.training import Batch as JaxBatch
from smart_vocoder_tpu.training import make_optimizer as jax_make_optimizer
from smart_vocoder_tpu.training import make_train_step as jax_make_train_step
from smart_vocoder_tpu.training.step import TrainState as JaxTrainState
from smart_vocoder_tpu.training.step import init_train_state as jax_init_train_state
from test_torch_package import random_params
from test_torch_streaming import one_thread  # noqa: F401 (fixture)

# tests/test_train_step.py:21-64, with its model's depths and D width in the config
TRAIN_CFG = {
    "train": dict(log_interval=10, eval_interval=100, seed=1234, epochs=3,
                  learning_rate=2e-4, betas=[0.8, 0.99], eps=1e-9, batch_size=2,
                  fp16_run=False, lr_decay=0.999875, segment_size=2048, c_mel=45, c_kl=1.0),
    "data": dict(training_files="", validation_files="", max_wav_value=32768.0,
                 sampling_rate=22050, filter_length=1024, hop_length=256, win_length=1024,
                 n_mel_channels=80, mel_fmin=0.0, mel_fmax=None, add_blank=True, n_speakers=4),
    "model": dict(inter_channels=32, hidden_channels=32, resblock="1",
                  resblock_kernel_sizes=[3, 7], resblock_dilation_sizes=[[1, 3], [1, 3]],
                  upsample_rates=[8, 8, 2, 2], upsample_initial_channel=64,
                  upsample_kernel_sizes=[16, 16, 4, 4], gin_channels=16,
                  use_spectral_norm=False, use_spk_embed=True, enc_layers=2,
                  flow_wn_layers=2, disc_width_mult=0.125),
}
FRAMES, ROWS = 32, 2


def train_hparams(spectral_norm=False, bf16=False, **train):
    """The config as both packages' HParams."""
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["model"]["use_spectral_norm"] = spectral_norm
    cfg["train"].update(fp16_run=bf16, **train)
    return jax_validate(JaxHParams(**cfg)), torch_validate(TorchHParams(**copy.deepcopy(cfg)))


def jax_modules(jhps, dtype=jnp.float32):
    return (jax_build(jhps, dtype=dtype, training=True),
            JaxMPD(jhps.model.use_spectral_norm, width_mult=jhps.model.disc_width_mult,
                   dtype=dtype))


def batches(jhps, seed=0):
    """One synthetic batch (tests/test_train_step.py:67-87) for both sides."""
    rng = np.random.default_rng(seed)
    hop = jhps.data.hop_length
    wav = rng.uniform(-0.5, 0.5, (ROWS, FRAMES * hop, 1)).astype(np.float32)
    spec = np.asarray(stft_magnitude(jnp.asarray(wav[..., 0]), jhps.data.filter_length, hop,
                                     jhps.data.win_length))
    lengths = np.full((ROWS,), FRAMES, np.int32)
    sid = np.arange(ROWS, dtype=np.int32) % jhps.data.n_speakers
    jb = JaxBatch(spec=jnp.asarray(spec), spec_lengths=jnp.asarray(lengths),
                  wav=jnp.asarray(wav), wav_lengths=jnp.asarray(lengths * hop),
                  sid=jnp.asarray(sid))
    tb = Batch(torch.from_numpy(spec.copy()), torch.from_numpy(lengths),
               torch.from_numpy(wav), torch.from_numpy(lengths * hop),
               torch.from_numpy(sid).long())
    return jb, tb


def jax_state(jhps, jb, seed=0, jax_init=True):
    """JAX's own ``init_train_state`` (jitted: op by op it takes longer), or,
    with ``jax_init=False``, its tree of shapes filled with seeded values
    (``test_torch_package.random_params``: no compile, ~25 s less)."""
    g, d = jax_modules(jhps)
    tx_g, tx_d = jax_make_optimizer(jhps), jax_make_optimizer(jhps)
    init = lambda k, b: jax_init_train_state(jhps, g, d, tx_g, tx_d, k, b)  # noqa: E731
    if jax_init:
        return jax.jit(init)(jax.random.key(seed), jb)
    shapes = jax.eval_shape(init, jax.random.key(seed), jb)
    params_g, params_d, spectral_d = (
        jax.tree.map(jnp.asarray, random_params(tree, seed + i)) if tree else {}
        for i, tree in enumerate((shapes.params_g, shapes.params_d, shapes.spectral_d)))
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params_g=params_g, params_d=params_d,
                         opt_g=tx_g.init(params_g), opt_d=tx_d.init(params_d),
                         spectral_d=spectral_d)


def jax_step(jhps, dtype=jnp.float32):
    g, d = jax_modules(jhps, dtype)
    return jax.jit(jax_make_train_step(jhps, g, d, jax_make_optimizer(jhps),
                                       jax_make_optimizer(jhps)))


def jax_draws(jhps, key):
    """The posterior noise, slice starts and jigsaw permutation the JAX step
    draws from ``key``, as torch tensors for the port's step."""
    seg = jhps.train.segment_size // jhps.data.hop_length
    rng_g, rng_nda = jax.random.split(key)
    rng_post, rng_slice = jax.random.split(rng_g)
    eps_q = jax.random.normal(rng_post, (ROWS, FRAMES, jhps.model.inter_channels), jnp.float32)
    u = jax.random.uniform(rng_slice, (ROWS,), dtype=jnp.float32)
    ids = (u * jnp.float32(FRAMES - seg + 1)).astype(jnp.int32)
    perm = jax.random.permutation(rng_nda, 4)
    return {k: torch.from_numpy(np.array(v)) for k, v in
            (("eps_q", eps_q), ("ids_slice", ids), ("perm", perm))}


def port_state(thps, jstate):
    """The port's state on the JAX state's weights (and ``weight_u``)."""
    net_g = torch_build(thps)
    net_g.load_state_dict(state_dict_from_jax_params(jax.tree.map(np.asarray, jstate.params_g)),
                          strict=True)
    net_d = build_discriminator(thps)
    net_d.load_state_dict(discriminator_state_dict_from_jax(
        jax.tree.map(np.asarray, jstate.params_d), jax.tree.map(np.asarray, jstate.spectral_d)),
        strict=True)
    return init_train_state(thps, device="cpu", net_g=net_g, net_d=net_d)


def run_both(jhps, thps, keys, jax_init=True):
    """len(keys) steps of each side from the same weights: JAX's metrics and
    states, the port's metrics and its state after each step (copied)."""
    jb, tb = batches(jhps)
    js = jax_state(jhps, jb, jax_init=jax_init)
    ts = port_state(thps, js)
    step_j, step_t = jax_step(jhps), make_train_step(thps, device="cpu")
    out = {"jax": [], "jax_states": [js], "port": [], "port_states": []}
    for k in keys:
        key = jax.random.key(k)
        js, jm = step_j(js, jb, key)
        ts, tm = step_t(ts, tb, **jax_draws(jhps, key))
        out["jax"].append({n: np.asarray(v, np.float32) for n, v in jm.items()})
        out["jax_states"].append(js)
        out["port"].append({n: v.float().numpy() for n, v in tm.items()})
        out["port_states"].append((copy.deepcopy(ts.net_g.state_dict()),
                                   copy.deepcopy(ts.net_d.state_dict())))
    return out


def assert_metrics_close(got, want, rel, step):
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        if w.ndim == 0:
            assert abs(float(g) - float(w)) <= rel * abs(float(w)), (step, name, g, w)
        else:  # the image/* mels
            np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(),
                                       err_msg=f"step {step} {name}")


def param_deltas(port_sd, jax_tree, spectral=None):
    """|port - JAX| per element, over every parameter of one net."""
    want = (discriminator_state_dict_from_jax(jax.tree.map(np.asarray, jax_tree), spectral)
            if spectral is not None else state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                                                 jax_tree)))
    assert set(want) <= set(port_sd)
    return np.concatenate([np.abs(port_sd[k].numpy() - want[k].numpy()).ravel() for k in want])


def assert_params_after_one_step(out, lr):
    js = out["jax_states"][1]
    sd_g, sd_d = out["port_states"][0]
    for sd, tree in ((sd_g, js.params_g), (sd_d, js.params_d)):
        d = param_deltas({k: v for k, v in sd.items() if not k.endswith("weight_u")}, tree)
        assert (d <= 1e-6).mean() >= 0.999, (d <= 1e-6).mean()
        assert d.max() <= 2 * lr + 1e-6, d.max()


@pytest.fixture(scope="module")
def steps():
    jhps, thps = train_hparams()
    return thps, run_both(jhps, thps, keys=(1, 2, 3))


def test_step_one_metrics_match_jax(steps):
    _, out = steps
    assert len(out["port"][0]) == 7 + 3 * 6 + 3
    assert_metrics_close(out["port"][0], out["jax"][0], 1e-4, 1)


def test_steps_two_and_three_match_jax(steps):
    _, out = steps
    for i in (1, 2):
        assert_metrics_close(out["port"][i], out["jax"][i], 1e-3, i + 1)


def test_params_after_step_one_match_jax(steps):
    thps, out = steps
    assert_params_after_one_step(out, thps.train.learning_rate)


# ---- the port alone ---------------------------------------------------------

@pytest.fixture(scope="module")
def port_only():
    """A seeded port state, batch and draws at the tiny config."""
    jhps, thps = train_hparams()
    _, tb = batches(jhps)
    state = init_train_state(thps, seed=5, device="cpu")
    gen = torch.Generator().manual_seed(11)
    draws = {"eps_q": torch.randn((ROWS, FRAMES, thps.model.inter_channels), generator=gen),
             "ids_slice": torch.tensor([3, 17], dtype=torch.int32),
             "perm": torch.tensor([2, 0, 3, 1])}
    return thps, tb, state, draws


def test_g_phase_leaves_d_alone(port_only):
    """D after the step is D after its own optimizer step: the G phase's
    backward changes none of D's parameters and leaves no gradient on them."""
    thps, tb, state, draws = port_only
    state = copy.deepcopy(state)
    after_d = {}
    d_step = state.opt_d.step

    def record(*args, **kwargs):
        out = d_step(*args, **kwargs)
        after_d.update({k: v.detach().clone() for k, v in state.net_d.state_dict().items()})
        return out

    state.opt_d.step = record
    before = {k: v.clone() for k, v in state.net_d.state_dict().items()}
    make_train_step(thps, device="cpu")(state, tb, **draws)
    for k, v in state.net_d.state_dict().items():
        assert torch.equal(v, after_d[k]), k
        assert not torch.equal(v, before[k]), k
    assert all(p.grad is None and p.requires_grad for p in state.net_d.parameters())
    assert all(p.grad is None for p in state.net_g.parameters())


def test_clip_changes_update_but_not_logged_norm(port_only):
    thps, tb, state, draws = port_only
    _, thps_clip = train_hparams(clip_grad_value=1e-5)  # far below |g| at init
    sa, ma = make_train_step(thps, device="cpu")(copy.deepcopy(state), tb, **draws)
    sb, mb = make_train_step(thps_clip, device="cpu")(copy.deepcopy(state), tb, **draws)
    for name in ("grad_norm_g", "grad_norm_d"):
        np.testing.assert_allclose(mb[name].item(), ma[name].item(), rtol=1e-6)
    assert any(not torch.equal(a, b) for a, b in zip(sa.net_g.parameters(),
                                                     sb.net_g.parameters()))
    assert any(not torch.equal(a, b) for a, b in zip(sa.net_d.parameters(),
                                                     sb.net_d.parameters()))


def test_every_parameter_moves_and_mel_loss_falls(port_only):
    """10 steps on one batch with the same draws (as tests/test_train_step.py
    :128 fixes its rng): every parameter has moved after two, and the mel
    loss falls."""
    thps, tb, state, draws = port_only
    state = copy.deepcopy(state)
    before = [p.detach().clone() for p in (*state.net_g.parameters(),
                                           *state.net_d.parameters())]
    step = make_train_step(thps, device="cpu")
    mels = []
    for i in range(10):
        state, m = step(state, tb, **draws)
        mels.append(m["loss/g/mel"].item())
        if i == 1:
            after = list(state.net_g.parameters()) + list(state.net_d.parameters())
            moved = sum(not torch.equal(a, b) for a, b in zip(before, after))
            assert moved == len(before), f"{moved}/{len(before)}"
        for v in m.values():
            assert torch.isfinite(v).all()
    assert state.step == 10
    assert mels[-1] < mels[0], mels


def test_generator_draws_and_default_device(port_only):
    """With a generator the step draws its own randomness, reproducibly; with
    no device named the step runs on the card, and raises where there is
    none."""
    thps, tb, state, _ = port_only
    step = make_train_step(thps, device="cpu")
    runs = [step(copy.deepcopy(state), tb, torch.Generator().manual_seed(9))[1]
            for _ in range(2)]
    for k in runs[0]:
        assert torch.equal(runs[0][k], runs[1][k]), k
    if torch.cuda.is_available():
        make_train_step(thps)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_train_step(thps)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            init_train_state(thps)


def test_bench_train_runs_on_cpu():
    from smart_vocoder_torch.tools import bench_train

    _, thps = train_hparams()
    res = bench_train.main(device="cpu", hps=thps, frames=FRAMES, rounds=2, iters=1,
                           legs=("bf16", "f32"))
    assert set(res["legs"]) == {"bf16", "f32"}
    assert res["device"].startswith("cpu") and res["model_tflop_per_step"] > 0
    for leg in res["legs"].values():
        assert leg["step_ms"] > 0 and leg["steps_per_s"] > 0 and leg["audio_x_realtime"] > 0
        assert leg["busy_share"] is None and leg["peak_mem_gib"] is None
        assert np.isfinite(leg["loss_first"]["loss/g/total"])
        assert np.isfinite(leg["loss_last"]["loss/g/total"])


def test_bench_train_state_bytes_count_adamw_moments():
    """The peak memory's resident part: parameters and buffers before a step,
    plus both AdamW moments of every parameter after it."""
    from smart_vocoder_torch.tools.bench_train import state_bytes, synthetic_batch

    _, thps = train_hparams()
    state = init_train_state(thps, seed=3, device="cpu")
    nets = (state.net_g, state.net_d)
    params = sum(p.numel() * p.element_size() for n in nets for p in n.parameters())
    buffers = sum(b.numel() * b.element_size() for n in nets for b in n.buffers())
    assert state_bytes(state) == params + buffers
    batch = synthetic_batch(thps, thps.train.batch_size, FRAMES, torch.device("cpu"))
    state, _ = make_train_step(thps, device="cpu")(state, batch, torch.Generator().manual_seed(0))
    assert params + buffers + 2 * params <= state_bytes(state) <= params + buffers + 2 * params + 4096


def test_flop_model_copy_matches_jax():
    from smart_vocoder_torch.config import load_config as torch_load
    from smart_vocoder_torch.utils.flops import train_step_flops
    from smart_vocoder_tpu.config import load_config as jax_load
    from smart_vocoder_tpu.utils.flops import train_step_flops as jax_train_step_flops

    path = __file__.rsplit("/tests/", 1)[0] + "/configs/iitp_base.json"
    assert train_step_flops(torch_load(path), 16, 1000) == jax_train_step_flops(
        jax_load(path), 16, 1000)
    assert round(train_step_flops(torch_load(path), 16, 1000) / 1e12, 2) == 5.58


def test_synthesis_flop_count_matches_jax():
    from smart_vocoder_torch.config import load_config as torch_load
    from smart_vocoder_torch.utils.flops import synthesis_flops
    from smart_vocoder_tpu.config import load_config as jax_load
    from smart_vocoder_tpu.utils.flops import synthesis_flops as jax_synthesis_flops

    path = __file__.rsplit("/tests/", 1)[0] + "/configs/iitp_base.json"
    assert synthesis_flops(torch_load(path), 32, 1000) == jax_synthesis_flops(
        jax_load(path), 32, 1000)
    assert round(synthesis_flops(torch_load(path), 1, 1000) / 1e9, 1) == 657.5  # a 1000-frame row
