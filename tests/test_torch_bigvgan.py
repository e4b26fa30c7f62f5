"""BigVGAN-v2 in the port (``model.kind: "bigvgan"``) on the CPU, at tiny widths.

- ``Vocoder.mel_to_wav`` of the kind (the AMP route: bf16 conv operands, f32
  activations and residual stream) against the benchmark's plain reference
  (``vocbench/reference/bigvgan.py``) on seeded weights, at ragged lengths on
  both sides of a bucket edge, within the tiny model's limit, which the
  float8 control exceeds; the f32 module graph, the route's oracle, to
  float32 summation order.
- ``up2`` / SnakeBeta / ``down2`` against a direct float64 evaluation of the
  equations, the replicate edges included.
- The parameter count at the published widths, built on the ``meta`` device.
- Each planted fault (SnakeBeta without ``up2``/``down2``; alpha and beta
  swapped; one AMP branch left out) fails the limit.
- The cell's driver end to end, and the paths the kind does not serve.
"""

import copy
import math

import numpy as np
import pytest
import torch

from smart_vocoder_torch.config import HParams, validate
from smart_vocoder_torch.inference import GeneratorVocoder, Vocoder
from smart_vocoder_torch.kernels import amp
from smart_vocoder_torch.models import build_bigvgan, build_synthesizer
from smart_vocoder_torch.models.bigvgan import Activation1d, snake_beta
from smart_vocoder_torch.serving import StreamServer
from vocbench import compare, flops_bigvgan, run, weights
from vocbench.reference import bigvgan as ref
from vocbench.reference.graph import Numerics

TINY = {
    "seeded_weights": {"log_scale_bound": 0.5, "conv_post_gain": 1.0},
    "data": {"sampling_rate": 22050, "filter_length": 256, "hop_length": 16,
             "win_length": 256, "n_mel_channels": 80, "mel_fmin": 0.0, "mel_fmax": None,
             "max_wav_value": 32768.0},
    "model": {"kind": "bigvgan", "resblock": "1", "upsample_rates": [4, 2, 2],
              "upsample_kernel_sizes": [8, 4, 4], "upsample_initial_channel": 64,
              "resblock_kernel_sizes": [3, 7, 11],
              "resblock_dilation_sizes": [[1, 3, 5], [1, 3, 5], [1, 3, 5]],
              "activation": "snakebeta", "snake_logscale": True,
              "use_tanh_at_final": False, "use_bias_at_final": False},
    "tpu": {"bf16_run": True},
}
# The tiny model's limit on the route's mel_l1: about three times its reading
# at these sizes (0.008), and under the float8 control's (0.117).
LIMIT = 0.025
LENGTHS = np.array([70, 64, 65, 21])  # the 128 bucket, rows on both sides of 64


def tiny_hps():
    return validate(HParams(**copy.deepcopy(TINY)))


def seeded(seed=123):
    sizes = ref.Sizes.from_config(TINY)
    return sizes, weights.make(ref.generator_params(sizes), seed, torch.device("cpu"))


def mels(lengths=LENGTHS, seed=0):
    rng = np.random.default_rng(seed)
    t = int(lengths.max())
    mel = rng.standard_normal((len(lengths), t, 80)).astype(np.float32) * 2 - 4
    mel[np.arange(t)[None] >= lengths[:, None]] = 0
    return mel


def gaps(got, want):
    return compare.waveform_gaps(got, want, TINY["data"])


@pytest.fixture(scope="module")
def reference():
    sizes, state = seeded()
    mel = mels()
    with compare.reference_precision():
        want = ref.batch_call(state, sizes, mel, LENGTHS, "cpu")
        fp8 = ref.batch_call(state, sizes, mel, LENGTHS, "cpu", nx=Numerics("fp8"))
    return state, mel, want, fp8


def test_vocoder_kind_and_config():
    hps = tiny_hps()  # no train block: nothing trains the generator
    voc = Vocoder(hps, seeded()[1], device="cpu")
    assert type(voc) is GeneratorVocoder and not hasattr(voc, "net")
    assert all(v.dtype == torch.bfloat16 for v in voc.packed.convs.values())
    assert sorted(voc.packed.acts) == sorted(
        [f"resblocks.{n}.activations.{m}" for n in range(9) for m in range(6)]
        + ["activation_post"])


def test_mel_to_wav_matches_reference(reference):
    state, mel, want, fp8 = reference
    voc = Vocoder(tiny_hps(), state, device="cpu")
    got = voc.mel_to_wav(mel, LENGTHS, noise_scale=0.3, seed=7)
    assert [len(w) for w in got] == [n * 16 for n in LENGTHS]
    g = gaps(got, want)
    assert g["mel_l1"] < LIMIT, g
    assert gaps(fp8, want)["mel_l1"] > LIMIT
    # noise_scale and seed do nothing: the generator draws no noise
    again = voc.mel_to_wav(mel, LENGTHS)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


def test_module_graph_matches_reference(reference):
    """The f32 module graph, on the bucket the call pads to, is the
    reference's equations to float32 summation order."""
    state, mel, want, _ = reference
    net = build_bigvgan(tiny_hps(), weight_norm=False)
    net.load_state_dict(state, strict=True)
    padded = np.pad(mel, ((0, 0), (0, 128 - mel.shape[1]), (0, 0)))
    with torch.no_grad(), compare.reference_precision():
        out = net(torch.from_numpy(padded).transpose(1, 2))[:, 0].numpy()
    got = [out[i, : n * 16] for i, n in enumerate(LENGTHS)]
    assert gaps(got, want)["wav_rel_l2"] < 1e-5


def test_mel_to_wav_weight_normed_state(reference):
    """Weight-normed leaves (``weight_g``/``weight_v``), as a published
    checkpoint has them, with its fixed filters, fold to the answer of the
    folded weights."""
    state, mel, _, _ = reference
    sizes = ref.Sizes.from_config(TINY)
    wn = frozenset(q.name.rsplit(".", 1)[0] for q in ref.generator_params(sizes)
                   if q.kind == "weight")
    normed = weights.make(ref.generator_params(sizes), 123, torch.device("cpu"), weight_norm=wn)
    normed["activation_post.upsample.filter"] = torch.zeros(1, 1, 12)
    got = Vocoder(tiny_hps(), normed, device="cpu").mel_to_wav(mel, LENGTHS)
    folded = Vocoder(tiny_hps(), state, device="cpu").mel_to_wav(mel, LENGTHS)
    assert gaps(got, folded)["wav_rel_l2"] < 1e-5


def direct_aa(x, log_alpha, log_beta):
    """The equations in float64, loop by loop: replicate-pad by 5, the
    stride-2 transposed conv times 2, crop 15 each side; SnakeBeta;
    replicate-pad by 5 and 6, the stride-2 conv. ``x (C, T)``."""
    half = 6
    a = 2.285 * (half - 1) * math.pi * 1.2 + 7.95
    window = np.kaiser(12, 0.1102 * (a - 8.7))
    t = np.arange(-half, half) + 0.5
    f = 2 * 0.25 * window * np.sinc(2 * 0.25 * t)
    f = f / f.sum()
    c, n = x.shape
    xp = np.concatenate([np.repeat(x[:, :1], 5, 1), x, np.repeat(x[:, -1:], 5, 1)], 1)
    full = np.zeros((c, 2 * (n + 9) + 12))
    for j in range(n + 10):
        for k in range(12):
            full[:, 2 * j + k] += xp[:, j] * f[k]
    y = 2 * full[:, 15: 15 + 2 * n]
    z = y + np.sin(np.exp(log_alpha)[:, None] * y) ** 2 / (np.exp(log_beta)[:, None] + 1e-9)
    zp = np.concatenate([np.repeat(z[:, :1], 5, 1), z, np.repeat(z[:, -1:], 6, 1)], 1)
    return np.stack([(zp[:, 2 * q: 2 * q + 12] * f).sum(1) for q in range(n)], 1)


@pytest.mark.parametrize("t", [1, 2, 7, 40])
def test_activation_against_float64(t):
    rng = np.random.default_rng(t)
    c = 5
    x = rng.normal(0, 3, (c, t))
    la, lb = rng.uniform(-1, 1, c), rng.uniform(-1, 1, c)
    want = direct_aa(x, la, lb)
    xt = torch.from_numpy(x).float()[None]
    lat, lbt = torch.from_numpy(la).float(), torch.from_numpy(lb).float()
    packed = amp.Snake(*amp.snake_coefficients(lat, lbt))
    act = Activation1d(c)
    with torch.no_grad():
        act.act.alpha.copy_(lat)
        act.act.beta.copy_(lbt)
        outs = {"port": amp.aa_snake_plain(xt, packed, act.filter),
                "module": act(xt),
                "reference": ref.activation({"a.act.alpha": lat, "a.act.beta": lbt}, "a", xt,
                                            ref.kaiser_sinc_filter())}
    scale = np.abs(want).max()
    for name, got in outs.items():
        assert got.shape == (1, c, t), name
        np.testing.assert_allclose(got[0].double().numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=name)


def test_param_count_at_published_widths():
    cfg = run.load_json("vocbench", "configs", "bigvgan_v2_22khz_80band_256x.json")
    hps = validate(HParams(**{k: copy.deepcopy(cfg[k]) for k in ("data", "model", "tpu")}))
    net = build_bigvgan(hps, weight_norm=False, device="meta")
    n = sum(p.numel() for p in net.parameters())
    assert round(n / 1e6, 1) == 112.2
    assert n == ref.param_count(ref.generator_params(ref.Sizes.from_config(cfg)))
    # the activations a call launches, and the work the readers count
    assert flops_bigvgan.aa_activations(cfg, 32, 1024)[2] == 109
    assert flops_bigvgan.generator_flops(cfg, 32 * 1024) == pytest.approx(59.1e12, rel=1e-3)


def _no_resampling(x, act, taps):
    return snake_beta(x.float(), act.a, act.ib).to(torch.bfloat16)


FAULTS = {
    "snake_without_resampling": ("aa_snake", lambda orig: _no_resampling),
    "alpha_beta_swapped": ("snake_coefficients", lambda orig: lambda la, lb: orig(lb, la)),
    "branch_left_out": ("branch_mean", lambda orig: lambda ys: orig(ys[:-1])),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_limit(reference, monkeypatch, fault):
    state, mel, want, _ = reference
    name, make = FAULTS[fault]
    monkeypatch.setattr(amp, name, make(getattr(amp, name)))
    got = Vocoder(tiny_hps(), state, device="cpu").mel_to_wav(mel, LENGTHS)
    assert gaps(got, want)["mel_l1"] > LIMIT


def test_cell_driver_on_the_cpu():
    """The BigVGAN cell's driver end to end at the tiny sizes: correct, with
    its end-to-end metrics."""
    bench = run.load_json("BENCHMARK.json")
    cell = run.find(bench["workloads"], "bigvgan_v2_22khz_80band_256x.batch", "workload")
    ctx = run.make_context(cell, bench, 2 ** 33 + 5, 1.0, False, torch.device("cpu"),
                           copy.deepcopy(TINY))
    ctx.traffic.update({"batch": 3, "frames": [50, 70], "pool_calls": 2,
                        "limits": {"mel_l1": LIMIT}})
    ctx.log = lambda *a: None
    record, result = run.execute(ctx, bench)
    assert result["correct"] is True and result["failed"] == 0, record.checks
    assert set(result["metrics"]) == {"synth_x_realtime", "setup_s"}
    assert run.load_reader("bigvgan.mfu")(record) > 0
    assert run.load_reader("aa_act_roofline.synth")(record) is None  # no trace
    assert "synth.eps" not in {s.name for s in record.spans}


def test_paths_out_of_scope_raise():
    hps = tiny_hps()
    voc = Vocoder(hps, seeded()[1], device="cpu")
    mel = mels()
    with pytest.raises(ValueError, match="sid"):
        voc.mel_to_wav(mel, LENGTHS, sid=np.zeros(4, np.int64))
    with pytest.raises(NotImplementedError):
        voc.mel_to_wav_chunked(mel[0])
    with pytest.raises(NotImplementedError):
        voc.warmup()
    with pytest.raises(NotImplementedError):
        StreamServer(voc)
    with pytest.raises(ValueError, match="generator alone"):
        build_synthesizer(hps)
    with pytest.raises(ValueError, match="one device"):
        Vocoder(hps, seeded()[1], devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match="bf16"):
        Vocoder(hps, seeded()[1], dtype=torch.float32, device="cpu")
