"""Analytic model FLOPs of synthesis and of the train step (the part of
``smart_vocoder_tpu/utils/flops.py`` that ``synthesis_flops`` and
``train_step_flops`` reach, copied: the port may not import it).

Model FLOPs are the algorithmic conv and matmul work (2 x MACs) walked from
the config (reference models.py), not what an implementation executes; the
backward counts 2 x the forward (one matmul each for data and weight
gradients). ``train_step_flops`` is the bound of the port's train step:
one generator forward + backward and the discriminator ensemble on two
waveforms, forward + backward, in each of the two phases.
"""

from __future__ import annotations

import math

H100_BF16_PEAK = 989e12  # FLOP/s, dense bf16 tensor cores (H100 SXM data sheet)


def _conv(t_out: float, cin: int, cout: int, k: int, groups: int = 1) -> float:
    return 2.0 * t_out * cout * (cin // groups) * k


def wn_flops(t: float, hidden: int, kernel_size: int, n_layers: int) -> float:
    """WN stack (nn/wn.py; reference modules.py:111-184), g=None path."""
    fl = 0.0
    for i in range(n_layers):
        fl += _conv(t, hidden, 2 * hidden, kernel_size)  # in_layers_i
        res_skip = 2 * hidden if i < n_layers - 1 else hidden
        fl += _conv(t, hidden, res_skip, 1)  # res_skip_layers_i
    return fl


def mel_encoder_flops(t: float, hps) -> float:
    h = hps.model.hidden_channels
    inter = hps.model.inter_channels
    n_layers = int(hps.model.get("enc_layers", 16))
    return (_conv(t, hps.data.n_mel_channels, h, 1)
            + wn_flops(t, h, 5, n_layers)
            + _conv(t, h, 2 * inter, 1))


def posterior_encoder_flops(t: float, hps) -> float:
    h = hps.model.hidden_channels
    inter = hps.model.inter_channels
    spec_ch = hps.data.filter_length // 2 + 1
    n_layers = int(hps.model.get("enc_layers", 16))
    return (_conv(t, spec_ch, h, 1)
            + wn_flops(t, h, 5, n_layers)
            + _conv(t, h, 2 * inter, 1))


def flow_flops(t: float, hps, n_flows: int = 4) -> float:
    """ResidualCouplingBlock, forward or reverse (same cost)."""
    h = hps.model.hidden_channels
    half = hps.model.inter_channels // 2
    wn_layers = int(hps.model.get("flow_wn_layers", 8))
    per_coupling = (_conv(t, half, h, 1)
                    + wn_flops(t, h, 5, wn_layers)
                    + _conv(t, h, half, 1))  # mean_only post
    return n_flows * per_coupling


def generator_flops(t_frames: float, hps) -> float:
    """HiFi-GAN decoder (models/synthesizer.py Generator). ConvTranspose
    FLOPs = 2 * T_in * K * Cin * Cout (every input position drives K taps)."""
    m = hps.model
    fl = _conv(t_frames, m.inter_channels, m.upsample_initial_channel, 7)
    t = float(t_frames)
    ch_in = m.upsample_initial_channel
    num_kernels = len(m.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(m.upsample_rates, m.upsample_kernel_sizes)):
        ch = m.upsample_initial_channel // (2 ** (i + 1))
        fl += 2.0 * t * k * ch_in * ch  # ups_i (transposed)
        t *= u
        for rk, rd in zip(m.resblock_kernel_sizes, m.resblock_dilation_sizes):
            if m.resblock == "1":
                fl += len(rd) * 2 * _conv(t, ch, ch, rk)  # convs1_j + convs2_j
            else:
                fl += len(rd) * _conv(t, ch, ch, rk)
        ch_in = ch
    fl += _conv(t, ch_in, 1, 7)  # conv_post
    return fl


def synthesis_flops(hps, batch: int, frames: int) -> float:
    """Full mel->wav inference: enc_p + reverse flow + decoder. Over a step's
    seconds and ``H100_BF16_PEAK`` it is the headline's ``mfu``
    (``smart_vocoder_torch/bench.py``)."""
    t = float(batch * frames)
    return (mel_encoder_flops(t, hps) + flow_flops(t, hps)
            + generator_flops(t, hps))


def discriminator_p_flops(t_samples: int, period: int, width_mult: float = 1.0,
                          kernel_size: int = 5, stride: int = 3) -> float:
    """DiscriminatorP (models/discriminator.py; ref models.py:170-204)."""
    h = math.ceil(t_samples / period)  # reflect-padded rows
    fl, cin = 0.0, 1
    for i, ch in enumerate([32, 128, 512, 1024, 1024]):
        ch = max(4, int(ch * width_mult))
        s = stride if i < 4 else 1
        h = (h + 2 * ((kernel_size - 1) // 2) - kernel_size) // s + 1
        fl += _conv(h * period, cin, ch, kernel_size)
        cin = ch
    fl += _conv(h * period, cin, 1, 3)  # conv_post
    return fl


def discriminator_s_flops(t_samples: int, width_mult: float = 1.0) -> float:
    """DiscriminatorS (ref models.py:207-232); grouped convs count Cin/g."""
    specs = [(16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
             (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2)]
    fl, cin, t = 0.0, 1, t_samples
    for ch, k, s, g, p in specs:
        ch = max(8, int(ch * width_mult))
        g = math.gcd(math.gcd(g, cin), ch)
        t = (t + 2 * p - k) // s + 1
        fl += _conv(t, cin, ch, k, groups=g)
        cin = ch
    fl += _conv((t + 2 - 3) // 1 + 1, cin, 1, 3)
    return fl


def discriminator_ensemble_flops(t_samples: int, width_mult: float = 1.0,
                                 periods=(2, 3, 5, 7, 11)) -> float:
    """One MultiPeriodDiscriminator apply on ONE waveform of t_samples."""
    return (discriminator_s_flops(t_samples, width_mult)
            + sum(discriminator_p_flops(t_samples, p, width_mult)
                  for p in periods))


def train_step_flops(hps, batch: int, frames: int) -> float:
    """Model FLOPs of one full GAN train step (training/step.py).

    Counts: generator fwd once + bwd (3x fwd, the vjp-shared design); the
    discriminator ensemble applied to 2 waveforms in each of the 2 phases,
    with a backward each phase (3x fwd per phase). STFT/mel/losses/optimizer
    are <1% and omitted (they measure ~3 of ~1500 GFLOP in
    scripts/train_phase_flops.py).
    """
    t = float(batch * frames)
    seg = hps.train.segment_size
    seg_frames = seg // hps.data.hop_length
    g_fwd = (mel_encoder_flops(t, hps) + posterior_encoder_flops(t, hps)
             + flow_flops(t, hps)
             + generator_flops(float(batch * seg_frames), hps))
    d_apply = 2 * batch * discriminator_ensemble_flops(seg)  # (y, y_hat) pair
    return 3.0 * g_fwd + 2 * 3.0 * d_apply
