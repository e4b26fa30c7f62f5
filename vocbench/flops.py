"""Model FLOPs of synthesis and of the train step, and the chip's peaks: a
frozen copy of the program's ``utils/flops.py`` (``synthesis_flops``,
``train_step_flops``), over the configuration's JSON.

Model FLOPs are the algorithmic conv work (2 x MACs) walked from the config,
not what an implementation executes; a backward counts 2 x its forward.
"""

from __future__ import annotations

import math

H100_BF16_PEAK = 989e12   # FLOP/s, dense bf16 tensor cores (H100 SXM data sheet)
H100_HBM_BYTES_S = 3.35e12  # bytes/s of HBM3 (H100 SXM data sheet)


def _conv(t_out: float, cin: int, cout: int, k: int, groups: int = 1) -> float:
    return 2.0 * t_out * cout * (cin // groups) * k


def wn_flops(t: float, hidden: int, kernel_size: int, n_layers: int) -> float:
    fl = 0.0
    for i in range(n_layers):
        fl += _conv(t, hidden, 2 * hidden, kernel_size)
        fl += _conv(t, hidden, 2 * hidden if i < n_layers - 1 else hidden, 1)
    return fl


def mel_encoder_flops(t: float, cfg: dict) -> float:
    m, d = cfg["model"], cfg["data"]
    h, inter = m["hidden_channels"], m["inter_channels"]
    return (_conv(t, d["n_mel_channels"], h, 1) + wn_flops(t, h, 5, int(m.get("enc_layers", 16)))
            + _conv(t, h, 2 * inter, 1))


def posterior_encoder_flops(t: float, cfg: dict) -> float:
    m, d = cfg["model"], cfg["data"]
    h, inter = m["hidden_channels"], m["inter_channels"]
    spec_ch = d["filter_length"] // 2 + 1
    return (_conv(t, spec_ch, h, 1) + wn_flops(t, h, 5, int(m.get("enc_layers", 16)))
            + _conv(t, h, 2 * inter, 1))


def flow_flops(t: float, cfg: dict, n_flows: int = 4) -> float:
    m = cfg["model"]
    h, half = m["hidden_channels"], m["inter_channels"] // 2
    per = (_conv(t, half, h, 1) + wn_flops(t, h, 5, int(m.get("flow_wn_layers", 8)))
           + _conv(t, h, half, 1))
    return n_flows * per


def generator_flops(t_frames: float, cfg: dict) -> float:
    """The HiFi-GAN decoder; a transposed conv is 2 * T_in * K * Cin * Cout."""
    m = cfg["model"]
    fl = _conv(t_frames, m["inter_channels"], m["upsample_initial_channel"], 7)
    t = float(t_frames)
    ch_in = m["upsample_initial_channel"]
    for i, (u, k) in enumerate(zip(m["upsample_rates"], m["upsample_kernel_sizes"])):
        ch = m["upsample_initial_channel"] // (2 ** (i + 1))
        fl += 2.0 * t * k * ch_in * ch
        t *= u
        for rk, rd in zip(m["resblock_kernel_sizes"], m["resblock_dilation_sizes"]):
            fl += len(rd) * (2 if m["resblock"] == "1" else 1) * _conv(t, ch, ch, rk)
        ch_in = ch
    return fl + _conv(t, ch_in, 1, 7)


def synthesis_flops(cfg: dict, batch: int, frames: float) -> float:
    """mel -> wav: the prior, the reverse flow and the decoder."""
    t = float(batch * frames)
    return mel_encoder_flops(t, cfg) + flow_flops(t, cfg) + generator_flops(t, cfg)


def discriminator_p_flops(t_samples: int, period: int, width_mult: float = 1.0,
                          kernel_size: int = 5, stride: int = 3) -> float:
    h = math.ceil(t_samples / period)
    fl, cin = 0.0, 1
    for i, ch in enumerate([32, 128, 512, 1024, 1024]):
        ch = max(4, int(ch * width_mult))
        s = stride if i < 4 else 1
        h = (h + 2 * ((kernel_size - 1) // 2) - kernel_size) // s + 1
        fl += _conv(h * period, cin, ch, kernel_size)
        cin = ch
    return fl + _conv(h * period, cin, 1, 3)


def discriminator_s_flops(t_samples: int, width_mult: float = 1.0) -> float:
    specs = [(16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20),
             (1024, 41, 4, 64, 20), (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2)]
    fl, cin, t = 0.0, 1, t_samples
    for ch, k, s, g, p in specs:
        ch = max(8, int(ch * width_mult))
        g = math.gcd(math.gcd(g, cin), ch)
        t = (t + 2 * p - k) // s + 1
        fl += _conv(t, cin, ch, k, groups=g)
        cin = ch
    return fl + _conv((t + 2 - 3) // 1 + 1, cin, 1, 3)


def discriminator_ensemble_flops(t_samples: int, width_mult: float = 1.0,
                                 periods=(2, 3, 5, 7, 11)) -> float:
    return (discriminator_s_flops(t_samples, width_mult)
            + sum(discriminator_p_flops(t_samples, p, width_mult) for p in periods))


def train_step_flops(cfg: dict, batch: int, frames: float) -> float:
    """One GAN step: G forward once + backward, the discriminator ensemble on
    two waveforms in each of the two phases, forward + backward."""
    t = float(batch * frames)
    seg = cfg["train"]["segment_size"]
    seg_frames = seg // cfg["data"]["hop_length"]
    g_fwd = (mel_encoder_flops(t, cfg) + posterior_encoder_flops(t, cfg) + flow_flops(t, cfg)
             + generator_flops(float(batch * seg_frames), cfg))
    d_apply = 2 * batch * discriminator_ensemble_flops(seg)
    return 3.0 * g_fwd + 2 * 3.0 * d_apply


def mrf_late_stages(cfg: dict, frames: float, launches: int = 1) -> tuple[float, float]:
    """FLOPs and bytes of the decoder's last two stages on ``frames`` frames
    decoded in ``launches`` calls of the stage kernels,
    counted once whatever the program's precision mode: stage 3 is the MRF at
    ``C = upsample_initial_channel / 8`` channels (252 C^2 T for the 3 x 3 x 2
    convolutions of kernels 3, 7, 11); stage 4 the last transposed
    convolution, the MRF at ``C / 2`` and ``conv_post``. Bytes: each input
    activation read once and each output written once in float32, the MRF and
    upsampling weights read once a launch in bfloat16."""
    m = cfg["model"]
    rates = m["upsample_rates"]
    c3 = m["upsample_initial_channel"] // 2 ** (len(rates) - 1)
    c4 = c3 // 2
    t3 = float(frames) * math.prod(rates[:-1])
    t4 = t3 * rates[-1]
    ks = sum(m["resblock_kernel_sizes"])
    per_k = 2 * len(m["resblock_dilation_sizes"][0])  # convs a kernel size
    mrf = lambda c, t: 2.0 * c * c * ks * per_k * t  # noqa: E731
    k_up = m["upsample_kernel_sizes"][-1]
    flops = mrf(c3, t3) + 2.0 * t3 * k_up * c3 * c4 + mrf(c4, t4) + _conv(t4, c4, 1, 7)
    w_bytes = 2 * (per_k * ks * (c3 * c3 + c4 * c4) + k_up * c3 * c4)
    act_bytes = 4 * (c3 * t3 + c3 * t3 + c3 * t3 + t4)  # stage 3 in, out; stage 4 in, out
    return flops, act_bytes + launches * w_bytes


def roofline_seconds(flops: float, nbytes: float) -> float:
    return max(flops / H100_BF16_PEAK, nbytes / H100_HBM_BYTES_S)
