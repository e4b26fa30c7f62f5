"""SynthesizerTrn: the conditional-VAE vocoder generator (reference models.py).

Counterpart of ``smart_vocoder_tpu/models/synthesizer.py``. Submodules are
channel-first ``(B, C, T)``; ``SynthesizerTrn.infer`` takes and returns the
JAX package's time-major shapes (mel ``(B, T, n_mels)``, waveform
``(B, T*hop, 1)``), as do ``forward`` (training) and ``voice_conversion``.
Parameter names follow the reference, so the state dict of a reference
``G_*.pth`` loads with ``strict=True``.

Training (models.py:317-329): the posterior samples ``z`` from the linear
spectrogram, the flow maps ``z -> z_p``, the mel prior gives ``(m_p,
logs_p)``, and a random ``segment_size``-frame slice of ``z`` is decoded.

Inference (models.py:331-339): sample ``z_p = m_p + eps * exp(logs_p) *
noise_scale`` from the mel prior, run the flow in reverse, decode. Voice
conversion (models.py:341-349): the posterior of a spectrogram under one
speaker, through the flow and back under another, decoded as that speaker.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from smart_vocoder_torch.nn import (
    LRELU_SLOPE,
    WN,
    Conv1d,
    ConvTranspose1d,
    Flip,
    ResBlock1,
    ResBlock2,
    ResidualCouplingLayer,
)
from smart_vocoder_torch.ops import prior_sample, rand_slice_segments, sequence_mask


class MelEncoder(nn.Module):
    """Prior network: mel -> (m_p, logs_p) (ref: models.py:15-47); never
    speaker-conditioned, as in the reference (models.py:36)."""

    def __init__(self, out_channels: int, hidden_channels: int, n_layers: int = 16,
                 kernel_size: int = 5, dilation_rate: int = 1, n_mels: int = 80,
                 weight_norm: bool = True, device=None):
        super().__init__()
        self.out_channels = out_channels
        self.pre_enc = Conv1d(n_mels, hidden_channels, 1, device=device)
        self.encoder = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                          weight_norm=weight_norm, device=device)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1, device=device)

    def forward(self, x: torch.Tensor, x_lengths: torch.Tensor):
        """x: (B, n_mels, T) -> (h, m, logs, mask (B, 1, T))."""
        x = self.pre_enc(x)
        x_mask = sequence_mask(x_lengths, x.shape[2])[:, None].to(x.dtype)
        x = self.encoder(x * x_mask, x_mask)
        stats = self.proj(x) * x_mask
        m, logs = stats[:, : self.out_channels], stats[:, self.out_channels :]
        return x, m, logs, x_mask


class PosteriorEncoder(nn.Module):
    """Linear-spec encoder (ref: models.py:83-112). Synthesis does not run it;
    voice conversion does."""

    def __init__(self, in_channels: int, out_channels: int, hidden_channels: int,
                 kernel_size: int = 5, dilation_rate: int = 1, n_layers: int = 16,
                 gin_channels: int = 0, conditioned: bool = False,
                 weight_norm: bool = True, device=None):
        super().__init__()
        self.out_channels = out_channels
        self.pre = Conv1d(in_channels, hidden_channels, 1, device=device)
        self.enc = WN(hidden_channels, kernel_size, dilation_rate, n_layers,
                      gin_channels=gin_channels, conditioned=conditioned,
                      weight_norm=weight_norm, device=device)
        self.proj = Conv1d(hidden_channels, out_channels * 2, 1, device=device)

    def forward(self, x, x_lengths, eps, g=None):
        """x: (B, spec, T); ``eps`` the posterior noise, shaped like ``m``."""
        x_mask = sequence_mask(x_lengths, x.shape[2])[:, None].to(x.dtype)
        x = self.pre(x) * x_mask
        x = self.enc(x, x_mask, g=g)
        stats = self.proj(x) * x_mask
        m, logs = stats[:, : self.out_channels], stats[:, self.out_channels :]
        z = (m + eps.to(m.dtype) * torch.exp(logs)) * x_mask
        return z, m, logs, x_mask


class ResidualCouplingBlock(nn.Module):
    """4x (coupling + flip) flow (ref: models.py:50-80). Couplings sit at
    ``flows.0/2/4/6`` and parameter-free flips at the odd slots, as in the
    reference's ModuleList."""

    def __init__(self, channels: int, hidden_channels: int, kernel_size: int = 5,
                 dilation_rate: int = 1, n_layers: int = 8, n_flows: int = 4,
                 gin_channels: int = 0, conditioned: bool = False,
                 weight_norm: bool = True, device=None):
        super().__init__()
        self.flows = nn.ModuleList()
        for _ in range(n_flows):
            self.flows.append(ResidualCouplingLayer(
                channels, hidden_channels, kernel_size, dilation_rate, n_layers,
                gin_channels=gin_channels, conditioned=conditioned,
                weight_norm=weight_norm, device=device))
            self.flows.append(Flip())

    def forward(self, x, x_mask, g=None, reverse: bool = False):
        if not reverse:
            for flow in self.flows:
                x = flow(x) if isinstance(flow, Flip) else flow(x, x_mask, g=g)
        else:
            for flow in reversed(self.flows):
                x = (flow(x) if isinstance(flow, Flip)
                     else flow(x, x_mask, g=g, reverse=True))
        return x


class Generator(nn.Module):
    """HiFi-GAN V1 decoder (ref: models.py:115-167): conv_pre -> N x [lrelu ->
    transposed-conv upsample -> MRF (mean of the ResBlocks)] -> lrelu(0.01)
    -> conv_post -> tanh."""

    def __init__(self, initial_channel: int, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 gin_channels: int = 0, conditioned: bool = False,
                 weight_norm: bool = True, device=None):
        super().__init__()
        self.num_kernels = len(resblock_kernel_sizes)
        self.conv_pre = Conv1d(initial_channel, upsample_initial_channel, 7, padding=3,
                               device=device)
        self.cond = (Conv1d(gin_channels, upsample_initial_channel, 1, device=device)
                     if conditioned else None)
        res_cls = ResBlock1 if resblock == "1" else ResBlock2
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernel_sizes)):
            ch = upsample_initial_channel // (2 ** (i + 1))
            self.ups.append(ConvTranspose1d(2 * ch, ch, k, u, padding=(k - u) // 2,
                                            weight_norm=weight_norm, device=device))
            for rk, rd in zip(resblock_kernel_sizes, resblock_dilation_sizes):
                self.resblocks.append(res_cls(ch, rk, tuple(rd), weight_norm=weight_norm,
                                              device=device))
        self.conv_post = Conv1d(ch, 1, 7, padding=3, bias=False, device=device)

    def forward(self, x: torch.Tensor, g: torch.Tensor | None = None) -> torch.Tensor:
        """x: (B, C, T) -> (B, 1, T*hop)."""
        x = self.conv_pre(x)
        if g is not None:
            x = x + self.cond(g)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            blocks = self.resblocks[i * self.num_kernels : (i + 1) * self.num_kernels]
            xs = None
            for block in blocks:
                xs = block(x) if xs is None else xs + block(x)
            x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x))  # torch's default 0.01 slope (models.py:156)
        return torch.tanh(x)


class SynthesizerTrn(nn.Module):
    """Top-level CVAE generator wiring (ref: models.py:261-349)."""

    def __init__(self, spec_channels: int, inter_channels: int = 192,
                 hidden_channels: int = 192, resblock: str = "1",
                 resblock_kernel_sizes: Sequence[int] = (3, 7, 11),
                 resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3,
                 upsample_rates: Sequence[int] = (8, 8, 2, 2),
                 upsample_initial_channel: int = 512,
                 upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4),
                 n_speakers: int = 0, gin_channels: int = 0, use_spk_embed: bool = False,
                 enc_layers: int = 16, flow_wn_layers: int = 8, n_mels: int = 80,
                 weight_norm: bool = True, device=None, segment_size: int | None = None):
        super().__init__()
        self.inter_channels = inter_channels
        self.segment_size = segment_size  # frames decoded per training row
        conditioned = bool(use_spk_embed and n_speakers > 0 and gin_channels > 0)
        self.enc_p = MelEncoder(inter_channels, hidden_channels, enc_layers, 5, 1,
                                n_mels=n_mels, weight_norm=weight_norm, device=device)
        self.dec = Generator(inter_channels, resblock, resblock_kernel_sizes,
                             resblock_dilation_sizes, upsample_rates,
                             upsample_initial_channel, upsample_kernel_sizes,
                             gin_channels=gin_channels, conditioned=conditioned,
                             weight_norm=weight_norm, device=device)
        self.enc_q = PosteriorEncoder(spec_channels, inter_channels, hidden_channels, 5, 1,
                                      enc_layers, gin_channels=gin_channels,
                                      conditioned=conditioned, weight_norm=weight_norm,
                                      device=device)
        self.flow = ResidualCouplingBlock(inter_channels, hidden_channels, 5, 1,
                                          flow_wn_layers, gin_channels=gin_channels,
                                          conditioned=conditioned,
                                          weight_norm=weight_norm, device=device)
        self.emb_g = (nn.Embedding(n_speakers, gin_channels, device=device)
                      if conditioned else None)

    def speaker(self, sid: torch.Tensor | None) -> torch.Tensor | None:
        """(B,) speaker ids -> (B, gin, 1), or None (the reference forces
        g=None, models.py:318, :332)."""
        if self.emb_g is None or sid is None:
            return None
        return self.emb_g(sid)[:, :, None]

    def forward(self, mel: torch.Tensor, mel_lengths: torch.Tensor, spec: torch.Tensor,
                spec_lengths: torch.Tensor, eps_q: torch.Tensor,
                ids_slice: torch.Tensor | None = None,
                generator: torch.Generator | None = None, sid: torch.Tensor | None = None):
        """Training forward (ref: models.py:317-329), with explicit randomness.

        mel (B, T, n_mels), spec (B, T, spec_channels), eps_q (B, T, inter)
        the posterior noise; ``ids_slice`` (B,) the slice starts, or drawn
        from ``generator`` (``ops.rand_slice_segments``). Returns, time-major
        as the JAX module does: y_hat (B, segment_size*hop, 1), ids_slice
        (int32), x_mask and y_mask (B, T, 1), and (z, z_p, m_p, logs_p, m_q,
        logs_q), each (B, T, inter)."""
        if self.segment_size is None:
            raise ValueError("SynthesizerTrn.forward needs segment_size (frames)")
        g = self.speaker(sid)
        _, m_p, logs_p, x_mask = self.enc_p(mel.transpose(1, 2), mel_lengths)
        z, m_q, logs_q, y_mask = self.enc_q(spec.transpose(1, 2), spec_lengths,
                                            eps_q.transpose(1, 2), g=g)
        z_p = self.flow(z, y_mask, g=g)
        z_slice, ids_slice = rand_slice_segments(z.transpose(1, 2), spec_lengths,
                                                 self.segment_size, generator, ids_slice)
        o = self.dec(z_slice.transpose(1, 2), g=g)
        return (o.transpose(1, 2), ids_slice, x_mask.transpose(1, 2), y_mask.transpose(1, 2),
                tuple(v.transpose(1, 2) for v in (z, z_p, m_p, logs_p, m_q, logs_q)))

    def prior_latent(self, mel: torch.Tensor, lengths: torch.Tensor, eps: torch.Tensor,
                     noise_scale: float | torch.Tensor = 1.0, sid: torch.Tensor | None = None):
        """mel (B, T, n_mels), eps (B, T, inter) -> masked latent z (B, inter, T),
        mask (B, 1, T), g. ``noise_scale``: a float or one per row ``(B,)``,
        rounded to the prior's dtype (``ops.noise.prior_sample``)."""
        g = self.speaker(sid)
        _, m_p, logs_p, mask = self.enc_p(mel.transpose(1, 2), lengths)
        z_p = prior_sample(m_p, logs_p, eps.transpose(1, 2), noise_scale)
        z = self.flow(z_p, mask, g=g, reverse=True)
        return z * mask, mask, g

    def infer(self, mel: torch.Tensor, lengths: torch.Tensor, eps: torch.Tensor,
              noise_scale: float = 1.0, sid: torch.Tensor | None = None):
        """Sampling path (ref: models.py:331-339) with explicit prior noise.

        mel (B, T, n_mels), eps (B, T, inter) -> waveform (B, T*hop, 1),
        mask (B, T, 1)."""
        z, mask, g = self.prior_latent(mel, lengths, eps, noise_scale, sid)
        o = self.dec(z, g=g)
        return o.transpose(1, 2), mask.transpose(1, 2)

    def voice_conversion(self, spec: torch.Tensor, lengths: torch.Tensor, eps_q: torch.Tensor,
                         sid_src: torch.Tensor, sid_tgt: torch.Tensor):
        """Source-speaker spectrogram -> target-speaker waveform (ref:
        models.py:341-349, which crashes as shipped because ``emb_g`` is
        undefined; ``smart_vocoder_tpu/models/synthesizer.py:334-353``).

        spec (B, T, spec_channels), eps_q (B, T, inter) the posterior noise ->
        waveform (B, T*hop, 1), mask (B, T, 1) and (z, z_p, z_hat), each
        (B, T, inter): the posterior under ``sid_src``, the flow under it, and
        the reverse flow under ``sid_tgt``."""
        if self.emb_g is None:
            raise ValueError("voice_conversion requires use_spk_embed and n_speakers > 0")
        g_src, g_tgt = self.speaker(sid_src), self.speaker(sid_tgt)
        z, _, _, mask = self.enc_q(spec.transpose(1, 2), lengths, eps_q.transpose(1, 2),
                                   g=g_src)
        z_p = self.flow(z, mask, g=g_src)
        z_hat = self.flow(z_p, mask, g=g_tgt, reverse=True)
        o_hat = self.dec(z_hat * mask, g=g_tgt)
        return (o_hat.transpose(1, 2), mask.transpose(1, 2),
                tuple(v.transpose(1, 2) for v in (z, z_p, z_hat)))
