"""Model layer (counterpart of ``smart_vocoder_tpu/models``): the synthesizer
and the discriminator ensemble; BigVGAN-v2's generator (``model.kind:
"bigvgan"``), which the JAX package does not have."""

from smart_vocoder_torch.config import model_kind
from smart_vocoder_torch.models.bigvgan import BigVGAN, build_bigvgan

from smart_vocoder_torch.models.discriminator import (
    DiscriminatorP,
    DiscriminatorS,
    MultiPeriodDiscriminator,
)
from smart_vocoder_torch.models.synthesizer import (
    Generator,
    MelEncoder,
    PosteriorEncoder,
    ResidualCouplingBlock,
    SynthesizerTrn,
)


def build_synthesizer(hps, weight_norm: bool = True, device=None) -> SynthesizerTrn:
    """Construct from an HParams config as train.py:82-86 does; ``segment_size``
    is the training slice in frames (``train.segment_size // hop_length``).
    A generator-only kind raises: it has no prior, flow or posterior."""
    if model_kind(hps) != "smart":
        raise ValueError(f"model.kind {model_kind(hps)!r} is a generator alone: it has no "
                         "prior, flow or posterior, so no training step or voice conversion; "
                         "build it with build_bigvgan and serve it through Vocoder.mel_to_wav")
    return SynthesizerTrn(
        spec_channels=hps.data.filter_length // 2 + 1,
        inter_channels=hps.model.inter_channels,
        hidden_channels=hps.model.hidden_channels,
        resblock=hps.model.resblock,
        resblock_kernel_sizes=tuple(hps.model.resblock_kernel_sizes),
        resblock_dilation_sizes=tuple(tuple(d) for d in hps.model.resblock_dilation_sizes),
        upsample_rates=tuple(hps.model.upsample_rates),
        upsample_initial_channel=hps.model.upsample_initial_channel,
        upsample_kernel_sizes=tuple(hps.model.upsample_kernel_sizes),
        n_speakers=hps.data.n_speakers,
        gin_channels=hps.model.gin_channels,
        use_spk_embed=bool(hps.model.get("use_spk_embed", False)),
        enc_layers=int(hps.model.get("enc_layers", 16)),
        flow_wn_layers=int(hps.model.get("flow_wn_layers", 8)),
        n_mels=hps.data.n_mel_channels,
        weight_norm=weight_norm,
        device=device,
        segment_size=hps.train.segment_size // hps.data.hop_length,
    )


def build_discriminator(hps, device=None) -> MultiPeriodDiscriminator:
    """The discriminator ensemble as the JAX training loop builds it
    (``smart_vocoder_tpu/training/loop.py:98-102``): ``model.use_spectral_norm``
    and ``model.disc_width_mult`` from the config."""
    return MultiPeriodDiscriminator(
        bool(hps.model.get("use_spectral_norm", False)),
        width_mult=float(hps.model.get("disc_width_mult", 1.0)),
        device=device,
    )


__all__ = [
    "BigVGAN",
    "DiscriminatorP",
    "DiscriminatorS",
    "Generator",
    "MelEncoder",
    "MultiPeriodDiscriminator",
    "PosteriorEncoder",
    "ResidualCouplingBlock",
    "SynthesizerTrn",
    "build_bigvgan",
    "build_discriminator",
    "build_synthesizer",
]
