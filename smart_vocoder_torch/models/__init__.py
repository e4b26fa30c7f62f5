"""Model layer (counterpart of ``smart_vocoder_tpu/models``): the synthesizer."""

from smart_vocoder_torch.models.synthesizer import (
    Generator,
    MelEncoder,
    PosteriorEncoder,
    ResidualCouplingBlock,
    SynthesizerTrn,
)


def build_synthesizer(hps, weight_norm: bool = True, device=None) -> SynthesizerTrn:
    """Construct from an HParams config as train.py:82-86 does."""
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
    )


__all__ = [
    "Generator",
    "MelEncoder",
    "PosteriorEncoder",
    "ResidualCouplingBlock",
    "SynthesizerTrn",
    "build_synthesizer",
]
