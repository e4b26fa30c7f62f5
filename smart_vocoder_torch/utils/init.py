"""Seeded full-size weights for the card.

The JAX package's fidelity weights (``smart_vocoder_tpu/utils/golden.py:
fidelity_params``) come from a threefry init that torch cannot reproduce, and
at iitp_base size (42.9 M parameters) they are too large to commit. So on the
card the port builds its own weights from a ``torch.Generator``: torch's conv
default init (uniform +-1/sqrt(fan_in), weight-norm ``g = ||v||``), the
coupling ``post`` weight at zero as the JAX package initialises it, and the
same ``conv_post`` x30 gain (golden.py:23, :45-46) that lifts a fresh
generator's output from near-silence to speech-like levels, so that mel-L1
measures the implementation and not the ``log(clamp(., 1e-5))`` floor.
A trainer starts from the plain init (``conv_post_gain=1``), as the JAX
package's ``init_train_state`` does: the gain is a serving-fidelity device.
"""

from __future__ import annotations

import torch

from smart_vocoder_torch.nn.conv import _WeightNormConv
from smart_vocoder_torch.nn.coupling import ResidualCouplingLayer

CONV_POST_GAIN = 30.0


@torch.no_grad()
def init_synthesizer(net: torch.nn.Module, seed: int,
                     conv_post_gain: float = CONV_POST_GAIN) -> torch.nn.Module:
    """Fill every parameter of ``net`` (a ``SynthesizerTrn``) from ``seed``,
    on the CPU, whatever device the parameters live on; ``conv_post``'s
    weight is scaled by ``conv_post_gain``."""
    gen = torch.Generator().manual_seed(seed)
    zero_post = {id(m.post) for m in net.modules() if isinstance(m, ResidualCouplingLayer)}
    for name, mod in net.named_modules():
        if isinstance(mod, _WeightNormConv):
            mod.reset_parameters(gen, zero=id(mod) in zero_post)
        elif isinstance(mod, torch.nn.Embedding):
            mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen))
    net.dec.conv_post.weight.mul_(conv_post_gain)  # conv_post is never weight-normed
    return net


@torch.no_grad()
def init_discriminator(net: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Fill every parameter of ``net`` (a ``MultiPeriodDiscriminator``) from
    ``seed`` with torch's conv default, and each spectral-norm ``weight_u``
    from a normal, as the JAX package initialises it."""
    gen = torch.Generator().manual_seed(seed)
    for mod in net.modules():
        if isinstance(mod, _WeightNormConv):
            mod.reset_parameters(gen)
    return net
