"""GAN and reconstruction losses (counterpart of ``smart_vocoder_tpu/losses.py``,
reference losses.py).

Every loss computes in float32 whatever the model's compute dtype, as the
reference's fp32 autocast islands do (train.py:189, :201; losses.py casts each
input with ``.float()``). Logits and feature maps may be in any layout: the
losses are means over all their elements.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def discriminator_loss(disc_real_outputs: Sequence[torch.Tensor],
                       disc_generated_outputs: Sequence[torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor], List[torch.Tensor]]:
    """LSGAN D loss: sum over discriminators of mean((1 - D(y))^2) +
    mean(D(y_hat)^2) (ref: losses.py:18-31), and the per-discriminator terms."""
    loss = 0.0
    r_losses, g_losses = [], []
    for dr, dg in zip(disc_real_outputs, disc_generated_outputs):
        r_loss = torch.mean((1.0 - dr.float()) ** 2)
        g_loss = torch.mean(dg.float() ** 2)
        loss = loss + r_loss + g_loss
        r_losses.append(r_loss)
        g_losses.append(g_loss)
    return loss, r_losses, g_losses


def generator_loss(disc_outputs: Sequence[torch.Tensor]
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """LSGAN G loss: sum over discriminators of mean((1 - D(y_hat))^2)
    (ref: losses.py:34-43), and the per-discriminator terms."""
    loss = 0.0
    gen_losses = []
    for dg in disc_outputs:
        term = torch.mean((1.0 - dg.float()) ** 2)
        gen_losses.append(term)
        loss = loss + term
    return loss, gen_losses


def feature_loss(fmap_r, fmap_g) -> torch.Tensor:
    """2 x the sum over discriminators and layers of mean |fmap_r - fmap_g|
    (ref: losses.py:7-15). The caller detaches the real maps."""
    loss = 0.0
    for dr, dg in zip(fmap_r, fmap_g):
        for rl, gl in zip(dr, dg):
            loss = loss + torch.mean(torch.abs(rl.float() - gl.float()))
    return loss * 2.0


def kl_loss(z_p: torch.Tensor, logs_q: torch.Tensor, m_p: torch.Tensor,
            logs_p: torch.Tensor, z_mask: torch.Tensor,
            denominator: torch.Tensor | None = None) -> torch.Tensor:
    """Masked KL between the flow-mapped posterior and the mel prior
    (ref: losses.py:46-61); any layout, the mask broadcast against the rest.
    The masked sum is divided by ``sum(z_mask)``, or by ``denominator`` where
    a data-parallel rank must divide by its share of the global mask sum."""
    z_p, logs_q, m_p, logs_p = z_p.float(), logs_q.float(), m_p.float(), logs_p.float()
    z_mask = z_mask.float()
    kl = logs_p - logs_q - 0.5
    kl = kl + 0.5 * ((z_p - m_p) ** 2) * torch.exp(-2.0 * logs_p)
    return torch.sum(kl * z_mask) / (torch.sum(z_mask) if denominator is None else denominator)


def mel_l1_loss(y_mel: torch.Tensor, y_hat_mel: torch.Tensor) -> torch.Tensor:
    """L1 mel reconstruction term (ref: train.py:202 ``F.l1_loss``)."""
    return torch.mean(torch.abs(y_mel.float() - y_hat_mel.float()))
