"""Masking and segment-slicing utilities (counterpart of
``smart_vocoder_tpu/ops/segments.py``).

Random segment slicing is the reference's length-decoupling trick: only a
fixed-size window of the latent is decoded during training, so generator and
discriminator cost do not depend on the utterance's length (commons.py:48-64).
"""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """``(B,) lengths -> (B, max_length)`` bool mask (ref: commons.py:121-125).

    Channel-first callers take ``mask[:, None, :]``; the JAX package returns
    ``(B, T, 1)`` because it is time-major."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]


def slice_segments(x: torch.Tensor, ids: torch.Tensor, size: int) -> torch.Tensor:
    """Per-row windows ``x[i, ids[i] : ids[i] + size]`` of a time-major
    ``(B, T, C)`` tensor -> ``(B, size, C)``, one gather. A start is placed
    as the JAX package's ``dynamic_slice`` places it: a negative one counts
    from the end, then each is clamped to ``[0, T - size]``."""
    b, t = x.shape[:2]
    start = ids.to(device=x.device, dtype=torch.long)
    start = torch.where(start < 0, start + t, start).clamp(0, t - size)
    idx = start[:, None] + torch.arange(size, device=x.device)
    return x[torch.arange(b, device=x.device)[:, None], idx]


def rand_slice_segments(x: torch.Tensor, lengths: torch.Tensor, size: int,
                        generator: torch.Generator | None = None,
                        ids: torch.Tensor | None = None):
    """Random fixed-size windows of ``x (B, T, C)`` and their int32 starts
    (ref: commons.py:57-64). The starts are the JAX package's: ``u`` uniform
    in f32 (drawn from ``generator`` on its device, or passed in as ``ids``),
    ``ids = (u * (length - size + 1)).int()``."""
    if ids is None:
        gen_device = generator.device if generator is not None else torch.device("cpu")
        u = torch.rand((x.shape[0],), generator=generator, dtype=torch.float32,
                       device=gen_device)
        ids_max = (lengths.to(gen_device) - size + 1).to(torch.float32)
        ids = (u * ids_max).to(torch.int32)
    ids = ids.to(device=x.device, dtype=torch.int32)
    return slice_segments(x, ids, size), ids
