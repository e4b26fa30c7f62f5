"""Masking utilities (counterpart of ``smart_vocoder_tpu/ops/segments.py``)."""

from __future__ import annotations

import torch


def sequence_mask(lengths: torch.Tensor, max_length: int) -> torch.Tensor:
    """``(B,) lengths -> (B, max_length)`` bool mask (ref: commons.py:121-125).

    Channel-first callers take ``mask[:, None, :]``; the JAX package returns
    ``(B, T, 1)`` because it is time-major."""
    pos = torch.arange(max_length, device=lengths.device, dtype=lengths.dtype)
    return pos[None, :] < lengths[:, None]
