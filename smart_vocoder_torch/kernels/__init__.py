"""Hand-written CUDA kernels for Hopper and the fast decoder that routes to them.

- :func:`mrf_stage` -- one fused MRF stage (decoder stage 3); replaces the
  JAX package's ``fused_mrf_stage_packed``.
- :func:`up_mrf_stage` -- upsample + MRF + decoder tail (stage 4); replaces
  ``fused_up_mrf_stage``.

Each has its plain PyTorch version beside it in ``kernels/mrf.py``.
"""

from smart_vocoder_torch.kernels.mrf import (
    LAUNCHES,
    mrf_stage,
    mrf_stage_plain,
    reset_launch_counts,
    up_mrf_stage,
    up_mrf_stage_plain,
)

__all__ = [
    "LAUNCHES",
    "mrf_stage",
    "mrf_stage_plain",
    "reset_launch_counts",
    "up_mrf_stage",
    "up_mrf_stage_plain",
]
