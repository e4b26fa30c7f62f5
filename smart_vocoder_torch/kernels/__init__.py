"""Hand-written CUDA kernels for Hopper and the fast paths that route to them.

- :func:`mrf_stage` -- one fused MRF stage (decoder stage 3); replaces the
  JAX package's ``fused_mrf_stage_packed``.
- :func:`mrf_stage_unpacked` -- the MRF stage in ``x.dtype`` at 32-256
  channels (stages 2 and 1 under ``pallas_stage2``); replaces
  ``fused_mrf_stage``.
- :func:`up_mrf_stage` -- upsample + MRF [+ decoder tail] (stage 4, or stage
  3 under ``pallas_stage2``); replaces ``fused_up_mrf_stage``.
- :func:`wn_stack` -- the fused WN layers of the prior and the flow
  (``use_wn_kernels``); replaces ``fused_wn_stack``.

Each has its plain PyTorch version beside it (``kernels/mrf.py``,
``kernels/wn_stack.py``); ``LAUNCHES`` counts every kernel's launches.
"""

from smart_vocoder_torch.kernels._build import LAUNCHES, reset_launch_counts
from smart_vocoder_torch.kernels.mrf import (
    mrf_stage,
    mrf_stage_plain,
    mrf_stage_unpacked,
    up_mrf_stage,
    up_mrf_stage_plain,
)
from smart_vocoder_torch.kernels.wn_stack import wn_stack, wn_stack_plain

__all__ = [
    "LAUNCHES",
    "mrf_stage",
    "mrf_stage_plain",
    "mrf_stage_unpacked",
    "reset_launch_counts",
    "up_mrf_stage",
    "up_mrf_stage_plain",
    "wn_stack",
    "wn_stack_plain",
]
