"""Hand-written kernels for Hopper and the fast paths that route to them.

- :func:`mrf_stage` -- one fused MRF stage (decoder stage 3); replaces the
  JAX package's ``fused_mrf_stage_packed``, and with ``mask_edges`` /
  ``out_dtype`` the packed-MRF A/B variants of ``scripts/exp_mrf_variants.py``.
- :func:`mrf_stage_unpacked` -- the MRF stage in ``x.dtype`` at 32-256
  channels (stages 2 and 1 under ``pallas_stage2``); replaces
  ``fused_mrf_stage``. With ``f32_storage`` (128 and 256 channels) it runs
  hifi >= 2's stages 1-2, the function of ``mrf_stage_reference(mixed_f32=True)``.
- :func:`up_mrf_stage` -- upsample + MRF [+ decoder tail] (stage 4, or stage
  3 under ``pallas_stage2``); replaces ``fused_up_mrf_stage``.
- :func:`wn_stack` -- the fused WN layers of the prior and the flow
  (``use_wn_kernels``); replaces ``fused_wn_stack``.
- :func:`fused_gate` -- the add-tanh-sigmoid gate, in Triton; replaces
  ``fused_gate``.
- :func:`mrf_branch_bwd` and :func:`mrf_stage_train` -- the hand-written
  backward of one MRF branch and the stage as a ``torch.autograd.Function``
  over it; replace ``mrf_branch_bwd`` and the ``mrf_stage_train`` custom VJP.

Each has its plain PyTorch version beside it (``kernels/mrf.py``,
``kernels/wn_stack.py``, ``kernels/gate.py``, ``kernels/mrf_train.py``);
``LAUNCHES`` counts every kernel's launches.
"""

from smart_vocoder_torch.kernels._build import LAUNCHES, reset_launch_counts
from smart_vocoder_torch.kernels.gate import fused_gate, fused_gate_plain
from smart_vocoder_torch.kernels.mrf import (
    mrf_stage,
    mrf_stage_plain,
    mrf_stage_unpacked,
    up_mrf_stage,
    up_mrf_stage_plain,
)
from smart_vocoder_torch.kernels.mrf_train import (
    MrfStageTrain,
    branch_bwd_halo,
    mrf_branch_bwd,
    mrf_branch_bwd_plain,
    mrf_stage_train,
)
from smart_vocoder_torch.kernels.wn_stack import wn_stack, wn_stack_plain

__all__ = [
    "LAUNCHES",
    "MrfStageTrain",
    "branch_bwd_halo",
    "fused_gate",
    "fused_gate_plain",
    "mrf_branch_bwd",
    "mrf_branch_bwd_plain",
    "mrf_stage",
    "mrf_stage_plain",
    "mrf_stage_train",
    "mrf_stage_unpacked",
    "reset_launch_counts",
    "up_mrf_stage",
    "up_mrf_stage_plain",
    "wn_stack",
    "wn_stack_plain",
]
