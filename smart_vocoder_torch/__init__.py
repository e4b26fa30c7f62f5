"""SMART-Vocoder on PyTorch and CUDA (NVIDIA Hopper).

The port of ``smart_vocoder_tpu``'s serving path: the same configs, parameter
names and public shapes, with the decoder's two late MRF stages as
hand-written CUDA kernels (``kernels/csrc``), and of its other TPU kernels
(the WN stack, the unpacked MRF stage, the MRF stage with a hand-written
backward, the fused gate, the packed-MRF variants), each with the entry point
that runs it (``kernels/__init__.py``, ``tools/``). It imports no JAX; the
JAX package is the reference its tests hold it against.
"""

from smart_vocoder_torch.config import HParams, load_config
from smart_vocoder_torch.inference import Vocoder

__all__ = ["HParams", "Vocoder", "load_config"]
