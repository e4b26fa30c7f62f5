"""Step timing and tracing of the training loop; counterpart of
``smart_vocoder_tpu/utils/profiling.py``.

- ``StepTimer``: wall-clock steps/s, audio samples/s and ms a step since the
  warm-up, logged as ``perf/*`` scalars.
- ``StepProfiler``: a ``torch.profiler`` trace of steps ``[start, start + n)``
  (host and, on the card, its kernels), written as a Chrome trace into
  ``<model_dir>/profile``; on from the config's ``tpu.profile_steps`` (0 =
  off) and ``tpu.profile_start_step``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch


class StepTimer:
    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._seen = 0
        self._t0: Optional[float] = None
        self._steps = 0

    def tick(self) -> None:
        self._seen += 1
        if self._seen == self.warmup:  # the first steps build and autotune
            self._t0 = time.perf_counter()
            self._steps = 0
        elif self._seen > self.warmup:
            self._steps += 1

    def metrics(self, samples_per_step: int) -> Dict[str, float]:
        if not self._t0 or self._steps == 0:
            return {}
        dt = (time.perf_counter() - self._t0) / self._steps
        return {
            "perf/steps_per_sec": 1.0 / dt,
            "perf/samples_per_sec": samples_per_step / dt,
            "perf/step_ms": dt * 1e3,
        }


class StepProfiler:
    """Trace steps [start, start + n) into ``log_dir/trace_<start>_<end>.json``."""

    def __init__(self, log_dir: str, start_step: int, num_steps: int, device: torch.device):
        self.log_dir = log_dir
        self.start = start_step
        self.last = start_step + num_steps - 1
        self.enabled = num_steps > 0
        self.device = device
        self._prof = None

    def maybe_start(self, step: int) -> None:
        if self.enabled and self._prof is None and step == self.start:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            self._prof = profile(activities=activities)
            self._prof.start()

    def maybe_stop(self, step: int) -> None:
        if self._prof is not None and step >= self.last:
            self.close()
            self.enabled = False

    def close(self) -> None:
        """Stop a trace in progress (the steps it holds have ended on the
        card) and write it."""
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.stop()
        os.makedirs(self.log_dir, exist_ok=True)
        self._prof.export_chrome_trace(
            os.path.join(self.log_dir, f"trace_{self.start}_{self.last + 1}.json"))
        self._prof = None
