"""Step timing and tracing of the port; counterpart of
``smart_vocoder_tpu/utils/profiling.py``.

- ``StepTimer``: wall-clock steps/s, audio samples/s and ms a step since the
  warm-up, logged as ``perf/*`` scalars.
- ``StepProfiler``: a ``torch.profiler`` trace of steps ``[start, start + n)``
  (host and, on the card, its kernels), written as a Chrome trace into
  ``<model_dir>/profile``; on from the config's ``tpu.profile_steps`` (0 =
  off) and ``tpu.profile_start_step``.
- ``span(name, **attrs)``: a span at one of the program's layer boundaries
  (``synth.*`` in ``inference.Vocoder.mel_to_wav``, ``serve.step`` in
  ``serving.StreamServer.step``, ``train.*`` in ``training/step.py``'s step,
  ``loader.wait`` in ``data/pipeline.py:BucketedLoader``). Spans are recorded
  only while a ``torch.profiler`` profile runs in the process (PyTorch's own
  flag, ``torch.autograd.profiler._is_profiler_enabled``, read at each call):
  otherwise ``span`` returns one shared null context that reads no clock. A
  recorded span holds its name, its start and end on ``time.perf_counter``,
  the span open on the same thread when it began (its ``parent`` id), the
  thread and ``attrs``; the last ``SPAN_BUFFER`` are kept in memory and
  ``recorded()`` returns them. A span calls no torch function: no
  ``record_function`` annotation, which a device profile could show as a
  device event.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_BUFFER = 1 << 16  # spans kept; the oldest go first


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


class Span:
    """One recorded span; ``parent`` is the ``id`` of the span open on the
    same thread when it began, or None."""

    __slots__ = ("name", "attrs", "id", "parent", "thread", "start", "end")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "Span":
        stack = _open_spans()
        self.id = next(_span_ids)
        self.parent = stack[-1].id if stack else None
        self.thread = threading.get_ident()
        stack.append(self)
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter()
        _open_spans().pop()
        _spans.append(self)
        return False


class _NullSpan:
    """What ``span`` returns while no profiler runs: enters and exits, and
    does nothing else."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()
_spans: deque = deque(maxlen=SPAN_BUFFER)
_span_ids = itertools.count()
_local = threading.local()


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A span of ``name`` around a ``with`` block while a profiler runs,
    else ``NULL_SPAN``."""
    if not _autograd_profiler._is_profiler_enabled:
        return NULL_SPAN
    return Span(name, attrs)


def recorded() -> list:
    """The spans kept, in the order they ended."""
    return list(_spans)
