"""Serving programs: one CUDA graph per serving shape, captured once and replayed.

Counterpart of the JAX package's jitted serving executables:
``Vocoder._infer = jax.jit(apply_fn, static_argnames=("noise_scale",))``
(``smart_vocoder_tpu/inference.py:111``), one executable per (shape, noise
scale, speaker or none), and the server's ``jax.jit(batched_windows)``
(``smart_vocoder_tpu/serving.py:137``), one per ``(max_streams, chunk)``. Each
request is one program, built once per shape and dispatched as a unit. Here a
program is a CUDA graph of the eager launches of one function on static input
buffers: the same kernels (the hand-written stages, the WN stack, cuDNN's
convolutions) in the same order on the same shapes, dispatched from the host
with one call in place of some 700.

A program on a CUDA device is captured when it is made. The function runs
once eagerly on a side stream (the kernel library's load, cuDNN's plan choice
-- its timed search too, where it is on -- and the allocator's growth happen
there), then once under capture into the memory pool its caller gives it.
Every program of one ``Vocoder`` shares one pool and one lock: the static
inputs and outputs stay alive and no two replays run at once, so the
programs may replay in any order. A capture or a replay that fails raises,
with the program's key added to the exception's notes; nothing falls back to
the eager launches.

On the CPU, which runs only where the caller asks for it (the tests), the
"capture" is one call of the function, and each run calls it again on the
same static buffers.

The kernel wrappers count the launches of the capture into the program's
tally (``kernels._build.recording_launches``) instead of ``LAUNCHES``; each
replay adds the tally to ``LAUNCHES``, since a replay runs each captured
kernel once.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Hashable, Mapping

import numpy as np
import torch

from smart_vocoder_torch.kernels._build import count_tally, recording_launches


@contextlib.contextmanager
def _keyed(key: Hashable, what: str):
    """Name the program in whatever its capture or run raises, and re-raise it."""
    try:
        yield
    except Exception as e:
        e.add_note(f"serving program {key}: {what} failed")
        raise


class ServingProgram:
    """One serving function at one shape: ``fn(**static) -> tensor``.

    ``inputs`` gives each static input's first value, a tensor on the device
    the program runs on (cloned here); ``pool`` is the CUDA graph memory pool
    (``torch.cuda.graph_pool_handle()``) shared by the caller's programs, and
    ``lock`` the lock they share. ``capture_ms`` is the host time the eager
    call and the capture took; ``tally`` the kernel launches one run makes,
    by wrapper name."""

    def __init__(self, key: Hashable, fn: Callable[..., torch.Tensor],
                 inputs: Mapping[str, torch.Tensor], pool=None,
                 lock: threading.RLock | None = None):
        self.key = key
        self.fn = fn
        self.device = next(iter(inputs.values())).device
        self._lock = lock or threading.RLock()
        with self._lock, torch.inference_mode(), self._on_device(), _keyed(key, "capture"):
            self.static = {name: value.clone() for name, value in inputs.items()}
            t0 = time.perf_counter()
            self.graph, self.out, self.tally = self._capture(pool)
            self.capture_ms = (time.perf_counter() - t0) * 1e3

    def _on_device(self):
        return (torch.cuda.device(self.device) if self.device.type == "cuda"
                else contextlib.nullcontext())

    def _capture(self, pool):
        if self.device.type != "cuda":
            with recording_launches() as tally:
                out = self.fn(**self.static)
            return None, out, tally
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(**self.static)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's work on the card (a multi-card
        # Vocoder's shards) does not break this capture
        with recording_launches() as tally, torch.cuda.graph(
                graph, pool=pool, stream=side, capture_error_mode="thread_local"):
            out = self.fn(**self.static)
        return graph, out, tally

    def run(self, **inputs) -> torch.Tensor:
        """Copy ``inputs`` (every static input, each an array of its shape)
        into the static buffers, replay the graph (on the CPU: call the
        function) and return a copy of the output on the host, which no later
        run overwrites."""
        return self._call(inputs, replay=self.graph is not None)

    def eager(self, **inputs) -> torch.Tensor:
        """:meth:`run` with the function's eager launches in place of the
        replay, on the same static buffers: the other leg of an A/B of the
        graph. Serving never calls it."""
        return self._call(inputs, replay=False)

    def _call(self, inputs, replay: bool) -> torch.Tensor:
        if inputs.keys() != self.static.keys():
            raise ValueError(f"serving program {self.key}: inputs {sorted(inputs)}, "
                             f"expected {sorted(self.static)}")
        with self._lock, torch.inference_mode(), self._on_device(), \
                _keyed(self.key, "replay" if replay else "call"):
            for name, value in inputs.items():
                buf = self.static[name]
                value = torch.as_tensor(np.asarray(value))
                if value.shape != buf.shape:
                    raise ValueError(f"serving program {self.key}: input {name} of shape "
                                     f"{tuple(value.shape)}, expected {tuple(buf.shape)}")
                buf.copy_(value)
            if not replay:
                return self.fn(**self.static).cpu()
            self.graph.replay()
            count_tally(self.tally)
            return self.out.cpu()
